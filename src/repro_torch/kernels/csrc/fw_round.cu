// Fused Floyd-Warshall pivot round for Hopper (sm_90a): three launches.
//
// Replaces the TPU kernels src/repro/kernels/fw_round.py:fw_round
// (_round_kernel), fw_round.py:fw_round_bordered (the same _round_kernel on
// a rectangular tile grid with _bordered_order) and
// fw_round.py:fw_round_with_successors (_round_succ_kernel); also stands
// for their Pallas-Triton lowerings in src/repro/kernels/fw_round_gpu.py.
//
// The TPU kernel runs a whole round as one sequential grid and carries the
// closed pivot bands from step to step in VMEM scratch.  A CUDA grid runs
// its blocks in no order, so each round here is three launches on one
// stream, and the closed bands live in two device buffers, rowband
// (B,s,cols) and colband (B,rows,s) (four with successors), that the
// wrapper allocates once per solve:
//
//   1. diag  — one CTA per graph closes the (s,s) pivot tile (_close_diag)
//              and writes it into both band buffers at block b.
//   2. bands — (tc-1)+(tr-1) band tiles per graph, each cut into 1, 2 or 4
//              CTAs, close the row tiles (_close_row_panel) and col tiles
//              (_close_col_panel) of round b against it.
//   3. relax — one CTA per 128 x 128 output tile per graph relaxes every
//              element against the closed bands, k ascending (_relax_tile):
//              the semiring matmul colband ⊗ rowband folded onto a spliced
//              C.  Rows in row band b start from the row band, then
//              columns in col band b from the col band, else from w (the
//              splice of fw_round.py:266-269).  Every tile is re-relaxed,
//              pivot bands included, k ascending, so plus_mul matches the
//              reference.  Phase 3 writes w in place: it reads bands only
//              from the band buffers.  The batch rides gridDim.z.
//
// The square round runs the three kernels on (n,n) with rows = cols = n,
// pivot b and no owner echo.  The bordered round of the distributed solve
// runs them on a rank's (s+n_r, s+n_c) bordered block with the pivot
// pinned at b = 0 and two owner-echo tile coordinates (pr, pc), -1 where
// the rank holds no copy of the global pivot band (fw_round.py:247, 255,
// 266-269): the diag launch also writes the closed corner over row-band
// block pc and col-band block pr, whose band tiles the bands launch then
// leaves alone, and the relax launch starts rows in block pr from the row
// band and columns in block pc from the col band, as it does block b.
//
// Exactness.  Each element sees the reference's ⊕/⊗ chain in the
// reference's order, built from the steps of semiring.cuh by the chains of
// fw_phases.cuh.  The diag updates in place, so step k's row and column
// are published into double-buffered shared vectors before a barrier and
// read after it: one barrier a step.  A band tile's columns (rows) are
// independent chains, so the bands read p[k][c] (q[r][k]) from the lane
// that holds it by a shuffle, before that lane updates it, and need no
// barrier.  plus_mul's step is one single-rounded __fmaf_rn, as XLA
// contracts it in the reference.  min and max propagate NaN (min.NaN / max.NaN), as
// torch.minimum and jnp.minimum do; fminf/fmaxf would drop it.  The
// successor round takes a candidate only where cand < t, strictly.
//
// Bound on this card.  A relaxation is ~2 fp32 operations (add and min, or
// one FMA): n^3 relaxations per solve against the 67 TFLOP/s non-tensor
// pipe, versus 2*n^2 words of traffic per round at 3.35 TB/s.  At s = 128
// the relax launch does s relaxations per word it moves, so it is bound by
// operations.  Its design is semiring_matmul's mainloop (minplus_matmul.cuh,
// whose note says why): each thread keeps an 8 x 8 tile as 2 x 2 blocks of
// 4 x 4 and reads 4-wide from k-major A and row-major B slices, 16 deep (8
// in the 2-byte storages), double-buffered by cp.async and a register
// prefetch, one barrier a slice, two CTAs an SM.  The relax differs from
// the matmul only in where each element starts, so the 128 x 128 tile does
// not depend on s and one instantiation a semiring and storage serves every
// s.  The successor relax keeps, in place of a next-hop tile, the k of the
// last strict improvement as a byte an element, and gathers the next hop
// once after the fold (fw_round.cuh).  The diag and bands launches are
// serial chains of s dependent steps on one tile, so a tile runs on one
// SM: their floor is s·s² relaxations at one SM's rate, 64 a clock for
// f32 min-plus (FADD and FMNMX issued on 4 schedulers), 32,768 clocks at
// s = 128.  Their designs keep every cycle an issue slot of a relaxation:
// the diag holds an 8 x 8 register block a thread (256 threads), so a step
// is 4 shared 16-byte loads and one barrier for 64 relaxations a thread;
// the bands hold 16 rows x 4 columns a lane and take their operands by 4
// shuffles and 4 shared 16-byte loads a step, with no barrier, and a
// launch of fewer tiles than SMs cuts each tile into 2 or 4 CTAs.  Both
// keep their values lifted (semiring.cuh:Lifted): an int16 min-plus or
// max-plus relaxation is then three instructions and a bf16 / f16 one
// two, as f32's, in place of the step's sentinel tests or round.  The
// successor round's diag and bands run the same layouts with an int32 next
// hop beside each distance (fw_phases.cuh:close_tile_blocks_succ,
// close_band_lanes_succ): a step is add, compare and two selects (bf16 /
// f16: two more to round the candidate, which the strict compare needs
// rounded, so nothing is lifted), one SM's floor 33.1 µs at s = 128 (49.6
// in bf16 / f16).  The diag publishes column k's hops beside its
// distances; the col lanes shuffle 4 hops beside 4 values a step; the row
// lanes, whose a-side hop (the closed diagonal's) does not change, keep
// the k of the last improvement and gather the hop once at the end.  Tensor
// cores (wgmma) do not apply to a tropical ⊕.  A bordered round does
// rows*cols*s relaxations on its (rows, cols) block and is bound the same
// way.
//
// The kernels themselves live in fw_round.cuh, templated on the storage
// type; this file instantiates them for f32 (fw_round_lowered.cu for the
// storage lowerings).
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_round.cuh"

namespace {

int dispatch_round(int phase, void* w, void* rowband, void* colband, int B, int rows,
                   int cols, int s, int b, int pr, int pc, int semiring, void* stream) {
  float* pw = static_cast<float*>(w);
  float* rb = static_cast<float*>(rowband);
  float* cb = static_cast<float*>(colband);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch_s<MinPlus>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, st);
    case 1: return dispatch_s<MaxPlus>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, st);
    case 2:
    case 3: return dispatch_s<MaxMin>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, st);
    case 4: return dispatch_s<PlusMul>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// phase: 0 = diag, 1 = bands, 2 = relax.  semiring: 0 min_plus,
// 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.  s in {16, 32, 64, 128}.
// w (B,n,n), rowband (B,s,n), colband (B,n,s), contiguous f32, 16-byte
// aligned.
extern "C" int fw_round_launch(int phase, void* w, void* rowband, void* colband,
                               int B, int n, int s, int b, int semiring, void* stream) {
  return dispatch_round(phase, w, rowband, colband, B, n, n, s, b, -1, -1, semiring, stream);
}

// The bordered round: w (B,rows,cols) with the pivot at tile (0,0), rowband
// (B,s,cols), colband (B,rows,s); pr / pc the owner-echo tile coordinates
// (-1 = none), shared by the batch.  A single tile has no bands: the
// wrapper does not launch phase 1 when rows == cols == s.
extern "C" int fw_round_bordered_launch(int phase, void* w, void* rowband, void* colband,
                                        int B, int rows, int cols, int s, int pr, int pc,
                                        int semiring, void* stream) {
  return dispatch_round(phase, w, rowband, colband, B, rows, cols, s, 0, pr, pc, semiring,
                        stream);
}

// The successor round: w f32 and succ int32 (B,n,n); distance bands rw
// (B,s,n) / cw (B,n,s) and successor bands rs / cs of the same shapes.
extern "C" int fw_round_succ_launch(int phase, void* w, void* succ, void* rw,
                                    void* cw, void* rs, void* cs, int B, int n,
                                    int s, int b, void* stream) {
  return dispatch_succ<StrictMinPlus, float>(phase, w, succ, rw, cw, rs, cs, B, n, s, b,
                                             static_cast<cudaStream_t>(stream));
}
