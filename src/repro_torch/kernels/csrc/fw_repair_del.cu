// Restricted row sweep of the decremental repair for Hopper (sm_90a):
// three launches per pivot round.
//
// Replaces the TPU kernel src/repro/kernels/fw_repair_del.py:_sweep_round
// (_sweep_round_kernel, driven once per round by fw_repair_del_sweep), and
// gives the reference's XLA-only successor sweep
// (fw_repair_del_sweep_with_successors_ref) its kernel twin.
//
// After marking, only the a affected rows of the reset matrix d_init can
// change.  The sweep is blocked FW restricted to them: the a rows live in
// a compact (a, n) strip, and round b
//
//   1. diag   — one CTA closes the (s, s) pivot tile of the overlaid band
//               (_close_diag) into band block b.  The overlay is read, not
//               built: band row r is the strip row that holds matrix row
//               o + r where there is one (pos[o + r] >= 0), else row o + r
//               of d_init.
//   2. panels — the band's other T-1 tiles are closed against the diag
//               (_close_row_panel) into band, and the strip's block column
//               b (_close_col_panel) into acol (a, s): every column of a
//               band tile and every row of the strip is a chain of its own,
//               16 of them a warp; a tile is cut into 1-4 CTAs, the strip
//               into CTAs of s / split rows, so that the launch fills the
//               card.
//   3. relax  — the whole (a, n) strip relaxes against acol ⊗ band, k
//               ascending (_relax_tile).  Block column b starts from acol,
//               the rest from the strip; strip rows inside block b then take
//               their band rows.  Long strips (a >= 128) run on the
//               matmul's mainloop (128 x 128 tiles, minplus_matmul.cuh),
//               short ones on a tile H = 8 .. 64 rows high whose grid
//               spreads the band's columns over the card.
//
// The TPU kernel runs a round as one sequential grid and keeps the band and
// acol in VMEM scratch; here they are device buffers the wrapper allocates
// once per sweep, and the three launches run in order on one stream.
// The wrapper pads the strip to a multiple of 8 rows with inert rows; the
// panels' strip CTAs hold 16 rows a warp, the relax's tiles 128 or H, the
// rows past a masked in both.
//
// Exactness.  Each element sees the chain of the reference's XLA twin
// fw_repair_del_sweep_ref, in its order, through the chains of
// fw_phases.cuh that fw_round.cu runs too (the diag's register blocks, the
// panels' band lanes, on the operands of semiring.cuh:Lifted): only the
// loads (the overlay, the strip) and the stores (band, acol, the splice)
// are this file's.
// The twin re-relaxes the strip's block column b after splicing acol in
// (the Pallas kernel skips that tile); so does the relax launch.  Padding
// strip rows (index n) hold a copy of row n-1, are relaxed like the others
// and never read back: pos never names them and the wrapper drops them.
// The sweep is sound for the ⊕-idempotent semirings only; plus_mul has no
// entry here (the engine re-solves).  The successor sweep (min-plus) takes
// a candidate only where it is strictly smaller, in every phase, and
// carries an int32 next hop beside every value.  Its diag and panels run
// the same grid and loads on the successor round's bodies
// (close_tile_blocks_succ, close_band_lanes_succ), which round each
// candidate before its compare and lift nothing: the col lanes shuffle
// each strip row's hop with its value, and the row lanes keep the k of
// each element's last improvement and gather the closed diagonal's hop
// once after the chain, so that the panels stage no hop tile.
//
// Bound on this card.  Round b does s·n·s relaxations on the band and
// a·n·s on the strip (2 fp32 operations each, 67 TFLOP/s) and moves ~
// (s + 2a)·n words, so the sweep is bound by operations: n²(s + a) · 2 /
// 67e12 s, 0.27 ms at n = 8192, s = 128, a = 8.  At small a the band
// closure dominates, and its diag and panels launches are serial chains of
// s steps: one SM's issue rate, not the card's, bounds them (s · s²
// relaxations at 64 a clock an SM, 16.5 µs in f32 at s = 128; half that
// for a band tile cut in two).  So the diag keeps an 8 x 8 block a thread
// (four 16-byte shared loads and one barrier for 64 relaxations a step),
// and the panels need no barrier at all (operands by shuffle and 16-byte
// loads of the staged diagonal).  A successor step is an add, a compare
// and two selects, twice a plain one: 33.1 µs for the diag's chain at
// s = 128.  The relax alone does a·n·s relaxations, 0.0962 ms of f32
// operations at a = n = 4096, s = 128 (3 a relaxation in the successor
// sweep), and moves 2a·n + s·n words: at a = 8 its bound is the band's
// bytes, 1.4 µs at n = 8192.  The old strip tile (8 rows, one relaxation
// a shared load, the band tile re-read by every 8 rows) took 0.94 ms at
// a = 4096 in bf16 with next hops; the mainloop's 8 x 8 register tiles
// read 16 bytes a shared load for 16 relaxations.  At a = 8 a 128-row tile
// would fold 16 times the rows, so the short tile folds H rows and cuts
// the columns until the grid covers the card.
//
// The kernels are fw_repair_del.cuh's, templated on the storage type; this
// file instantiates them for f32, fw_repair_del_lowered.cu for the storage
// lowerings.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair_del.cuh"

// phase: 0 = diag, 1 = panels, 2 = relax of round b.  semiring: 0 min_plus,
// 1 max_plus, 2 max_min, 3 or_and.  d_init (n,n); pos (n,) int32, the
// strip row holding each matrix row or -1; rows (a,) int32, the matrix row
// of each strip row (n for padding); strip (a,n), band (s,n), acol (a,s);
// f32 unless named, contiguous on the device.  s in {16, 32, 64, 128};
// a a multiple of 8; h the relax's tile height: 8, 16, 32, 64 (the short
// tile) or 128 (the mainloop's), any of them for any a (the others ignore
// it).
extern "C" int fw_repair_del_launch(int phase, const void* d_init, const void* pos,
                                    const void* rows, void* strip, void* band,
                                    void* acol, int n, int a, int s, int b, int h,
                                    int semiring, void* stream) {
  if (bad_shape(phase, n, a, s, b)) return (int)cudaErrorInvalidValue;
  const auto x = bufs<float>(d_init, nullptr, pos, rows, strip, nullptr, band, nullptr, acol,
                             nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch_sweep<false, MinPlus>(phase, x, n, a, s, b, h, st);
    case 1: return dispatch_sweep<false, MaxPlus>(phase, x, n, a, s, b, h, st);
    case 2:
    case 3: return dispatch_sweep<false, MaxMin>(phase, x, n, a, s, b, h, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The successor sweep (min-plus): s_init, strip_s, band_s, acol_s are the
// int32 next-hop twins of d_init, strip, band, acol.
extern "C" int fw_repair_del_succ_launch(int phase, const void* d_init,
                                         const void* s_init, const void* pos,
                                         const void* rows, void* strip, void* strip_s,
                                         void* band, void* band_s, void* acol,
                                         void* acol_s, int n, int a, int s, int b, int h,
                                         void* stream) {
  if (bad_shape(phase, n, a, s, b)) return (int)cudaErrorInvalidValue;
  const auto x = bufs<float>(d_init, s_init, pos, rows, strip, strip_s, band, band_s, acol,
                             acol_s);
  return dispatch_sweep<true, StrictMinPlus>(phase, x, n, a, s, b, h,
                                             static_cast<cudaStream_t>(stream));
}
