// Phases 1 and 2 of the 4-dispatch Floyd-Warshall round for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fw_phase1.py:fw_phase1
// (_phase1_kernel) and src/repro/kernels/fw_phase2.py:fw_phase2_row /
// fw_phase2_col (_row_kernel / _col_kernel).  Phase 3 of that round is
// minplus_matmul.cu.
//
//   closure  — one CTA per graph closes an (s,s) tile: s sequential steps
//              t ⊕= t[:,k] ⊗ t[k,:] (closure_kernel on close_tile_blocks).
//   row band — the (s,n) band's columns closed against the closed diagonal:
//              p ⊕= d[:,k] ⊗ p[k,:] (band_kernel<S, false> on
//              close_band_lanes).
//   col band — the (n,s) band's rows: p ⊕= p[:,k] ⊗ d[k,:]
//              (band_kernel<S, true>).
//
// Unlike fw_round.cu's bands launch, the band launches cover every tile of
// the band, the pivot's own included, as the TPU kernels grid over all n/bt
// tiles: the caller splices the closed diagonal over it afterwards (for
// plus_mul the recompute is not a no-op).  A band tile holds S columns (row
// band) or S rows (col band) whatever the reference's bt, which chooses no
// element's chain.  The band length n is any value >= 1: the last tile's
// chains past n load 0 and store nothing, and a warp with none of them
// leaves after staging the diagonal.  That is exact because a column of a
// row band (a row of a col band) evolves from its own values and the
// diagonal only.
//
// Exactness.  The chains are the fused round's (fw_round.cu), from
// fw_phases.cuh, built from the steps of semiring.cuh: k ascending; plus_mul
// one __fmaf_rn a step (f16: one __hfma); min.NaN / max.NaN; every operand
// lifted once (semiring.cuh:Lifted), which is exact.
//
// Bound on this card.  s³ relaxations per tile on O(s²) words: a closure of
// s = 128 moves 128 KiB and does 2·128³ operations, well under a
// microsecond either way.  What bounds these launches is the chain's
// latency on one SM: s steps of s² relaxations for the closure, s steps of
// s columns' (rows') s relaxations for a band tile.  The closure holds the
// tile in 8 x 8 register blocks on 256 threads (DiagShape<S>), so that a
// step is two 16-byte shared stores by its owners, one barrier, four
// 16-byte shared loads and 64 register relaxations a thread.  A band tile
// gives each warp 16 whole chains, which need no barrier: a step is a
// shuffle of the owner's value and one 16-byte shared load of the staged
// diagonal a lane.  A band of few tiles (n = 8192 at s = 128: 64) is cut
// into 2 or 4 CTAs a tile (fw_phases.cuh:band_split), each staging the
// diagonal for itself, so that the launch spreads over the card's SMs.
//
// Strides.  Every operand is a (B, rows, cols) view with unit column stride
// and its own row and batch strides, so that a caller passes slices of a
// larger matrix (w[..., o, o], w[..., o, :], w[..., :, o]) without a copy.
// The launch moves 4 elements at a time where every operand's base is
// aligned to that size and its strides are whole multiples of 4 elements,
// else one element at a time (fw_phase.cuh:aligned4); both fold the same
// chains.  The outputs must not overlap the inputs.
//
// The kernels live in fw_phase.cuh, templated on the storage type; this
// file instantiates them for f32 (fw_phase_lowered.cu for the storage
// lowerings).
//
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phase.cuh"

// kind: 0 = closure of diag (B,s,s) into out; 1 = row band (B,s,n) against
// the closed diag; 2 = col band (B,n,s).  band is unused by kind 0.
// semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.
// s in {16, 32, 64, 128}.  Each operand: base pointer, row stride and batch
// stride in elements, unit column stride.
extern "C" int fw_phase_launch(int kind, const void* diag, long long ld_d, long long bs_d,
                               const void* band, long long ld_b, long long bs_b,
                               void* out, long long ld_o, long long bs_o, int B, int n,
                               int s, int semiring, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS kind, diag, ld_d, bs_d, band, ld_b, bs_b, out, ld_o, bs_o, B, n, s, st
  switch (semiring) {
    case 0: return dispatch_phase<MinPlus, float>(ARGS);
    case 1: return dispatch_phase<MaxPlus, float>(ARGS);
    case 2:
    case 3: return dispatch_phase<MaxMin, float>(ARGS);
    case 4: return dispatch_phase<PlusMul, float>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}
