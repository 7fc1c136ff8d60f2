// Restricted row sweep of the decremental repair on the storage lowerings,
// for Hopper (sm_90a).
//
// Replaces the same TPU kernel as fw_repair_del.cu —
// src/repro/kernels/fw_repair_del.py:_sweep_round, driven by
// fw_repair_del_sweep — for the storages the reference engine sweeps
// (src/repro/apsp/engine.py:708-841), and gives its XLA-only successor
// sweep (fw_repair_del_sweep_with_successors_ref) its bf16 / f16 twin:
//
//   * bf16 / f16 with the four idempotent float semirings,
//   * the saturating int16 lowerings min_plus_i16, max_plus_i16,
//     max_min_i16 and or_and_i16,
//   * the bit-packed or_and_packed word plane (⊗ = AND, ⊕ = OR on 32
//     lanes),
//   * the int32 carrier of the integer or_and storages,
//   * the successor sweep on bf16 / f16 distances with int32 next hops.
//
// plus_mul has no sweep in any storage (non-idempotent ⊕: the engine
// re-solves).  The launches are fw_repair_del.cu's three (diag, panels,
// relax; fw_repair_del.cuh), instantiated on the storage type: d_init, the
// strip, the band and acol are held in the storage type, registers in 32
// bits with the rounding or saturation of semiring.cuh after every op, in
// the reference's order, so each element's chain is the XLA twin's, bit
// for bit.  The diag and panels keep their operands lifted
// (semiring.cuh:Lifted: int16 sentinels past the int16 range, 16-bit
// min-plus / max-plus rounded where an operand is taken), which gives the
// same values with fewer instructions a relaxation.  The successor sweep's
// diag and panels cannot: a strict compare of an unrounded sum can take a
// candidate that rounds to the current distance, which the reference
// keeps, so they run the successor round's bodies (close_tile_blocks_succ,
// close_band_lanes_succ), each candidate rounded to bf16 / f16 before its
// compare.
//
// Bound on this card.  As in fw_repair_del.cu a round does n·s·(s + a)
// relaxations and moves ~(s + 2a)·n words: bound by operations, at 3 a
// relaxation in bf16 / f16, 6 in int16, 1 for 32 graphs packed, 2 in int32.
// At small a the band closure's serial chains set the time.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair_del.cuh"

namespace {

struct Call {
  int phase, n, a, s, b, h;
  cudaStream_t st;
};

template <class Op, class T>
int run(const Call& c, const void* d_init, const void* pos, const void* rows, void* strip,
        void* band, void* acol) {
  const auto x = bufs<T>(d_init, nullptr, pos, rows, strip, nullptr, band, nullptr, acol,
                         nullptr);
  return dispatch_sweep<false, Op>(c.phase, x, c.n, c.a, c.s, c.b, c.h, c.st);
}

}  // namespace

// phase: 0 = diag, 1 = panels, 2 = relax of round b.  storage: 0 bf16,
// 1 f16, 2 int16, 3 packed int32 words, 4 int32 integers.  semiring:
// 0 min_plus, 1 max_plus, 2 max_min, 3 or_and (bf16 / f16); int16 takes 0-3
// (the *_i16 lowerings), packed and int32 3 only.  d_init (n,n), strip
// (a,n), band (s,n), acol (a,s) in the storage type; pos (n,) and rows (a,)
// int32 as in fw_repair_del.cu; contiguous on the device.  s in {16, 32,
// 64, 128}; a a multiple of 8; h the relax's tile height, as in
// fw_repair_del.cu.
extern "C" int fw_repair_del_lowered_launch(int phase, int storage, int semiring,
                                            const void* d_init, const void* pos,
                                            const void* rows, void* strip, void* band,
                                            void* acol, int n, int a, int s, int b, int h,
                                            void* stream) {
  if (bad_shape(phase, n, a, s, b)) return (int)cudaErrorInvalidValue;
  const Call c{phase, n, a, s, b, h, static_cast<cudaStream_t>(stream)};
#define SWEEP(OP, T) run<OP, T>(c, d_init, pos, rows, strip, band, acol)
  if (storage == 0 || storage == 1) {
    const bool bf = storage == 0;
    switch (semiring) {
      case 0: return bf ? SWEEP(MinPlusH<RoundBf16>, __nv_bfloat16) : SWEEP(MinPlusH<RoundF16>, __half);
      case 1: return bf ? SWEEP(MaxPlusH<RoundBf16>, __nv_bfloat16) : SWEEP(MaxPlusH<RoundF16>, __half);
      case 2:
      case 3: return bf ? SWEEP(MaxMin, __nv_bfloat16) : SWEEP(MaxMin, __half);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (storage == 2) {
    switch (semiring) {
      case 0: return SWEEP(MinPlusI16, short);
      case 1: return SWEEP(MaxPlusI16, short);
      case 2:
      case 3: return SWEEP(MaxMinI16, short);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (storage == 3 && semiring == 3) return SWEEP(OrAndPacked, int);
  if (storage == 4 && semiring == 3) return SWEEP(MaxMinI16, int);
#undef SWEEP
  return (int)cudaErrorInvalidValue;
}

// The successor sweep (min-plus) on bf16 (storage 0) or f16 (storage 1)
// distances: s_init, strip_s, band_s, acol_s are the int32 next-hop twins
// of d_init, strip, band, acol.
extern "C" int fw_repair_del_lowered_succ_launch(int phase, int storage, const void* d_init,
                                                 const void* s_init, const void* pos,
                                                 const void* rows, void* strip, void* strip_s,
                                                 void* band, void* band_s, void* acol,
                                                 void* acol_s, int n, int a, int s, int b,
                                                 int h, void* stream) {
  if (bad_shape(phase, n, a, s, b)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 0) {
    const auto x = bufs<__nv_bfloat16>(d_init, s_init, pos, rows, strip, strip_s, band, band_s,
                                       acol, acol_s);
    return dispatch_sweep<true, MinPlusH<RoundBf16>>(phase, x, n, a, s, b, h, st);
  }
  if (storage == 1) {
    const auto x = bufs<__half>(d_init, s_init, pos, rows, strip, strip_s, band, band_s, acol,
                                acol_s);
    return dispatch_sweep<true, MinPlusH<RoundF16>>(phase, x, n, a, s, b, h, st);
  }
  return (int)cudaErrorInvalidValue;
}
