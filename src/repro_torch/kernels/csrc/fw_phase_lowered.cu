// Phases 1 and 2 of the 4-dispatch round on the storage lowerings, for
// Hopper (sm_90a).
//
// Replaces the same TPU kernels as fw_phase.cu —
// src/repro/kernels/fw_phase1.py:fw_phase1 and
// src/repro/kernels/fw_phase2.py:fw_phase2_row / fw_phase2_col — for the
// storage lowerings those Pallas calls compile for in the reference: bf16 /
// f16 with the five float semirings, the saturating int16 lowerings
// (min_plus_i16, max_plus_i16, max_min_i16, or_and_i16), the bit-packed
// or_and_packed (32 graphs per int32 word) and the int32 carrier of the
// integer or_and / plus_mul storages.
//
// The kernels are fw_phase.cuh's, instantiated on the storage type: the
// tile, the published row / column k and the staged closed diagonal hold
// 32-bit registers' values (Reg<T>), lifted as semiring.cuh:Lifted says
// (int16 min-plus / max-plus sentinels mapped past the int16 range, 16-bit
// min-plus / max-plus accumulators unrounded in f32, each operand rounded
// where it is published, staged or shuffled); every other step rounds
// (bf16 / f16: each ⊗ and ⊕, f16 plus_mul's FMA once) or saturates through
// semiring.cuh, k ascending, so each element's chain is the reference's,
// bit for bit.
//
// Bound on this card.  As in f32: s steps on one SM a tile; a lifted int16
// relaxation takes three ALU ops, a bf16 / f16 plus_mul step its rounds,
// and the operands half the global bytes (2-byte storages).
//
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phase.cuh"

#define ARGS kind, diag, ld_d, bs_d, band, ld_b, bs_b, out, ld_o, bs_o, B, n, s, st

namespace {

template <class T, class R>
int dispatch_half(int semiring, int kind, const void* diag, long long ld_d, long long bs_d,
                  const void* band, long long ld_b, long long bs_b, void* out,
                  long long ld_o, long long bs_o, int B, int n, int s, cudaStream_t st) {
  switch (semiring) {
    case 0: return dispatch_phase<MinPlusH<R>, T>(ARGS);
    case 1: return dispatch_phase<MaxPlusH<R>, T>(ARGS);
    case 2:
    case 3: return dispatch_phase<MaxMin, T>(ARGS);
    case 4: return dispatch_phase<PlusMulH<R>, T>(ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As fw_phase_launch (fw_phase.cu), with strides in storage elements.
// storage: 0 bf16, 1 f16, 2 int16, 3 packed int32 words, 4 int32 integers.
// semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul (bf16 /
// f16); int16 takes 0-3 (the *_i16 lowerings), packed 3 only, int32 3
// and 4.
extern "C" int fw_phase_lowered_launch(int kind, int storage, int semiring, const void* diag,
                                       long long ld_d, long long bs_d, const void* band,
                                       long long ld_b, long long bs_b, void* out,
                                       long long ld_o, long long bs_o, int B, int n, int s,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 0) return dispatch_half<__nv_bfloat16, RoundBf16>(semiring, ARGS);
  if (storage == 1) return dispatch_half<__half, RoundF16>(semiring, ARGS);
  if (storage == 2) {
    switch (semiring) {
      case 0: return dispatch_phase<MinPlusI16, short>(ARGS);
      case 1: return dispatch_phase<MaxPlusI16, short>(ARGS);
      case 2:
      case 3: return dispatch_phase<MaxMinI16, short>(ARGS);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (storage == 3 && semiring == 3) return dispatch_phase<OrAndPacked, int>(ARGS);
  if (storage == 4 && semiring == 3) return dispatch_phase<MaxMinI16, int>(ARGS);
  if (storage == 4 && semiring == 4) return dispatch_phase<PlusMulI32, int>(ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef ARGS
