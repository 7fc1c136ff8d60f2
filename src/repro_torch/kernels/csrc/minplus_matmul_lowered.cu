// The blocked semiring matmul on the storage lowerings, for Hopper (sm_90a).
//
// Replaces the same TPU kernel as minplus_matmul.cu —
// src/repro/kernels/minplus_matmul.py:semiring_matmul — for the storage
// lowerings that Pallas call compiles for in the reference: bf16 / f16 with
// the five float semirings, the saturating int16 lowerings min_plus_i16,
// max_plus_i16, max_min_i16 and or_and_i16, the bit-packed or_and_packed
// (32 graphs per int32 word, ⊕ = OR, ⊗ = AND), and the int32 carrier of
// the integer or_and / plus_mul storages (or_and as integer max / min,
// plus_mul wrapping).  It is phase 3 of the lowered 4-dispatch round and
// the SUMMA step of the distributed "pallas" backend.
//
// The kernel is minplus_matmul.cuh's, instantiated on the storage type: the
// 8-deep A / B slices of the 2-byte storages, 16-deep of the int32 words
// (double-buffered, the next one's copies in flight
// while the current one folds, 16-byte vector copies where the operands
// allow: minplus_matmul.cu) sit in shared memory in the storage type, the
// 8 x 8 register tile in 32-bit registers, and every step rounds (bf16 / f16:
// each ⊗ and ⊕, f16 plus_mul's FMA once) or saturates (int16) through
// semiring.cuh after each op, k
// ascending, so each element's chain is the reference's bit for bit.  The
// ⊕-identity (the start without c) crosses the interface by its bits in
// the storage type: int16's sentinel and the flipped identity of a uint32
// or_and carrier are no floats.  The ragged edges follow minplus_matmul.cu:
// rows and columns past the end load 0 and store nothing, a short last
// k-slice folds to its own depth.  A 4-wide shared read is 8 bytes here.
//
// Bound on this card.  m·n·k relaxations at the ops of one lowered step
// (bf16 / f16 min-plus 3: add, round, min; plus_mul 4; int16 6; packed 1
// for 32 graphs; int32 2) against the 67 TOP/s non-tensor pipe, versus
// (m·k + k·n + 2·m·n) storage words at 3.35 TB/s: at the phase-3 shape the
// launch is bound by operations, as in f32.  Tensor cores do not apply:
// the tropical ⊕ is not a sum, and the 16-bit plus_mul rounds after each
// op, which no MMA reproduces.
//
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "minplus_matmul.cuh"

namespace {

template <class T, class R>
int dispatch_half(int sid, const void* a, const void* b, const void* c, void* out, int B,
                  const Shape& sh, unsigned z, int stg, cudaStream_t st) {
  switch (sid) {
    case 0: return launch_matmul<MinPlusH<R>, T>(a, b, c, out, B, sh, z, stg, st);
    case 1: return launch_matmul<MaxPlusH<R>, T>(a, b, c, out, B, sh, z, stg, st);
    case 2:
    case 3: return launch_matmul<MaxMin, T>(a, b, c, out, B, sh, z, stg, st);
    case 4: return launch_matmul<PlusMulH<R>, T>(a, b, c, out, B, sh, z, stg, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// As semiring_matmul_launch (minplus_matmul.cu), with strides in storage
// elements.  storage: 0 bf16, 1 f16, 2 int16, 3 packed int32 words, 4 int32
// integers.  semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and,
// 4 plus_mul (bf16 / f16); int16 takes 0-3 (the *_i16 lowerings), packed 3
// only, int32 3 and 4.  zero_bits: the ⊕-identity's bits in the storage
// type (the low 16 bits for the 2-byte storages).  staging: 1 vector
// copies, 0 scalar (launch_matmul).
extern "C" int semiring_matmul_lowered_launch(int storage, int semiring, const void* a,
                                              long long lda, long long sa, const void* b,
                                              long long ldb, long long sb, const void* c,
                                              long long ldc, long long sc, void* out,
                                              long long ldo, long long so, int B, int m,
                                              int n, int k, unsigned zero_bits,
                                              int staging, void* stream) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{m, n, k, lda, sa, ldb, sb, ldc, sc, ldo, so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned z = zero_bits;
  const int stg = staging;
  if (storage == 0)
    return dispatch_half<__nv_bfloat16, RoundBf16>(semiring, a, b, c, out, B, sh, z, stg, st);
  if (storage == 1)
    return dispatch_half<__half, RoundF16>(semiring, a, b, c, out, B, sh, z, stg, st);
  if (storage == 2) {
    switch (semiring) {
      case 0: return launch_matmul<MinPlusI16, short>(a, b, c, out, B, sh, z, stg, st);
      case 1: return launch_matmul<MaxPlusI16, short>(a, b, c, out, B, sh, z, stg, st);
      case 2:
      case 3: return launch_matmul<MaxMinI16, short>(a, b, c, out, B, sh, z, stg, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (storage == 3 && semiring == 3)
    return launch_matmul<OrAndPacked, int>(a, b, c, out, B, sh, z, stg, st);
  if (storage == 4 && semiring == 3)
    return launch_matmul<MaxMinI16, int>(a, b, c, out, B, sh, z, stg, st);
  if (storage == 4 && semiring == 4)
    return launch_matmul<PlusMulI32, int>(a, b, c, out, B, sh, z, stg, st);
  return (int)cudaErrorInvalidValue;
}
