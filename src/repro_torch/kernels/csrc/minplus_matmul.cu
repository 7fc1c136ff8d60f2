// Blocked semiring matmul C_out = [C_in ⊕] A ⊗⊕ B for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minplus_matmul.py:
// semiring_matmul (_matmul_kernel without C, _fused_kernel with C): phase 3
// of the 4-dispatch round, and the product the R-Kleene sweep and the
// distributed SUMMA step are built from.
//
// a (B,m,k), b (B,k,n), c and out (B,m,n), any m, k, n >= 1, f32, five
// semirings (the storage lowerings: minplus_matmul_lowered.cu).  One CTA of 256 threads per 128 x 128 output tile, the batch
// on gridDim.z.  The tile lives in registers (8 x 8 a thread, thread (ty,
// tx) owning rows ty + 16i and columns tx + 16j) and starts from C_in, or
// from the semiring's zero when there is no C (as _matmul_kernel fills it).
// k is folded in ascending order through 32-deep A / B slices staged in
// shared memory: fw_round.cu's relax loop (relax_chunk of fw_phases.cuh),
// generalised to rectangular and ragged shapes.  The reference's bm / bn /
// bk choose no element's chain (its staging-depth invariance test), so the
// tile here is this kernel's own.
//
// Ragged edges.  Rows past m and columns past n load 0 and are not
// stored; they feed only themselves.  A last k slice shorter than 32 is
// folded to its own depth: the k past the end are skipped, never padded
// with a ⊕-identity, because the ⊗ of such padding is not inert
// (plus_mul's fmaf(0, inf, acc) and max_plus's -inf + inf are NaN).
//
// Exactness.  The steps of semiring.cuh: plus_mul one __fmaf_rn a step, as
// XLA contracts c + a*b in the reference (never a tensor core: ⊗ is not a
// multiply-add for the tropical semirings, and plus_mul must keep this
// chain); min.NaN / max.NaN.  out may be c itself (each element reads its
// own C_in before any store); it must not overlap a or b.
//
// Bound on this card.  m·n·k relaxations of 2 fp32 operations against the
// 67 TFLOP/s non-tensor pipe, versus (m·k + k·n + 2·m·n) words at
// 3.35 TB/s: at the phase-3 shape (8192,128)·(128,8192) the launch does
// ~128 relaxations per word it moves, and every square product far more,
// so it is bound by operations.  Each thread reads 8 + 8 operands from
// shared memory per 64 relaxations.  cp.async / TMA staging and a
// double-buffered slice are later work.
//
// The kernel lives in minplus_matmul.cuh, templated on the step and the
// storage type; this file instantiates it for f32.
//
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "minplus_matmul.cuh"

// a (B,m,k), b (B,k,n), c (B,m,n) or null, out (B,m,n): base pointers, row
// and batch strides in elements, unit column strides.  zero_bits: the bits
// of the semiring's ⊕-identity in f32, the start without c.  semiring:
// 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.
extern "C" int semiring_matmul_launch(const void* a, long long lda, long long sa,
                                      const void* b, long long ldb, long long sb,
                                      const void* c, long long ldc, long long sc,
                                      void* out, long long ldo, long long so, int B,
                                      int m, int n, int k, unsigned zero_bits, int semiring,
                                      void* stream) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{m, n, k, lda, sa, ldb, sb, ldc, sc, ldo, so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch_matmul<MinPlus, float>(a, b, c, out, B, sh, zero_bits, st);
    case 1: return launch_matmul<MaxPlus, float>(a, b, c, out, B, sh, zero_bits, st);
    case 2:
    case 3: return launch_matmul<MaxMin, float>(a, b, c, out, B, sh, zero_bits, st);
    case 4: return launch_matmul<PlusMul, float>(a, b, c, out, B, sh, zero_bits, st);
  }
  return (int)cudaErrorInvalidValue;
}
