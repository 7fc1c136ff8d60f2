// Blocked semiring matmul C_out = [C_in ⊕] A ⊗⊕ B for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minplus_matmul.py:
// semiring_matmul (_matmul_kernel without C, _fused_kernel with C): phase 3
// of the 4-dispatch round, and the product the R-Kleene sweep and the
// distributed SUMMA step are built from.
//
// a (B,m,k), b (B,k,n), c and out (B,m,n), any m, k, n >= 1, f32, five
// semirings (the storage lowerings: minplus_matmul_lowered.cu).  One CTA
// of 256 threads per 128 x 128 output tile, the batch on gridDim.z; the
// tile starts from C_in, or from the semiring's zero when there is no C
// (as _matmul_kernel fills it).  The reference's bm / bn / bk choose no
// element's chain (its staging-depth invariance test), so the tile and
// the slice depth here are this kernel's own.
//
// Bound on this card.  m·n·k relaxations of 2 fp32 operations (plus_mul
// one FMA) against the 67 TFLOP/s non-tensor pipe, versus (m·k + k·n +
// 2·m·n) words at 3.35 TB/s: at the phase-3 shape (8192,128)·(128,8192)
// the launch does ~128 relaxations per word it moves, and every square
// product far more, so it is bound by operations, and the design keeps
// the FMA / min pipe fed:
//   - Register blocking.  Thread (ty, tx) holds an 8 x 8 tile as 2 x 2
//     blocks of 4 x 4 (rows 4ty + {0..3} and 64 + 4ty + {0..3}, columns
//     likewise), so each k costs four 4-wide shared reads (16 bytes in
//     f32) for 64 relaxations, where a strided 8 x 8 tile costs 16 scalar
//     reads.  A warp covers 4 ty by 8 tx: each read is a broadcast of 4
//     distinct A or 8 distinct B addresses, free of bank conflicts.
//   - A k-major.  A is transposed on its way into shared memory (As[k][r],
//     a warp's 32 rows of one k into 32 banks); B is staged as it lies.
//   - A pipeline.  16-deep slices (8 in the 2-byte storages, whose steps
//     need the registers), double-buffered: slice s + 1's global
//     loads are in flight while slice s folds (B by cp.async 16-byte
//     copies into the other buffer, A by 16-byte loads into registers,
//     stored transposed after the fold), with one __syncthreads a slice
//     and no integer division in the staging.
//   - Staging.  The vector copies need 16-byte aligned pointers and row /
//     batch strides (minplus_matmul.py:staging chooses, per call); ragged
//     or unaligned views take the scalar instantiation of the same kernel,
//     B through registers too.  __launch_bounds__(256, 2): two CTAs an SM.
//
// Ragged edges.  Rows past m and columns past n load 0 and are not
// stored; they feed only themselves.  A last k slice shorter than the
// slice depth is folded to its own depth: the k past the end are
// skipped, never padded with a ⊕-identity, because the ⊗ of such padding
// is not inert (plus_mul's fmaf(0, inf, acc) and max_plus's -inf + inf
// are NaN).
//
// Exactness.  Each element folds k in ascending order, one step of
// semiring.cuh a k, whatever the tile: plus_mul one __fmaf_rn a step, as
// XLA contracts c + a*b in the reference (never a tensor core: ⊗ is not a
// multiply-add for the tropical semirings, and plus_mul must keep this
// chain); min.NaN / max.NaN.  out may be c itself (each element reads its
// own C_in before any store, in the thread that stores it); it must not
// overlap a or b.
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
// 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.  staging: 1
// vector copies, 0 scalar (launch_matmul).
extern "C" int semiring_matmul_launch(const void* a, long long lda, long long sa,
                                      const void* b, long long ldb, long long sb,
                                      const void* c, long long ldc, long long sc,
                                      void* out, long long ldo, long long so, int B,
                                      int m, int n, int k, unsigned zero_bits, int semiring,
                                      int staging, void* stream) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{m, n, k, lda, sa, ldb, sb, ldc, sc, ldo, so};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned zb = zero_bits;
  switch (semiring) {
    case 0: return launch_matmul<MinPlus, float>(a, b, c, out, B, sh, zb, staging, st);
    case 1: return launch_matmul<MaxPlus, float>(a, b, c, out, B, sh, zb, staging, st);
    case 2:
    case 3: return launch_matmul<MaxMin, float>(a, b, c, out, B, sh, zb, staging, st);
    case 4: return launch_matmul<PlusMul, float>(a, b, c, out, B, sh, zb, staging, st);
  }
  return (int)cudaErrorInvalidValue;
}
