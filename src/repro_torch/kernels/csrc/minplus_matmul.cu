// Blocked semiring matmul C_out = [C_in ⊕] A ⊗⊕ B for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minplus_matmul.py:
// semiring_matmul (_matmul_kernel without C, _fused_kernel with C): phase 3
// of the 4-dispatch round, and the product the R-Kleene sweep and the
// distributed SUMMA step are built from.
//
// a (B,m,k), b (B,k,n), c and out (B,m,n), any m, k, n >= 1, f32, five
// semirings.  One CTA of 256 threads per 128 x 128 output tile, the batch
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
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

constexpr int kTile = 128;    // output tile edge
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 32;       // staging depth

struct Shape {
  int m, n, k;
  long long lda, sa, ldb, sb, ldc, sc, ldo, so;  // row and batch strides
};

template <class Op>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, const float* c,
              float* out, Shape sh, float zero) {
  constexpr int TM = kTile / 16;
  __shared__ float As[kTile * (kBK + 1)];  // kTile x kc, row stride kc + 1
  __shared__ float Bs[kBK * kTile];        // kc x kTile
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long g = blockIdx.z;
  a += g * sh.sa;
  b += g * sh.sb;
  out += g * sh.so;

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = i0 + ty + 16 * i, col = j0 + tx + 16 * j;
      acc[i][j] = (c != nullptr && r < sh.m && col < sh.n)
                      ? c[g * sh.sc + (long long)r * sh.ldc + col]
                      : zero;
    }

  for (int k0 = 0; k0 < sh.k; k0 += kBK) {
    const int kc = min(kBK, sh.k - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kc; idx += kThreads) {
      const int r = idx / kc, kk = idx % kc;
      As[r * (kc + 1) + kk] =
          i0 + r < sh.m ? a[(long long)(i0 + r) * sh.lda + k0 + kk] : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kc * kTile; idx += kThreads) {
      const int kk = idx / kTile, cc = idx % kTile;
      Bs[kk * kTile + cc] =
          j0 + cc < sh.n ? b[(long long)(k0 + kk) * sh.ldb + j0 + cc] : 0.0f;
    }
    __syncthreads();
    relax_chunk<kTile, TM, 16, Op>(acc, As, Bs, kc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = i0 + ty + 16 * i, col = j0 + tx + 16 * j;
      if (r < sh.m && col < sh.n) out[(long long)r * sh.ldo + col] = acc[i][j];
    }
}

template <class Op>
int launch(const float* a, const float* b, const float* c, float* out, int B,
           const Shape& sh, float zero, cudaStream_t st) {
  const dim3 grid((sh.n + kTile - 1) / kTile, (sh.m + kTile - 1) / kTile, B);
  matmul_kernel<Op><<<grid, kThreads, 0, st>>>(a, b, c, out, sh, zero);
  return (int)cudaGetLastError();
}

}  // namespace

// a (B,m,k), b (B,k,n), c (B,m,n) or null, out (B,m,n): base pointers, row
// and batch strides in floats, unit column strides.  zero: the semiring's
// ⊕-identity, the start without c.  semiring: 0 min_plus, 1 max_plus,
// 2 max_min, 3 or_and, 4 plus_mul.
extern "C" int semiring_matmul_launch(const void* a, long long lda, long long sa,
                                      const void* b, long long ldb, long long sb,
                                      const void* c, long long ldc, long long sc,
                                      void* out, long long ldo, long long so, int B,
                                      int m, int n, int k, float zero, int semiring,
                                      void* stream) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const Shape sh{m, n, k, lda, sa, ldb, sb, ldc, sc, ldo, so};
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* pc = static_cast<const float*>(c);
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch<MinPlus>(pa, pb, pc, po, B, sh, zero, st);
    case 1: return launch<MaxPlus>(pa, pb, pc, po, B, sh, zero, st);
    case 2:
    case 3: return launch<MaxMin>(pa, pb, pc, po, B, sh, zero, st);
    case 4: return launch<PlusMul>(pa, pb, pc, po, B, sh, zero, st);
  }
  return (int)cudaErrorInvalidValue;
}
