// The blocked semiring matmul C_out = [C_in ⊕] A ⊗⊕ B, templated on the
// semiring step Op and the storage type T of a, b, c and out:
// minplus_matmul.cu instantiates it for f32, minplus_matmul_lowered.cu for
// the storage lowerings.  What the launch does and why is in
// minplus_matmul.cu; the relax loop is relax_chunk of fw_phases.cuh, the
// steps are semiring.cuh's.
//
// The A / B slices sit in shared memory in the storage type and the 8 x 8
// register tile in Reg<T> (float for f32 / bf16 / f16, int for int16 and
// int32 words): each value is widened on load and put back in T on store,
// exactly, and the step rounds or saturates after every op, so each
// element's chain is the f32 kernel's chain in the storage's arithmetic.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

#include "fw_phases.cuh"

namespace {

constexpr int kTile = 128;     // output tile edge
constexpr int kThreads = 256;  // 16 x 16
constexpr int kBK = 32;        // staging depth

struct Shape {
  int m, n, k;
  long long lda, sa, ldb, sb, ldc, sc, ldo, so;  // row and batch strides
};

// The value of T whose bits are the low bits of ``bits``: the semiring's
// ⊕-identity crosses the C interface by its bits, which a float cannot
// carry for int16's sentinel or the flipped uint32 identity.
template <class T>
inline T from_bits(unsigned bits) {
  T v;
  if constexpr (sizeof(T) == 2) {
    const unsigned short h = static_cast<unsigned short>(bits);
    memcpy(&v, &h, 2);
  } else {
    memcpy(&v, &bits, 4);
  }
  return v;
}

template <class Op, class T>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* c, T* out, Shape sh,
              T zero) {
  constexpr int TM = kTile / 16;
  __shared__ T As[kTile * (kBK + 1)];  // kTile x kc, row stride kc + 1
  __shared__ T Bs[kBK * kTile];        // kc x kTile
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long g = blockIdx.z;
  a += g * sh.sa;
  b += g * sh.sb;
  out += g * sh.so;
  T pad;  // what rows and columns past the end load: 0, fed only to themselves
  put(pad, Reg<T>(0));

  Reg<T> acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = i0 + ty + 16 * i, col = j0 + tx + 16 * j;
      acc[i][j] = widen((c != nullptr && r < sh.m && col < sh.n)
                            ? c[g * sh.sc + (long long)r * sh.ldc + col]
                            : zero);
    }

  for (int k0 = 0; k0 < sh.k; k0 += kBK) {
    const int kc = min(kBK, sh.k - k0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * kc; idx += kThreads) {
      const int r = idx / kc, kk = idx % kc;
      As[r * (kc + 1) + kk] = i0 + r < sh.m ? a[(long long)(i0 + r) * sh.lda + k0 + kk] : pad;
    }
    for (int idx = threadIdx.x; idx < kc * kTile; idx += kThreads) {
      const int kk = idx / kTile, cc = idx % kTile;
      Bs[kk * kTile + cc] = j0 + cc < sh.n ? b[(long long)(k0 + kk) * sh.ldb + j0 + cc] : pad;
    }
    __syncthreads();
    relax_chunk<kTile, TM, 16, Op>(acc, As, Bs, kc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int r = i0 + ty + 16 * i, col = j0 + tx + 16 * j;
      if (r < sh.m && col < sh.n) put(out[(long long)r * sh.ldo + col], acc[i][j]);
    }
}

template <class Op, class T>
int launch_matmul(const void* a, const void* b, const void* c, void* out, int B,
                  const Shape& sh, unsigned zero_bits, cudaStream_t st) {
  const dim3 grid((sh.n + kTile - 1) / kTile, (sh.m + kTile - 1) / kTile, B);
  matmul_kernel<Op, T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<T*>(out), sh, from_bits<T>(zero_bits));
  return (int)cudaGetLastError();
}

}  // namespace
