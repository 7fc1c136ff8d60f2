// The kernels of the 4-dispatch round's phases 1 and 2 (closure, row band,
// col band), templated on the storage type T of their operands:
// fw_phase.cu instantiates them for f32, fw_phase_lowered.cu for the
// storage lowerings.  What the launches do and why is in fw_phase.cu; the
// per-thread chains are in fw_phases.cuh, the steps in semiring.cuh.
// Registers hold Reg<T> (float for f32 / bf16 / f16, int for int16 and
// int32 words); the closed diagonal and the chains' shared vectors hold T,
// as the round's bands kernel holds them (fw_round.cuh): each value is
// widened on load and put back in T on store, exactly.
#pragma once

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

// A (rows x cols) operand of graph g: base + g * batch + r * ld + c.
template <class T>
struct View {
  const T* p;
  long long ld, batch;
};

template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
closure_kernel(View<T> in, T* __restrict__ out, long long ld_o, long long bs_o) {
  constexpr int R = S / 8;
  __shared__ T rowbuf[2][S];
  __shared__ T colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const T* src = in.p + blockIdx.z * in.batch;
  T* dst = out + blockIdx.z * bs_o;
  Reg<T> t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = widen(src[(rg + 8 * m) * in.ld + c]);
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) put(dst[(rg + 8 * m) * ld_o + c], t[m]);
}

// Stage the closed (S,S) diagonal of graph blockIdx.z with row stride S + 1.
template <int S, class T>
__device__ __forceinline__ void stage_diag(T* d, View<T> diag) {
  constexpr int DS = S + 1;
  const T* dg = diag.p + blockIdx.z * diag.batch;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = dg[(idx / S) * diag.ld + idx % S];
}

// blockIdx.x: the band tile of columns [x·S, x·S + S).
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
row_band_kernel(View<T> diag, View<T> band, T* __restrict__ out, long long ld_o,
                long long bs_o, int n) {
  constexpr int R = S / 8;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* d = reinterpret_cast<T*>(dyn_smem);  // S x (S + 1)
  __shared__ T buf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const int col = blockIdx.x * S + c;
  const bool live = col < n;
  const T* src = band.p + blockIdx.z * band.batch;
  T* dst = out + blockIdx.z * bs_o;
  stage_diag<S>(d, diag);
  Reg<T> t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = live ? widen(src[(rg + 8 * m) * band.ld + col]) : Reg<T>(0);
  __syncthreads();
  close_row_chain<S, Op>(t, d, buf, rg, c);
  if (live) {
#pragma unroll
    for (int m = 0; m < R; ++m) put(dst[(rg + 8 * m) * ld_o + col], t[m]);
  }
}

// blockIdx.x: the band tile of rows [x·S, x·S + S).
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
col_band_kernel(View<T> diag, View<T> band, T* __restrict__ out, long long ld_o,
                long long bs_o, int n) {
  constexpr int R = S / 8;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* d = reinterpret_cast<T*>(dyn_smem);  // S x (S + 1)
  __shared__ T buf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const long long r0 = (long long)blockIdx.x * S;
  const T* src = band.p + blockIdx.z * band.batch;
  T* dst = out + blockIdx.z * bs_o;
  stage_diag<S>(d, diag);
  Reg<T> t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const long long r = r0 + rg + 8 * m;
    t[m] = r < n ? widen(src[r * band.ld + c]) : Reg<T>(0);
  }
  __syncthreads();
  close_col_chain<S, R, Op>(t, d, buf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const long long r = r0 + rg + 8 * m;
    if (r < n) put(dst[r * ld_o + c], t[m]);
  }
}

// ------------------------------------------------------------- launching
constexpr size_t kPhaseDefaultSmem = 48 * 1024;

template <class K>
cudaError_t prepare_phase(K kernel, size_t smem) {
  if (smem <= kPhaseDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int S, class Op, class T>
int launch_phase(int kind, View<T> diag, View<T> band, T* out, long long ld_o,
                 long long bs_o, int B, int n, cudaStream_t st) {
  cudaError_t err;
  const size_t smem = (size_t)S * (S + 1) * sizeof(T);
  const int tiles = (n + S - 1) / S;
  if (kind == 0) {
    closure_kernel<S, Op, T><<<dim3(1, 1, B), 8 * S, 0, st>>>(diag, out, ld_o, bs_o);
  } else if (kind == 1) {
    if ((err = prepare_phase(row_band_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    row_band_kernel<S, Op, T><<<dim3(tiles, 1, B), 8 * S, smem, st>>>(diag, band, out, ld_o,
                                                                       bs_o, n);
  } else if (kind == 2) {
    if ((err = prepare_phase(col_band_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    col_band_kernel<S, Op, T><<<dim3(tiles, 1, B), 8 * S, smem, st>>>(diag, band, out, ld_o,
                                                                       bs_o, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch of kind (0 closure, 1 row band, 2 col band) at pivot width s
// in {16, 32, 64, 128}; the operands as void* in the storage type T.
template <class Op, class T>
int dispatch_phase(int kind, const void* diag, long long ld_d, long long bs_d,
                   const void* band, long long ld_b, long long bs_b, void* out,
                   long long ld_o, long long bs_o, int B, int n, int s, cudaStream_t st) {
  const View<T> dv{static_cast<const T*>(diag), ld_d, bs_d};
  const View<T> bv{static_cast<const T*>(band), ld_b, bs_b};
  T* po = static_cast<T*>(out);
  switch (s) {
    case 16: return launch_phase<16, Op, T>(kind, dv, bv, po, ld_o, bs_o, B, n, st);
    case 32: return launch_phase<32, Op, T>(kind, dv, bv, po, ld_o, bs_o, B, n, st);
    case 64: return launch_phase<64, Op, T>(kind, dv, bv, po, ld_o, bs_o, B, n, st);
    case 128: return launch_phase<128, Op, T>(kind, dv, bv, po, ld_o, bs_o, B, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
