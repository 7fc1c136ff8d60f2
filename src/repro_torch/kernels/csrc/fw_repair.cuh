// The kernels of the rank-1 repair (stage, apply, successor apply),
// templated on the storage type T of the matrix, the staged rows and the
// weights: fw_repair.cu instantiates them for f32, fw_repair_lowered.cu for
// bf16, f16, int16, packed int32 words and the int32 carrier of the integer
// or_and / plus_mul storages.  What the launches do and why is in
// fw_repair.cu; the steps are semiring.cuh's.  Registers (and shared
// memory) hold V = Reg<T>: each value is widened from T on load and put
// back in T on store, exactly, so a register only ever holds a value of its
// storage type.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kStageThreads = 128;  // one column each
constexpr int kRows = 32;           // rows per apply CTA
constexpr int kCols = 128;          // column chunk of the apply CTA
constexpr int kSlice = 16;          // staged rows per shared-memory slice
constexpr int kApplyThreads = 256;  // 8 row groups of 4 x 32 lanes of 4 columns

template <class V>
struct Vec4Of {
  using type = float4;
};
template <>
struct Vec4Of<int> {
  using type = int4;
};

// The four values of row slot r4 .. r4+3 of a (·, kRows) shared array.
template <class V>
__device__ __forceinline__ void load4(const V* p, V (&a)[4]) {
  const auto v = *reinterpret_cast<const typename Vec4Of<V>::type*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// ------------------------------------------------------------------ stage
template <int EM, class Op, class T>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const T* __restrict__ d, T* __restrict__ staged, const int* __restrict__ u,
             const int* __restrict__ v, const T* __restrict__ w, int n, int E) {
  using V = Reg<T>;
  __shared__ V M[EM][EM + 1];  // row v_g at column u_b, evolving
  __shared__ V A[EM][EM + 1];  // A[g][t] = (row v_g at u_t before step t) ⊗ w_t
  __shared__ int us[EM], vs[EM];
  __shared__ V ws[EM];
  const int tid = threadIdx.x;
  if (tid < E) {
    us[tid] = u[tid];
    vs[tid] = v[tid];
    ws[tid] = widen(w[tid]);
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kStageThreads)
    M[idx / E][idx % E] = widen(d[(size_t)vs[idx / E] * n + us[idx % E]]);
  __syncthreads();
  for (int t = 0; t < E; ++t) {
    for (int g = t + 1 + tid; g < E; g += kStageThreads) A[g][t] = Op::mul(M[g][t], ws[t]);
    __syncthreads();
    const int k = E - 1 - t;  // rows g > t, columns b > t (column t is read no more)
    for (int idx = tid; idx < k * k; idx += kStageThreads) {
      const int g = t + 1 + idx / k, b = t + 1 + idx % k;
      M[g][b] = Op::relax(M[g][b], A[g][t], M[t][b]);
    }
    __syncthreads();
  }

  const int j = blockIdx.x * kStageThreads + tid;
  if (j >= n) return;
  V x[EM];
#pragma unroll
  for (int g = 0; g < EM; ++g) x[g] = g < E ? widen(d[(size_t)vs[g] * n + j]) : V(0);
#pragma unroll
  for (int t = 0; t < EM; ++t) {
#pragma unroll
    for (int g = t + 1; g < EM; ++g)
      if (g < E) x[g] = Op::relax(x[g], A[g][t], x[t]);
  }
#pragma unroll
  for (int g = 0; g < EM; ++g)
    if (g < E) put(staged[(size_t)g * n + j], x[g]);
}

// ------------------------------------------------------------------ apply
template <int EM, class Op, class T>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const T* __restrict__ d, T* __restrict__ out, const T* __restrict__ staged,
             const int* __restrict__ u, const T* __restrict__ w, int n, int E) {
  using V = Reg<T>;
  __shared__ V PU[EM][EM + 1];                // PU[e][b] = P[e][u_b]
  __shared__ __align__(16) V A[EM][kRows];    // (row i at u_e before step e) ⊗ w_e
  __shared__ V Ps[kSlice][kCols];
  __shared__ int us[EM];
  __shared__ V ws[EM];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kRows;
  if (tid < E) {
    us[tid] = u[tid];
    ws[tid] = widen(w[tid]);
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kApplyThreads)
    PU[idx / E][idx % E] = widen(staged[(size_t)(idx / E) * n + us[idx % E]]);
  __syncthreads();
  if (tid < kRows) {  // the scalars of row i0 + tid
    const int i = i0 + tid;
    V y[EM];
#pragma unroll
    for (int b = 0; b < EM; ++b) y[b] = (b < E && i < n) ? widen(d[(size_t)i * n + us[b]]) : V(0);
#pragma unroll
    for (int e = 0; e < EM; ++e) {
      if (e < E) {
        const V a = Op::mul(y[e], ws[e]);
        A[e][tid] = a;
#pragma unroll
        for (int b = e + 1; b < EM; ++b)
          if (b < E) y[b] = Op::relax(y[b], a, PU[e][b]);
      }
    }
  }

  const int tx = tid % 32, ty = tid / 32;  // rows ty*4 + m, columns tx + 32q
  for (int j0 = 0; j0 < n; j0 += kCols) {
    V acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        acc[m][q] = (i < n && j < n) ? widen(d[(size_t)i * n + j]) : V(0);
      }
    for (int e0 = 0; e0 < E; e0 += kSlice) {
      const int ec = min(kSlice, E - e0);
      __syncthreads();  // A is written; the previous slice is consumed
      for (int idx = tid; idx < ec * kCols; idx += kApplyThreads) {
        const int j = j0 + idx % kCols;
        Ps[idx / kCols][idx % kCols] =
            j < n ? widen(staged[(size_t)(e0 + idx / kCols) * n + j]) : V(0);
      }
      __syncthreads();
      for (int ee = 0; ee < ec; ++ee) {
        V a[4];
        load4(&A[e0 + ee][ty * 4], a);
        V p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = Ps[ee][tx + 32 * q];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] = Op::relax(acc[m][q], a[m], p[q]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        if (i < n && j < n) put(out[(size_t)i * n + j], acc[m][q]);
      }
  }
}

// Successor apply (min-plus): the same schedule carrying next hops.  Op is
// the distance step of relax_succ (StrictMinPlus in f32, MinPlusH<R> in
// bf16 / f16): the candidate (d[i,u] ⊗ w) ⊗ d[v,j] rounds after each ⊗.
template <int EM, class Op, class T>
__global__ void __launch_bounds__(kApplyThreads)
succ_apply_kernel(const T* __restrict__ d, const int* __restrict__ succ, T* __restrict__ out,
                  int* __restrict__ succ_out, const T* __restrict__ staged,
                  const int* __restrict__ u, const int* __restrict__ v,
                  const T* __restrict__ w, int n, int E) {
  __shared__ float PU[EM][EM + 1];
  __shared__ __align__(16) float A[EM][kRows];  // (row i at u_e before step e) ⊗ w_e
  __shared__ __align__(16) int H[EM][kRows];    // the hop an improvement takes
  __shared__ float Ps[kSlice][kCols];
  __shared__ int us[EM], vs[EM];
  __shared__ float ws[EM];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kRows;
  if (tid < E) {
    us[tid] = u[tid];
    vs[tid] = v[tid];
    ws[tid] = widen(w[tid]);
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kApplyThreads)
    PU[idx / E][idx % E] = widen(staged[(size_t)(idx / E) * n + us[idx % E]]);
  __syncthreads();
  if (tid < kRows) {
    const int i = i0 + tid;
    float y[EM];
    int ys[EM];
#pragma unroll
    for (int b = 0; b < EM; ++b) {
      const bool in = b < E && i < n;
      y[b] = in ? widen(d[(size_t)i * n + us[b]]) : 0.f;
      ys[b] = in ? succ[(size_t)i * n + us[b]] : 0;
    }
#pragma unroll
    for (int e = 0; e < EM; ++e) {
      if (e < E) {
        const float a = Op::mul(y[e], ws[e]);
        const int h = i == us[e] ? vs[e] : ys[e];
        A[e][tid] = a;
        H[e][tid] = h;
#pragma unroll
        for (int b = e + 1; b < EM; ++b) {
          if (b < E) relax_succ<Op>(y[b], ys[b], a, h, PU[e][b]);
        }
      }
    }
  }

  const int tx = tid % 32, ty = tid / 32;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    float acc[4][4];
    int sacc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        const bool in = i < n && j < n;
        acc[m][q] = in ? widen(d[(size_t)i * n + j]) : 0.f;
        sacc[m][q] = in ? succ[(size_t)i * n + j] : 0;
      }
    for (int e0 = 0; e0 < E; e0 += kSlice) {
      const int ec = min(kSlice, E - e0);
      __syncthreads();
      for (int idx = tid; idx < ec * kCols; idx += kApplyThreads) {
        const int j = j0 + idx % kCols;
        Ps[idx / kCols][idx % kCols] =
            j < n ? widen(staged[(size_t)(e0 + idx / kCols) * n + j]) : 0.f;
      }
      __syncthreads();
      for (int ee = 0; ee < ec; ++ee) {
        float a[4];
        int h[4];
        load4(&A[e0 + ee][ty * 4], a);
        load4(&H[e0 + ee][ty * 4], h);
        float p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = Ps[ee][tx + 32 * q];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) relax_succ<Op>(acc[m][q], sacc[m][q], a[m], h[m], p[q]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        if (i < n && j < n) {
          put(out[(size_t)i * n + j], acc[m][q]);
          succ_out[(size_t)i * n + j] = sacc[m][q];
        }
      }
  }
}

// ------------------------------------------------------------- launching
// The compile-time edge capacity EM of a launch: the first of EMs >= E (the
// last one if none is); each translation unit names its own list.
template <int EM, int... More, class F>
int pick_em(int E, F&& launch) {
  if constexpr (sizeof...(More) == 0) {
    return launch(std::integral_constant<int, EM>{});
  } else {
    if (E <= EM) return launch(std::integral_constant<int, EM>{});
    return pick_em<More...>(E, launch);
  }
}

// phase 0 = stage (rows v_e of d -> staged (E, n)), 1 = apply (d, staged
// -> out).
template <class Op, class T, int... EMs>
int launch_repair(int phase, const T* d, T* out, T* staged, const int* u, const int* v,
                  const T* w, int n, int E, cudaStream_t st) {
  if (phase == 0) {
    const int grid = (n + kStageThreads - 1) / kStageThreads;
    return pick_em<EMs...>(E, [&](auto em) {
      stage_kernel<decltype(em)::value, Op, T><<<grid, kStageThreads, 0, st>>>(d, staged, u, v,
                                                                               w, n, E);
      return (int)cudaGetLastError();
    });
  }
  const int grid = (n + kRows - 1) / kRows;
  return pick_em<EMs...>(E, [&](auto em) {
    apply_kernel<decltype(em)::value, Op, T><<<grid, kApplyThreads, 0, st>>>(d, out, staged, u,
                                                                             w, n, E);
    return (int)cudaGetLastError();
  });
}

// The successor repair: phase 0 stages the distances with the strict
// relaxation on Op's rounding; phase 1 applies to d and succ.
template <class Op, class T, int... EMs>
int launch_repair_succ(int phase, const T* d, const int* succ, T* out, int* succ_out,
                       T* staged, const int* u, const int* v, const T* w, int n, int E,
                       cudaStream_t st) {
  if (phase == 0) return launch_repair<Strict<Op>, T, EMs...>(0, d, out, staged, u, v, w, n, E, st);
  const int grid = (n + kRows - 1) / kRows;
  return pick_em<EMs...>(E, [&](auto em) {
    succ_apply_kernel<decltype(em)::value, Op, T><<<grid, kApplyThreads, 0, st>>>(
        d, succ, out, succ_out, staged, u, v, w, n, E);
    return (int)cudaGetLastError();
  });
}

}  // namespace
