// The kernels of the rank-E repair (stage, apply, successor apply),
// templated on the storage type T of the matrix, the staged rows, the row
// scalars and the weights: fw_repair.cu instantiates them for f32,
// fw_repair_lowered.cu for bf16, f16, int16, packed int32 words and the
// int32 carrier of the integer or_and / plus_mul storages.  What the
// launches do and why is in fw_repair.cu; the steps are semiring.cuh's.
// Registers (and shared memory) hold V = Reg<T>: each value is widened
// from T on load and put back in T on store, exactly, so a register only
// ever holds a value of its storage type, or of its lifted form
// (semiring.cuh:Lifted) in the apply.
#pragma once

#include <cuda_runtime.h>

#include <cstring>

#include "semiring.cuh"

namespace {

constexpr int kMaxEdges = 64;      // edges one launch pair carries, in every storage
constexpr int kStageThreads = 128;  // one column and one row each
constexpr int kApplyThreads = 256;  // 8 warps
constexpr int kApplyRows = 128;     // rows of an apply tile
constexpr int kAStride = kApplyRows + 4;  // row stride of the staged scalars: As[e][r]
constexpr int kKeptHop = -1;        // the successor apply's "no e improved"

// Elements of T in one 16-byte vector, and the apply tile's columns: a
// warp's 32 lanes by one vector each.
template <class T>
constexpr int kVecOf = 16 / (int)sizeof(T);
template <class T>
constexpr int kApplyCols = 32 * kVecOf<T>;

// Rows a thread of the apply holds at once: 4 (one 16-byte load of their
// scalars); 2 in the 2-byte successor apply, whose 8-wide vectors carry a
// hop and an e beside each distance.
template <class T, bool Succ>
constexpr int kGroupRowsOf = (Succ && sizeof(T) == 2) ? 2 : 4;

// ------------------------------------------------------------------ stage
// Each thread evolves one column j of the E staged rows, then one row i =
// j of the matrix at the columns u_b, writing the row scalars scal[i][e] =
// (row i at column u_e before step e) ⊗ w_e and, with Succ, the hop an
// improvement of row i at step e takes, hop[i][e] (v_e on row u_e, else
// row i's hop at column u_e before step e).  Both run kStageBlock values
// in registers at a time: a block first takes the steps before it, from
// what the thread already wrote (the staged rows x[t], the scalars), then
// its own triangle; each value sees its steps in ascending order, so one
// instantiation serves every E.  The apply reads the scalars.
constexpr int kStageBlock = 16;

template <class Op, class T, bool Succ>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const T* __restrict__ d, const int* __restrict__ succ, T* __restrict__ staged,
             T* __restrict__ scal, int* __restrict__ hop, const int* __restrict__ u,
             const int* __restrict__ v, const T* __restrict__ w, int n, int E) {
  using V = Reg<T>;
  constexpr int B = kStageBlock;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = E + 1;                // row stride of M and A
  V* M = reinterpret_cast<V*>(smem);  // [E][E+1]: row v_g at column u_b, evolving
  V* A = M + E * S;                   // [E][E+1]: (row v_g at u_t before step t) ⊗ w_t
  V* ws = A + E * S;
  int* us = reinterpret_cast<int*>(ws + E);
  int* vs = us + E;
  const int tid = threadIdx.x;
  for (int e = tid; e < E; e += kStageThreads) {
    us[e] = u[e];
    vs[e] = v[e];
    ws[e] = widen(w[e]);
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kStageThreads)
    M[idx / E * S + idx % E] = widen(d[(size_t)vs[idx / E] * n + us[idx % E]]);
  __syncthreads();
  for (int t = 0; t < E; ++t) {
    for (int g = t + 1 + tid; g < E; g += kStageThreads)
      A[g * S + t] = Op::mul(M[g * S + t], ws[t]);
    __syncthreads();
    const int k = E - 1 - t;  // rows g > t, columns b > t (column t is read no more)
    for (int idx = tid; idx < k * k; idx += kStageThreads) {
      const int g = t + 1 + idx / k, b = t + 1 + idx % k;
      M[g * S + b] = Op::relax(M[g * S + b], A[g * S + t], M[t * S + b]);
    }
    __syncthreads();
  }

  const int j = blockIdx.x * kStageThreads + tid;
  if (j >= n) return;
  for (int g0 = 0; g0 < E; g0 += B) {  // staged rows g0 .. g0 + B - 1 at column j
    V x[B];
#pragma unroll
    for (int q = 0; q < B; ++q) x[q] = g0 + q < E ? widen(d[(size_t)vs[g0 + q] * n + j]) : V(0);
#pragma unroll 4
    for (int t = 0; t < g0; ++t) {
      const V xt = widen(staged[(size_t)t * n + j]);
#pragma unroll
      for (int q = 0; q < B; ++q)
        if (g0 + q < E) x[q] = Op::relax(x[q], A[(g0 + q) * S + t], xt);
    }
#pragma unroll
    for (int r = 0; r < B; ++r) {
#pragma unroll
      for (int q = r + 1; q < B; ++q)
        if (g0 + q < E) x[q] = Op::relax(x[q], A[(g0 + q) * S + g0 + r], x[r]);
    }
#pragma unroll
    for (int q = 0; q < B; ++q)
      if (g0 + q < E) put(staged[(size_t)(g0 + q) * n + j], x[q]);
  }

  // Row i = j against the restriction: M[e][b] (b > e) is row v_e at
  // column u_b after the steps before e, the staged P[e][u_b], by the
  // column threads' own sequence of steps.
  const int i = j;
  for (int b0 = 0; b0 < E; b0 += B) {  // columns u_b, b = b0 .. b0 + B - 1
    V y[B];
    int ys[Succ ? B : 1];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const bool in = b0 + q < E;
      y[q] = in ? widen(d[(size_t)i * n + us[b0 + q]]) : V(0);
      if constexpr (Succ) ys[q] = in ? succ[(size_t)i * n + us[b0 + q]] : 0;
    }
#pragma unroll 4
    for (int e = 0; e < b0; ++e) {
      const V a = widen(scal[(size_t)i * E + e]);
      if constexpr (Succ) {  // Op = Strict<X>: relax_succ takes X's candidate
        const int h = hop[(size_t)i * E + e];
#pragma unroll
        for (int q = 0; q < B; ++q)
          if (b0 + q < E) relax_succ<Op>(y[q], ys[q], a, h, M[e * S + b0 + q]);
      } else {
#pragma unroll
        for (int q = 0; q < B; ++q)
          if (b0 + q < E) y[q] = Op::relax(y[q], a, M[e * S + b0 + q]);
      }
    }
#pragma unroll
    for (int r = 0; r < B; ++r) {
      const int e = b0 + r;
      if (e < E) {
        const V a = Op::mul(y[r], ws[e]);
        put(scal[(size_t)i * E + e], a);
        if constexpr (Succ) {
          const int h = i == us[e] ? vs[e] : ys[r];
          hop[(size_t)i * E + e] = h;
#pragma unroll
          for (int q = r + 1; q < B; ++q)
            if (b0 + q < E) relax_succ<Op>(y[q], ys[q], a, h, M[e * S + b0 + q]);
        } else {
#pragma unroll
          for (int q = r + 1; q < B; ++q)
            if (b0 + q < E) y[q] = Op::relax(y[q], a, M[e * S + b0 + q]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ apply
// Op's step on the apply's operands: Lifted<Op> (each operand lifted once,
// where it is staged), with int16 min-plus / max-plus's clamp against the
// other sentinel moved from every relaxation to finish(), before the put:
// max(min(max(min(acc, x), NINF), y), NINF) = max(min(acc, x, y), NINF),
// and the lifted sums stay within int32.  (The DPX add-min
// __viaddmin_s32(a, b, acc) computes the same relaxation in one
// instruction and ran no faster on the H100: PERF.md.)
template <class Op>
struct Streamed : Lifted<Op> {
  template <class V>
  static __device__ __forceinline__ V finish(V v) { return v; }
};
template <>
struct Streamed<MinPlusI16> {
  static __device__ __forceinline__ int lift(int v) { return Lifted<MinPlusI16>::lift(v); }
  static __device__ __forceinline__ int relax(int acc, int a, int b) {
    return min(acc, a + b);
  }
  static __device__ __forceinline__ int finish(int acc) { return max(acc, kI16NInf); }
};
template <>
struct Streamed<MaxPlusI16> {
  static __device__ __forceinline__ int lift(int v) { return Lifted<MaxPlusI16>::lift(v); }
  static __device__ __forceinline__ int relax(int acc, int a, int b) {
    return max(acc, a + b);
  }
  static __device__ __forceinline__ int finish(int acc) { return min(acc, kI16Inf); }
};

// N consecutive 4-byte values of shared memory into registers: 16-byte
// loads (8-byte for N = 2), at addresses aligned to them.
template <int N, class V>
__device__ __forceinline__ void lds_words(const V* p, V* v) {
  static_assert(sizeof(V) == 4 && (N % 4 == 0 || N == 2), "4-byte values, whole loads");
  if constexpr (N == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &w, 8);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 w = reinterpret_cast<const uint4*>(p)[q];
      memcpy(v + 4 * q, &w, 16);
    }
  }
}

// One vector of a row: the thread's VW columns col .. col + VW - 1 of row
// r.  vec: one 16-byte load (the caller's rows keep vectors aligned, and a
// vector lies wholly before n or past it), streamed (ld.global.cs: read
// once); else one element at a time.  Past n: the pad.
template <class T, class S>
__device__ __forceinline__ void load_row(S (&x)[kVecOf<T>], const S* src, int n, int r,
                                         int col, bool vec, S pad) {
  constexpr int VW = kVecOf<T>;
  const S* p = src + (size_t)r * n + col;
  if (vec) {
    static_assert(VW * sizeof(S) % 16 == 0, "whole 16-byte vectors");
    if (r < n && col < n) {
#pragma unroll
      for (int q = 0; q < (int)(VW * sizeof(S) / 16); ++q) {
        const uint4 w = __ldcs(reinterpret_cast<const uint4*>(p) + q);
        memcpy(x + q * 16 / (int)sizeof(S), &w, 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k) x[k] = pad;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k) x[k] = (r < n && col + k < n) ? p[k] : pad;
  }
}

template <class T, class S>
__device__ __forceinline__ void store_row(S* dst, const S (&x)[kVecOf<T>], int n, int r, int col,
                                          bool vec) {
  constexpr int VW = kVecOf<T>;
  if (r >= n) return;
  S* p = dst + (size_t)r * n + col;
  if (vec) {
    if (col < n) {
#pragma unroll
      for (int q = 0; q < (int)(VW * sizeof(S) / 16); ++q) {
        uint4 w;
        memcpy(&w, x + q * 16 / (int)sizeof(S), 16);
        __stcs(reinterpret_cast<uint4*>(p) + q, w);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VW; ++k)
      if (col + k < n) p[k] = x[k];
  }
}

// The CTA's slices into shared memory, once: row e of Ps holds P[e][j0 +
// c], and As[e][r] = scal[i0 + r][e] (0 past n), each widened and passed
// through lift (the successor apply: the identity); with hop, Hs[e][r] =
// hop[i0 + r][e].  Through registers, since each value changes on its way.
// Lane l's columns l·VW + 4q .. l·VW + 4q + 3 sit at words (32q + l)·4 of
// Ps's row, so that each of a warp's 16-byte shared loads (and stores)
// covers 512 consecutive bytes.
template <class T, class Lift>
__device__ __forceinline__ void stage_slices(Reg<T>* Ps, Reg<T>* As, int* Hs, const T* staged,
                                             const T* scal, const int* hop, int n, int E, int i0,
                                             int j0, bool vec, Lift&& lift) {
  using V = Reg<T>;
  constexpr int VW = kVecOf<T>, C = kApplyCols<T>;
  const int tid = threadIdx.x;
  T pad;
  put(pad, V(0));
  for (int idx = tid; idx < E * 32; idx += kApplyThreads) {  // a vector each
    const int e = idx / 32, l = idx % 32;
    T x[VW];
    load_row<T>(x, staged + (size_t)e * n, n, 0, j0 + l * VW, vec, pad);
    V y[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) y[k] = lift(widen(x[k]));
#pragma unroll
    for (int q = 0; q < VW / 4; ++q) {  // slice_col of columns l·VW + 4q ..
      uint4 w;
      memcpy(&w, y + 4 * q, 16);
      reinterpret_cast<uint4*>(Ps + e * C)[32 * q + l] = w;
    }
  }
  for (int idx = tid; idx < E * kApplyRows; idx += kApplyThreads) {  // e fastest: coalesced
    const int r = idx / E, e = idx % E;
    const bool in = i0 + r < n;
    As[e * kAStride + r] = in ? lift(widen(scal[(size_t)(i0 + r) * E + e])) : V(0);
    if (Hs != nullptr) Hs[e * kAStride + r] = in ? hop[(size_t)(i0 + r) * E + e] : 0;
  }
}

// out = d ⊕ A ⊗ P: CTA (x, y) owns rows [128y, 128y + 128) by columns
// [C·x, C·x + C) (C = kApplyCols<T>).  Warp w, lane l: the RT = 4 rows
// 32g + 4w .. of row group g = 0 .. 3, by lane l's vector.  The first
// group's loads are issued before the slices are staged, and each next
// group's before the current one folds; the fold reads A and P lifted from
// shared memory, e ascending at run time (one instantiation serves every E).
template <class Op, class T>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const T* __restrict__ d, T* __restrict__ out, const T* __restrict__ staged,
             const T* __restrict__ scal, int n, int E, int vec) {
  using V = Reg<T>;
  using S = Streamed<Op>;
  constexpr int VW = kVecOf<T>, C = kApplyCols<T>, RT = kGroupRowsOf<T, false>;
  constexpr int G = kApplyRows / (8 * RT);
  extern __shared__ __align__(16) unsigned char smem[];
  V* Ps = reinterpret_cast<V*>(smem);  // [E][C]
  V* As = Ps + E * C;                  // [E][kAStride]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = blockIdx.y * kApplyRows, col = blockIdx.x * C + lane * VW;
  T pad;
  put(pad, V(0));

  T next[RT][VW];
#pragma unroll
  for (int m = 0; m < RT; ++m) load_row<T>(next[m], d, n, i0 + warp * RT + m, col, vec, pad);
  stage_slices<T>(Ps, As, nullptr, staged, scal, nullptr, n, E, i0, blockIdx.x * C, vec,
                  [](V x) { return S::lift(x); });
  __syncthreads();

#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const int r0 = g * 8 * RT + warp * RT;  // the group's first row in the tile
    V acc[RT][VW];
#pragma unroll
    for (int m = 0; m < RT; ++m)
#pragma unroll
      for (int k = 0; k < VW; ++k) acc[m][k] = widen(next[m][k]);
    if (g + 1 < G) {
#pragma unroll
      for (int m = 0; m < RT; ++m)
        load_row<T>(next[m], d, n, i0 + r0 + 8 * RT + m, col, vec, pad);
    }
#pragma unroll 2
    for (int e = 0; e < E; ++e) {
      V a[RT], p[VW];
      lds_words<RT>(As + e * kAStride + r0, a);
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) lds_words<4>(Ps + e * C + (32 * q + lane) * 4, p + 4 * q);
#pragma unroll
      for (int m = 0; m < RT; ++m)
#pragma unroll
        for (int k = 0; k < VW; ++k) acc[m][k] = S::relax(acc[m][k], a[m], p[k]);
    }
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      T x[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) put(x[k], S::finish(acc[m][k]));
      store_row<T>(out, x, n, i0 + r0 + m, col, vec);
    }
  }
}

// Successor apply (min-plus): the same tiles carrying next hops.  Op is the
// distance step of relax_succ (MinPlus in f32, MinPlusH<R> in bf16 / f16):
// the candidate A ⊗ P rounds to the storage before its strict compare,
// nothing lifted.  Each element keeps the e of its last strict improvement
// and gathers Hs[e][r] once after the fold, else keeps its own hop, which
// is loaded while the group folds.
template <class Op, class T>
__global__ void __launch_bounds__(kApplyThreads)
succ_apply_kernel(const T* __restrict__ d, const int* __restrict__ succ, T* __restrict__ out,
                  int* __restrict__ succ_out, const T* __restrict__ staged,
                  const T* __restrict__ scal, const int* __restrict__ hop, int n, int E,
                  int vec) {
  constexpr int VW = kVecOf<T>, C = kApplyCols<T>, RT = kGroupRowsOf<T, true>;
  constexpr int G = kApplyRows / (8 * RT);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);  // [E][C]
  float* As = Ps + E * C;                      // [E][kAStride]
  int* Hs = reinterpret_cast<int*>(As + E * kAStride);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = blockIdx.y * kApplyRows, col = blockIdx.x * C + lane * VW;
  T pad;
  put(pad, 0.f);

  T next[RT][VW];
#pragma unroll
  for (int m = 0; m < RT; ++m) load_row<T>(next[m], d, n, i0 + warp * RT + m, col, vec, pad);
  stage_slices<T>(Ps, As, Hs, staged, scal, hop, n, E, i0, blockIdx.x * C, vec,
                  [](float x) { return x; });
  __syncthreads();

#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    const int r0 = g * 8 * RT + warp * RT;
    float acc[RT][VW];
    int ks[RT][VW], s[RT][VW];
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      load_row<T>(s[m], succ, n, i0 + r0 + m, col, vec, 0);
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        acc[m][k] = widen(next[m][k]);
        ks[m][k] = kKeptHop;
      }
    }
    if (g + 1 < G) {
#pragma unroll
      for (int m = 0; m < RT; ++m)
        load_row<T>(next[m], d, n, i0 + r0 + 8 * RT + m, col, vec, pad);
    }
#pragma unroll 2
    for (int e = 0; e < E; ++e) {
      float a[RT], p[VW];
      lds_words<RT>(As + e * kAStride + r0, a);
#pragma unroll
      for (int q = 0; q < VW / 4; ++q) lds_words<4>(Ps + e * C + (32 * q + lane) * 4, p + 4 * q);
#pragma unroll
      for (int m = 0; m < RT; ++m)
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          const float cand = Op::mul(a[m], p[k]);
          const bool better = cand < acc[m][k];
          acc[m][k] = better ? cand : acc[m][k];
          ks[m][k] = better ? e : ks[m][k];
        }
    }
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      T x[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        put(x[k], acc[m][k]);
        if (ks[m][k] != kKeptHop) s[m][k] = Hs[ks[m][k] * kAStride + r0 + m];
      }
      store_row<T>(out, x, n, i0 + r0 + m, col, vec);
      store_row<T>(succ_out, s[m], n, i0 + r0 + m, col, vec);
    }
  }
}

// ------------------------------------------------------------- launching
// The stage: rows v_e of d -> staged (E, n), the row scalars -> scal (n,
// E); Succ (Op = Strict<X>): the hops -> hop (n, E) from succ.
template <class Op, class T, bool Succ>
int launch_stage(const T* d, const int* succ, T* staged, T* scal, int* hop, const int* u,
                 const int* v, const T* w, int n, int E, cudaStream_t st) {
  const int grid = (n + kStageThreads - 1) / kStageThreads;
  const size_t bytes = (size_t)(2 * E * (E + 1) + E) * sizeof(Reg<T>) + 2 * E * sizeof(int);
  stage_kernel<Op, T, Succ><<<grid, kStageThreads, bytes, st>>>(d, succ, staged, scal, hop, u,
                                                                v, w, n, E);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch: above 48 KB the kernel must ask.
template <class K>
int smem_for(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

inline dim3 apply_grid(int n, int cols) {
  return dim3((n + cols - 1) / cols, (n + kApplyRows - 1) / kApplyRows);
}

// The apply: d, staged, scal -> out (never d).  vec: every row of d, out
// and staged starts 16-byte aligned (fw_repair.py:apply_vectors).
template <class Op, class T>
int launch_apply(const T* d, T* out, const T* staged, const T* scal, int n, int E, int vec,
                 cudaStream_t st) {
  if (out == d) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)E * (kApplyCols<T> + kAStride) * sizeof(Reg<T>);
  const int err = smem_for(apply_kernel<Op, T>, bytes);
  if (err) return err;
  apply_kernel<Op, T><<<apply_grid(n, kApplyCols<T>), kApplyThreads, bytes, st>>>(
      d, out, staged, scal, n, E, vec);
  return (int)cudaGetLastError();
}

template <class Op, class T>
int launch_succ_apply(const T* d, const int* succ, T* out, int* succ_out, const T* staged,
                      const T* scal, const int* hop, int n, int E, int vec, cudaStream_t st) {
  if (out == d || succ_out == succ) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)E * (kApplyCols<T> + 2 * kAStride) * 4;
  const int err = smem_for(succ_apply_kernel<Op, T>, bytes);
  if (err) return err;
  succ_apply_kernel<Op, T><<<apply_grid(n, kApplyCols<T>), kApplyThreads, bytes, st>>>(
      d, succ, out, succ_out, staged, scal, hop, n, E, vec);
  return (int)cudaGetLastError();
}

}  // namespace
