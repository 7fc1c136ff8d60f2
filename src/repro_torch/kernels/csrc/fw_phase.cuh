// The kernels of the 4-dispatch round's phases 1 and 2 (closure, row band,
// col band), templated on the storage type T of their operands:
// fw_phase.cu instantiates them for f32, fw_phase_lowered.cu for the
// storage lowerings.  What the launches do and why is in fw_phase.cu; the
// chains are fw_phases.cuh's register-block and band-lane bodies, the steps
// semiring.cuh's.  Registers, the published vectors and the staged diagonal
// hold V = Reg<T> (float for f32 / bf16 / f16, int for int16 and int32
// words), their operands lifted (semiring.cuh:Lifted): each value is
// widened on load and put back in T on store, exactly.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "fw_phases.cuh"
#include "minplus_matmul.cuh"

namespace {

// A (rows x cols) operand of graph g: base + g * batch + r * ld + c.
template <class T>
struct View {
  const T* p;
  long long ld, batch;
};

// Four consecutive elements of T at p, the first `live` of them (all four
// for live >= 4) moved and the rest 0 (a load) or left alone (a store):
// one 4-wide move where vec and all four are live, else one at a time.
template <class T>
__device__ __forceinline__ void load4_at(const T* p, Reg<T>* v, bool vec, int live = 4) {
  if (vec && live >= 4) {
    load4(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < live ? widen(p[e]) : Reg<T>(0);
  }
}

template <class T>
__device__ __forceinline__ void store4_at(T* p, const Reg<T>* v, bool vec, int live = 4) {
  if (vec && live >= 4) {
    store4(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < live) put(p[e], v[e]);
  }
}

// N consecutive elements (load_n / store_n, or one at a time).
template <int N, class T>
__device__ __forceinline__ void load_n_at(const T* p, Reg<T>* v, bool vec) {
  if (vec) {
    load_n<N>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = widen(p[e]);
  }
}

template <int N, class T>
__device__ __forceinline__ void store_n_at(T* p, const Reg<T>* v, bool vec) {
  if (vec) {
    store_n<N>(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) put(p[e], v[e]);
  }
}

// --------------------------------------------------------------- closure
// One CTA a graph (blockIdx.z) closes its (S, S) tile on DiagShape<S>'s
// register blocks (close_tile_blocks), as the fused round's diag does:
// thread (ty, tx) holds rows 4ty + 4T·h + e and columns 4tx + 4T·h + e.
template <int S, class Op, class T>
__global__ void __launch_bounds__(DiagShape<S>::kThreads)
closure_kernel(View<T> in, T* __restrict__ out, long long ld_o, long long bs_o, bool vec) {
  using V = Reg<T>;
  constexpr int H = DiagShape<S>::H, TT = DiagShape<S>::T, M = DiagShape<S>::M;
  __shared__ __align__(16) V rowbuf[2][S];
  __shared__ __align__(16) V colbuf[2][S];
  const int ty = threadIdx.x / TT, tx = threadIdx.x % TT;
  const T* src = in.p + blockIdx.z * in.batch;
  T* dst = out + blockIdx.z * bs_o;
  V t[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const long long r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) load4_at(src + r * in.ld + 4 * tx + 4 * TT * q, &t[i][4 * q], vec);
  }
  close_tile_blocks<S, Op>(t, rowbuf, colbuf, ty, tx);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const long long r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) store4_at(dst + r * ld_o + 4 * tx + 4 * TT * q, &t[i][4 * q], vec);
  }
}

// ----------------------------------------------------------------- bands
// Row band (Col false: p[r][c] ⊕= d[r][k] ⊗ p[k][c], the (S, n) band's
// columns) or col band (Col true: q[r][c] ⊕= q[r][k] ⊗ d[k][c], the (n, S)
// band's rows).  Each such chain is independent, so they run on
// close_band_lanes (fw_phases.cuh) as the fused round's bands do: warp v of
// band tile u = blockIdx.x / split owns chains u·S + 16v .. (lane (rg, cg):
// rows rg·S/8 .. of chains 4cg .., the col band's held transposed), with no
// barrier; the tile's S/16 warps are cut into split CTAs (blockIdx.x %
// split), each staging the closed diagonal, lifted, for itself (transposed
// for the row band).  Chains past n load 0 and are never stored; a warp
// that has none of the band's leaves after the staging.
template <int S, bool Col, class Op, class T>
__global__ void __launch_bounds__(2 * S)
band_kernel(View<T> diag, View<T> band, T* __restrict__ out, long long ld_o, long long bs_o,
            int n, int split, bool vec) {
  using V = Reg<T>;
  constexpr int RL = S / 8, DSt = S + 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  V* dS = reinterpret_cast<V*>(dyn_smem);  // S x DSt
  const T* dg = diag.p + blockIdx.z * diag.batch;
  const T* src = band.p + blockIdx.z * band.batch;
  T* dst = out + blockIdx.z * bs_o;
  const int lane = threadIdx.x % 32, rg = lane / 4, cg = lane % 4;
  const int v = (blockIdx.x % split) * (blockDim.x / 32) + threadIdx.x / 32;
  const int x0 = (blockIdx.x / split) * S + 16 * v;  // the warp's first chain
  const int c0 = x0 + 4 * cg, r0 = rg * RL;         // the lane's chains c0 .., rows r0 ..
  const int live = n - c0;                           // of its 4 chains, the first live

  // xr[i][j]: row band p[r0 + i][c0 + j]; col band q[c0 + j][r0 + i].
  V xr[RL][4];
  if constexpr (!Col) {
#pragma unroll
    for (int i = 0; i < RL; ++i) load4_at(src + (r0 + i) * band.ld + c0, xr[i], vec, live);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      V run[RL];
      if (j < live) {
        load_n_at<RL>(src + (long long)(c0 + j) * band.ld + r0, run, vec);
      } else {
#pragma unroll
        for (int i = 0; i < RL; ++i) run[i] = V(0);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) xr[i][j] = run[i];
    }
  }
  // The closed diagonal, lifted: dS[k][r] = d[r][k] for the row band (a
  // warp takes 32 rows, its stores on distinct banks), d[k][c] for the col
  // band (32 groups of a row); four loads a thread in flight (at eight,
  // ptxas spills the s = 32 int16 row band's registers).
#pragma unroll 4
  for (int idx = threadIdx.x; idx < S * S / 4; idx += blockDim.x) {
    const int r = Col ? idx / (S / 4) : idx % S;
    const int c = 4 * (Col ? idx % (S / 4) : idx / S);
    V e4[4];
    load4_at(dg + r * diag.ld + c, e4, vec);
#pragma unroll
    for (int e = 0; e < 4; ++e) e4[e] = Lifted<Op>::lift(e4[e]);
    if constexpr (Col) {
      sts4(dS + r * DSt + c, e4);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dS[(c + e) * DSt + r] = e4[e];
    }
  }
  __syncthreads();
  if (x0 >= n) return;  // none of the band's chains

  close_band_lanes<S, Col, Op>(xr, dS, rg, cg);
  if constexpr (!Col) {
#pragma unroll
    for (int i = 0; i < RL; ++i) store4_at(dst + (r0 + i) * ld_o + c0, xr[i], vec, live);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= live) break;
      V run[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) run[i] = xr[i][j];
      store_n_at<RL>(dst + (long long)(c0 + j) * ld_o + r0, run, vec);
    }
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

// Whether a view meets the 4-wide moves: its base aligned to 4 elements'
// bytes and its row and batch strides whole multiples of 4 elements.
template <class T>
bool aligned4(const T* p, long long ld, long long batch) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0 && ld % 4 == 0 && batch % 4 == 0;
}

template <int S, bool Col, class Op, class T>
int launch_band(View<T> diag, View<T> band, T* out, long long ld_o, long long bs_o, int B,
                int n, bool vec, cudaStream_t st) {
  const int tiles = (n + S - 1) / S;
  int split = 1;
  cudaError_t err = band_split<S>(tiles, B, &split);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)S * (S + 4) * sizeof(Reg<T>);
  if ((err = prepare_phase(band_kernel<S, Col, Op, T>, smem)) != cudaSuccess) return (int)err;
  band_kernel<S, Col, Op, T><<<dim3(tiles * split, 1, B), 2 * S / split, smem, st>>>(
      diag, band, out, ld_o, bs_o, n, split, vec);
  return (int)cudaGetLastError();
}

template <int S, class Op, class T>
int launch_phase(int kind, View<T> diag, View<T> band, T* out, long long ld_o,
                 long long bs_o, int B, int n, cudaStream_t st) {
  // The 4-wide moves where every operand the launch touches meets them.
  bool vec = aligned4(diag.p, diag.ld, diag.batch) && aligned4<T>(out, ld_o, bs_o);
  if (kind == 0) {
    closure_kernel<S, Op, T><<<dim3(1, 1, B), DiagShape<S>::kThreads, 0, st>>>(diag, out, ld_o,
                                                                              bs_o, vec);
    return (int)cudaGetLastError();
  }
  vec = vec && aligned4(band.p, band.ld, band.batch);
  if (kind == 1) return launch_band<S, false, Op, T>(diag, band, out, ld_o, bs_o, B, n, vec, st);
  if (kind == 2) return launch_band<S, true, Op, T>(diag, band, out, ld_o, bs_o, B, n, vec, st);
  return (int)cudaErrorInvalidValue;
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
