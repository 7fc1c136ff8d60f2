// The kernels of the restricted row sweep (diag, panels, relax) and of the
// successor sweep, templated on the storage type T of d_init, the strip,
// the band and acol: fw_repair_del.cu instantiates them for f32,
// fw_repair_del_lowered.cu for bf16, f16, int16, packed int32 words and
// the int32 carrier of an integer or_and storage.  What the launches do and
// why is in fw_repair_del.cu; the per-thread chains are in fw_phases.cuh,
// the steps in semiring.cuh.  Registers hold V = Reg<T>: each value is
// widened from T on load and put back in T on store, exactly.
#pragma once

#include <cuda_runtime.h>

#include "fw_phases.cuh"
#include "minplus_matmul.cuh"

namespace {

constexpr int kStripRows = 8;                   // the strip tile's height
constexpr int kRelaxThreads = kStripRows * 16;  // thread (ty, tx): row ty, cols tx + 16q

// Row r of round b's overlaid band (o = b·s): a strip row or a d_init row.
template <class T>
__device__ __forceinline__ const T* band_row(const T* d_init, const T* strip, const int* pos,
                                             size_t o, int r, int n) {
  const int p = pos[o + r];
  return p >= 0 ? strip + (size_t)p * n : d_init + (o + r) * n;
}

// ------------------------------------------------------------------ diag
// One CTA closes the overlaid pivot tile on DiagShape<S>'s register blocks
// (close_tile_blocks, fw_phases.cuh), as the fused round's diag does:
// thread (ty, tx) loads rows 4ty + 4T·h + e of the overlay (band_row), at
// columns 4tx + 4T·h + e, four elements a load, and stores its closed
// blocks into band block b.
template <int S, class Op, class T>
__global__ void __launch_bounds__(DiagShape<S>::kThreads)
diag_kernel(const T* __restrict__ d_init, const T* __restrict__ strip,
            const int* __restrict__ pos, T* __restrict__ band, int n, int b) {
  using V = Reg<T>;
  constexpr int H = DiagShape<S>::H, TT = DiagShape<S>::T, M = DiagShape<S>::M;
  __shared__ __align__(16) V rowbuf[2][S];
  __shared__ __align__(16) V colbuf[2][S];
  const int ty = threadIdx.x / TT, tx = threadIdx.x % TT;
  const size_t o = (size_t)b * S;
  V t[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const T* row = band_row(d_init, strip, pos, o, 4 * ty + 4 * TT * (i / 4) + i % 4, n) + o;
#pragma unroll
    for (int q = 0; q < H; ++q) load4(row + 4 * tx + 4 * TT * q, &t[i][4 * q]);
  }
  close_tile_blocks<S, Op>(t, rowbuf, colbuf, ty, tx);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) store4(band + r * n + o + 4 * tx + 4 * TT * q, &t[i][4 * q]);
  }
}

// ---------------------------------------------------------------- panels
// Every chain of the launch is independent: a column of a band tile (a row
// panel), or a row of the strip's block column b (a col panel).  So they
// run on close_band_lanes (fw_phases.cuh), a warp owning 16 of them with no
// barrier, as the fused round's bands do; every CTA stages the closed
// diagonal (band block b, its operands lifted) in shared memory for itself.
// CTA u = blockIdx.x / split < T-1 holds warps (blockIdx.x % split)·W ..
// of band tile x (u, skipping b), rows of the overlay (band_row); the CTAs
// after them hold 16·W strip rows each, W = blockDim.x / 32 warps, a lane
// 4 of them (the col panel's transpose), into acol.  Strip rows past a
// (the last CTA's, at most 16·W - 8 of them) load 0 and are never stored;
// a warp that has none of the strip's rows leaves after the staging.
//
// PanelLane is a thread's place in that grid (the successor panels share
// it).
template <int S>
struct PanelLane {
  bool is_row;  // a band tile's row lane, else a strip col lane
  size_t xo;    // the band tile's column offset
  int rg, cg;   // lane / 4, lane % 4
  int r0;       // the lane's rows (row panel), columns (col panel)
  int c0;       // the lane's columns (row panel), strip rows (col panel)
  bool live;    // a row lane, or a col lane holding strip rows
  bool warp_live;  // its warp holds some of the strip's rows (or is a row warp)

  __device__ __forceinline__ PanelLane(int n, int a, int b, int split) {
    const int tiles = (n / S - 1) * split;  // the band's CTAs
    const int lane = threadIdx.x % 32, warps = blockDim.x / 32, wv = threadIdx.x / 32;
    is_row = (int)blockIdx.x < tiles;
    rg = lane / 4;
    cg = lane % 4;
    r0 = rg * (S / 8);
    xo = 0;
    if (is_row) {
      const int u = blockIdx.x / split;
      xo = (size_t)(u < b ? u : u + 1) * S;
      c0 = 16 * ((blockIdx.x % split) * warps + wv) + 4 * cg;
    } else {
      c0 = 16 * (((int)blockIdx.x - tiles) * warps + wv) + 4 * cg;
    }
    live = is_row || c0 < a;  // a % 8 == 0: a lane's 4 rows all or none
    warp_live = is_row || c0 - 4 * cg < a;  // the warp's first row
  }
};

template <int S, class Op, class T>
__global__ void __launch_bounds__(2 * S)
panels_kernel(const T* __restrict__ d_init, const T* __restrict__ strip,
              const int* __restrict__ pos, T* __restrict__ band, T* __restrict__ acol, int n,
              int a, int b, int split) {
  using V = Reg<T>;
  constexpr int RL = S / 8, DSt = S + 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  V* dS = reinterpret_cast<V*>(dyn_smem);  // S x DSt
  const size_t o = (size_t)b * S;
  const PanelLane<S> L(n, a, b, split);
  const bool is_row = L.is_row, live = L.live;
  const int rg = L.rg, cg = L.cg, r0 = L.r0, c0 = L.c0;
  const size_t xo = L.xo;

  // xr[i][j]: row panel p[r0 + i][c0 + j] = overlay[r0 + i][xo + c0 + j];
  // col panel q[c0 + j][r0 + i] = strip[c0 + j][o + r0 + i].
  V xr[RL][4];
  if (is_row) {
#pragma unroll
    for (int i = 0; i < RL; ++i)
      load4(band_row(d_init, strip, pos, o, r0 + i, n) + xo + c0, xr[i]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      V run[RL];
      if (live) {
        load_n<RL>(strip + (size_t)(c0 + j) * n + o + r0, run);
      } else {
#pragma unroll
        for (int i = 0; i < RL; ++i) run[i] = V(0);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) xr[i][j] = run[i];
    }
  }
  // The closed diagonal, lifted, as bands_kernel stages it: transposed for
  // the row panels (dS[k][r] = d[r][k]), as it lies for the strip's.
#pragma unroll 8
  for (int idx = threadIdx.x; idx < S * S / 4; idx += blockDim.x) {
    const int r = is_row ? idx % S : idx / (S / 4);
    const int c = 4 * (is_row ? idx / S : idx % (S / 4));
    V e4[4];
    load4(band + (size_t)r * n + o + c, e4);
#pragma unroll
    for (int e = 0; e < 4; ++e) e4[e] = Lifted<Op>::lift(e4[e]);
    if (is_row) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dS[(c + e) * DSt + r] = e4[e];
    } else {
      sts4(dS + r * DSt + c, e4);
    }
  }
  __syncthreads();

  if (is_row) {
    close_band_lanes<S, false, Op>(xr, dS, rg, cg);
#pragma unroll
    for (int i = 0; i < RL; ++i) store4(band + (size_t)(r0 + i) * n + xo + c0, xr[i]);
  } else if (L.warp_live) {
    close_band_lanes<S, true, Op>(xr, dS, rg, cg);
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        V run[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) run[i] = xr[i][j];
        store_n<RL>(acol + (size_t)(c0 + j) * S + r0, run);
      }
    }
  }
}

// ----------------------------------------------------------------- relax
// One CTA per (8, S) strip tile (ti, tj); thread (ty, tx) owns row ty and
// columns tx + 16q.  Shared memory: acol slice (8 x bk, row stride bk+1),
// band slice (bk x S).
template <int S, class Op, class T>
__global__ void __launch_bounds__(kRelaxThreads)
relax_kernel(T* __restrict__ strip, const T* __restrict__ band, const T* __restrict__ acol,
             const int* __restrict__ rows, int n, int b, int bk) {
  constexpr int CM = S / 16;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* As = reinterpret_cast<T*>(dyn_smem);  // 8 x (bk + 1)
  T* Bs = As + kStripRows * (bk + 1);      // bk x S
  const int TT = n / S;
  const int ti = blockIdx.x / TT, tj = blockIdx.x % TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t r = (size_t)ti * kStripRows + ty, c0 = (size_t)tj * S;

  Reg<T> acc[1][CM];
#pragma unroll
  for (int q = 0; q < CM; ++q)
    acc[0][q] = widen(tj == b ? acol[r * S + tx + 16 * q] : strip[r * n + c0 + tx + 16 * q]);

  for (int k0 = 0; k0 < S; k0 += bk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kStripRows * bk; idx += kRelaxThreads) {
      const int rr = idx / bk, kk = idx % bk;
      As[rr * (bk + 1) + kk] = acol[((size_t)ti * kStripRows + rr) * S + k0 + kk];
    }
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int kk = idx / S, cc = idx % S;
      Bs[kk * S + cc] = band[(size_t)(k0 + kk) * n + c0 + cc];
    }
    __syncthreads();
    relax_chunk<S, 1, kStripRows, Op>(acc, As, Bs, bk, ty, tx);
  }
  const int local = rows[r] - b * S;  // strip rows inside block b take band rows
  const bool in_blk = local >= 0 && local < S;
#pragma unroll
  for (int q = 0; q < CM; ++q) {
    const size_t j = c0 + tx + 16 * q;
    if (in_blk)
      strip[r * n + j] = band[(size_t)local * n + j];
    else
      put(strip[r * n + j], acc[0][q]);
  }
}

// ------------------------------------------------------- successor sweep
// The same three launches carrying an int32 next-hop twin of every buffer
// (min-plus, strict <; Op the distance step: StrictMinPlus in f32,
// MinPlusH<R> in bf16 / f16).  The diag and panels run the grid and loads
// of diag_kernel / panels_kernel through the successor round's bodies
// (close_tile_blocks_succ, close_band_lanes_succ, fw_phases.cuh), which
// round every candidate to the storage before its strict compare and lift
// nothing.
//
// diag: thread (ty, tx) loads its M x M block of the overlay's distances
// and its M x M block of next hops (band_row of d_init / strip and of
// s_init / strip_s), four elements a load, and stores both closed blocks
// into block b of band / band_s.
template <int S, class Op, class T>
__global__ void __launch_bounds__(DiagShape<S>::kThreads)
succ_diag_kernel(const T* __restrict__ d_init, const int* __restrict__ s_init,
                 const T* __restrict__ strip, const int* __restrict__ strip_s,
                 const int* __restrict__ pos, T* __restrict__ band, int* __restrict__ band_s,
                 int n, int b) {
  constexpr int H = DiagShape<S>::H, TT = DiagShape<S>::T, M = DiagShape<S>::M;
  __shared__ __align__(16) float rowbuf[2][S];
  __shared__ __align__(16) float colbuf[2][S];
  __shared__ __align__(16) int colsbuf[2][S];
  const int ty = threadIdx.x / TT, tx = threadIdx.x % TT;
  const size_t o = (size_t)b * S;
  float t[M][M];
  int ts[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int r = 4 * ty + 4 * TT * (i / 4) + i % 4;
    const T* row = band_row(d_init, strip, pos, o, r, n) + o;
    const int* hops = band_row(s_init, strip_s, pos, o, r, n) + o;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      load4(row + 4 * tx + 4 * TT * q, &t[i][4 * q]);
      load4(hops + 4 * tx + 4 * TT * q, &ts[i][4 * q]);
    }
  }
  close_tile_blocks_succ<S, Op>(t, ts, rowbuf, colbuf, colsbuf, ty, tx);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t at = (size_t)(4 * ty + 4 * TT * (i / 4) + i % 4) * n + o;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      store4(band + at + 4 * tx + 4 * TT * q, &t[i][4 * q]);
      store4(band_s + at + 4 * tx + 4 * TT * q, &ts[i][4 * q]);
    }
  }
}

// panels: panels_kernel's grid (band tile CTAs, then strip CTAs of 16·W
// rows) on close_band_lanes_succ.  Every CTA stages the closed diagonal's
// distances (band block b, not lifted), S x (S + 4) floats, transposed for
// the row panels; no hop tile.  A col lane (the strip's block column)
// carries each strip row's hops and shuffles them with its values.  A row
// lane keeps the k of each element's last strict improvement (kKept: none)
// and, after the chain, gathers the closed diagonal's hop band_s[r][o + k]
// (written by the diag launch), or keeps the overlay's start hop.  The
// launch holds one CTA an SM (band_split), so the bounds say so: with the
// thread count alone ptxas capped s = 32 at 64 registers and spilled.
template <int S, class Op, class T>
__global__ void __launch_bounds__(2 * S, 1)
succ_panels_kernel(const T* __restrict__ d_init, const int* __restrict__ s_init,
                   const T* __restrict__ strip, const int* __restrict__ strip_s,
                   const int* __restrict__ pos, T* __restrict__ band, int* __restrict__ band_s,
                   T* __restrict__ acol, int* __restrict__ acol_s, int n, int a, int b,
                   int split) {
  constexpr int RL = S / 8, DSt = S + 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* dS = reinterpret_cast<float*>(dyn_smem);  // S x DSt
  const size_t o = (size_t)b * S;
  const PanelLane<S> L(n, a, b, split);
  const bool is_row = L.is_row, live = L.live;
  const int rg = L.rg, cg = L.cg, r0 = L.r0, c0 = L.c0;
  const size_t xo = L.xo;

  // xr[i][j]: row panel p[r0 + i][c0 + j] (xs: the k of its last
  // improvement); col panel q[c0 + j][r0 + i] = strip[c0 + j][o + r0 + i]
  // (xs: its hop).
  float xr[RL][4];
  int xs[RL][4];
  if (is_row) {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      load4(band_row(d_init, strip, pos, o, r0 + i, n) + xo + c0, xr[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[i][j] = kKept;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float run[RL];
      int runs[RL];
      if (live) {
        load_n<RL>(strip + (size_t)(c0 + j) * n + o + r0, run);
        load_n<RL>(strip_s + (size_t)(c0 + j) * n + o + r0, runs);
      } else {
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          run[i] = 0.0f;
          runs[i] = 0;
        }
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        xr[i][j] = run[i];
        xs[i][j] = runs[i];
      }
    }
  }
#pragma unroll 8
  for (int idx = threadIdx.x; idx < S * S / 4; idx += blockDim.x) {
    const int r = is_row ? idx % S : idx / (S / 4);
    const int c = 4 * (is_row ? idx / S : idx % (S / 4));
    float e4[4];
    load4(band + (size_t)r * n + o + c, e4);
    if (is_row) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dS[(c + e) * DSt + r] = e4[e];
    } else {
      sts4(dS + r * DSt + c, e4);
    }
  }
  __syncthreads();

  if (is_row) {
    close_band_lanes_succ<S, false, Op>(xr, xs, dS, rg, cg);
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const size_t r = r0 + i;
      int hop[4];
      load4(band_row(s_init, strip_s, pos, o, r0 + i, n) + xo + c0, hop);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (xs[i][j] != kKept) hop[j] = band_s[r * n + o + xs[i][j]];
      store4(band + r * n + xo + c0, xr[i]);
      store4(band_s + r * n + xo + c0, hop);
    }
  } else if (L.warp_live) {
    close_band_lanes_succ<S, true, Op>(xr, xs, dS, rg, cg);
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float run[RL];
        int runs[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          run[i] = xr[i][j];
          runs[i] = xs[i][j];
        }
        store_n<RL>(acol + (size_t)(c0 + j) * S + r0, run);
        store_n<RL>(acol_s + (size_t)(c0 + j) * S + r0, runs);
      }
    }
  }
}

template <int S, class Op, class T>
__global__ void __launch_bounds__(kRelaxThreads)
succ_relax_kernel(T* __restrict__ strip, int* __restrict__ strip_s, const T* __restrict__ band,
                  const int* __restrict__ band_s, const T* __restrict__ acol,
                  const int* __restrict__ acol_s, const int* __restrict__ rows, int n, int b,
                  int bk) {
  constexpr int CM = S / 16;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* ASs = reinterpret_cast<int*>(dyn_smem);             // 8 x (bk + 1) successors
  T* As = reinterpret_cast<T*>(ASs + kStripRows * (bk + 1));  // 8 x (bk + 1)
  T* Bs = As + kStripRows * (bk + 1);                       // bk x S
  const int TT = n / S;
  const int ti = blockIdx.x / TT, tj = blockIdx.x % TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t r = (size_t)ti * kStripRows + ty, c0 = (size_t)tj * S;

  float acc[1][CM];
  int sacc[1][CM];
#pragma unroll
  for (int q = 0; q < CM; ++q) {
    const int cc = tx + 16 * q;
    acc[0][q] = widen(tj == b ? acol[r * S + cc] : strip[r * n + c0 + cc]);
    sacc[0][q] = tj == b ? acol_s[r * S + cc] : strip_s[r * n + c0 + cc];
  }

  for (int k0 = 0; k0 < S; k0 += bk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kStripRows * bk; idx += kRelaxThreads) {
      const int rr = idx / bk, kk = idx % bk;
      const size_t at = ((size_t)ti * kStripRows + rr) * S + k0 + kk;
      As[rr * (bk + 1) + kk] = acol[at];
      ASs[rr * (bk + 1) + kk] = acol_s[at];
    }
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int kk = idx / S, cc = idx % S;
      Bs[kk * S + cc] = band[(size_t)(k0 + kk) * n + c0 + cc];
    }
    __syncthreads();
    relax_chunk_succ<S, 1, kStripRows, Op>(acc, sacc, As, ASs, Bs, bk, ty, tx);
  }
  const int local = rows[r] - b * S;
  const bool in_blk = local >= 0 && local < S;
#pragma unroll
  for (int q = 0; q < CM; ++q) {
    const size_t j = c0 + tx + 16 * q;
    if (in_blk)
      strip[r * n + j] = band[(size_t)local * n + j];
    else
      put(strip[r * n + j], acc[0][q]);
    strip_s[r * n + j] = in_blk ? band_s[(size_t)local * n + j] : sacc[0][q];
  }
}

// ------------------------------------------------------------- launching
constexpr size_t kDefaultSmem = 48 * 1024;

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <class T>
struct Bufs {  // one sweep's device buffers (see the entry points)
  const T* d_init;
  const int* s_init;
  const int* pos;
  const int* rows;
  T* strip;
  int* strip_s;
  T* band;
  int* band_s;
  T* acol;
  int* acol_s;
};

template <class T>
Bufs<T> bufs(const void* d_init, const void* s_init, const void* pos, const void* rows,
             void* strip, void* strip_s, void* band, void* band_s, void* acol, void* acol_s) {
  return Bufs<T>{static_cast<const T*>(d_init), static_cast<const int*>(s_init),
                 static_cast<const int*>(pos),  static_cast<const int*>(rows),
                 static_cast<T*>(strip),        static_cast<int*>(strip_s),
                 static_cast<T*>(band),         static_cast<int*>(band_s),
                 static_cast<T*>(acol),         static_cast<int*>(acol_s)};
}

// The panels' grid (either sweep): the band's T-1 tiles and the strip's
// a / S (rounded up) cut into split CTAs each, a CTA holding S / split strip
// rows; ctas in all.
template <int S>
cudaError_t panels_grid(int n, int a, int* split, int* ctas) {
  const cudaError_t err = band_split<S>(n / S - 1 + (a + S - 1) / S, 1, split);
  *ctas = (n / S - 1) * *split + (a * *split + S - 1) / S;
  return err;
}

template <int S, class Op, class T>
int launch_sweep(int phase, const Bufs<T>& x, int n, int a, int b, int bk, cudaStream_t st) {
  const int TT = n / S, A = a / kStripRows;
  cudaError_t err;
  if (phase == 0) {
    diag_kernel<S, Op, T><<<1, DiagShape<S>::kThreads, 0, st>>>(x.d_init, x.strip, x.pos,
                                                                 x.band, n, b);
  } else if (phase == 1) {
    int split, ctas;
    if ((err = panels_grid<S>(n, a, &split, &ctas)) != cudaSuccess) return (int)err;
    const size_t smem = (size_t)S * (S + 4) * sizeof(Reg<T>);
    if ((err = prepare(panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    panels_kernel<S, Op, T><<<ctas, 2 * S / split, smem, st>>>(x.d_init, x.strip, x.pos,
                                                               x.band, x.acol, n, a, b, split);
  } else {
    const size_t smem = ((size_t)kStripRows * (bk + 1) + (size_t)bk * S) * sizeof(T);
    if ((err = prepare(relax_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    relax_kernel<S, Op, T><<<A * TT, kRelaxThreads, smem, st>>>(x.strip, x.band, x.acol, x.rows,
                                                                n, b, bk);
  }
  return (int)cudaGetLastError();
}

template <int S, class Op, class T>
int launch_succ(int phase, const Bufs<T>& x, int n, int a, int b, cudaStream_t st) {
  const int TT = n / S, A = a / kStripRows;
  const int bk = S < 32 ? S : 32;
  cudaError_t err;
  if (phase == 0) {
    succ_diag_kernel<S, Op, T><<<1, DiagShape<S>::kThreads, 0, st>>>(
        x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, n, b);
  } else if (phase == 1) {
    int split, ctas;
    if ((err = panels_grid<S>(n, a, &split, &ctas)) != cudaSuccess) return (int)err;
    const size_t smem = (size_t)S * (S + 4) * sizeof(float);
    if ((err = prepare(succ_panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    succ_panels_kernel<S, Op, T><<<ctas, 2 * S / split, smem, st>>>(
        x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, x.acol, x.acol_s, n,
        a, b, split);
  } else {
    const size_t smem = (size_t)kStripRows * (bk + 1) * (sizeof(int) + sizeof(T)) +
                        (size_t)bk * S * sizeof(T);
    if ((err = prepare(succ_relax_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    succ_relax_kernel<S, Op, T><<<A * TT, kRelaxThreads, smem, st>>>(
        x.strip, x.strip_s, x.band, x.band_s, x.acol, x.acol_s, x.rows, n, b, bk);
  }
  return (int)cudaGetLastError();
}

template <class Op, class T>
int dispatch_sweep(int phase, const Bufs<T>& x, int n, int a, int s, int b, int bk,
                   cudaStream_t st) {
  switch (s) {
    case 16: return launch_sweep<16, Op>(phase, x, n, a, b, bk, st);
    case 32: return launch_sweep<32, Op>(phase, x, n, a, b, bk, st);
    case 64: return launch_sweep<64, Op>(phase, x, n, a, b, bk, st);
    case 128: return launch_sweep<128, Op>(phase, x, n, a, b, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <class Op, class T>
int dispatch_sweep_succ(int phase, const Bufs<T>& x, int n, int a, int s, int b,
                        cudaStream_t st) {
  switch (s) {
    case 16: return launch_succ<16, Op>(phase, x, n, a, b, st);
    case 32: return launch_succ<32, Op>(phase, x, n, a, b, st);
    case 64: return launch_succ<64, Op>(phase, x, n, a, b, st);
    case 128: return launch_succ<128, Op>(phase, x, n, a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int phase, int n, int a, int s, int b) {
  return phase < 0 || phase > 2 || s < 16 || n < s || n % s || a < kStripRows ||
         a % kStripRows || b < 0 || b >= n / s;
}

}  // namespace
