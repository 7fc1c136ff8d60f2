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

#include <type_traits>

#include "fw_phases.cuh"
#include "minplus_matmul.cuh"

namespace {

constexpr int kStripRows = 8;  // strips hold a multiple of 8 rows (the panels' lanes: 4 a lane)

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
// strip[r, c] = start(r, c) ⊕ ⊕_k acol[r, k] ⊗ band[k, c], k = 0 .. s-1
// ascending, start = acol in block column b, else the strip; then the strip
// rows whose matrix row lies in block b (rows[r] - b·s in [0, s)) take their
// band row whole.  The strip is relaxed in place (each element is read and
// written by one thread); padding rows (rows[r] == n) are relaxed like the
// others, and rows past a are neither loaded nor stored.  Nothing depends
// on s but the loop count, so one instantiation serves every s.  Two tile
// shapes, picked by the wrapper (fw_repair_del.py:relax_height):
//
//   * long strips, 128 rows a tile: relax_kernel below, on the matmul's
//     mainloop (minplus_matmul.cuh: 128 x 128 tiles, 256 threads of 8 x 8,
//     acol slices through registers and band slices by cp.async, one
//     barrier a slice), A = acol (a x s), B = band (s x n);
//   * short strips, H = 8 or 16 rows a tile: short_relax_kernel, whose
//     grid spreads the band's columns over the card.
//
// Any height computes the same.  fw_repair_del.py:relax_height takes the
// mainloop once its grid of 128 x 128 tiles fills the card, else the short
// tile (by A/B on the H100: a mainloop of 32 CTAs, a = 128 at n = 4096,
// ran 2.1x the short tile's time).

// Where the 4-wide group at strip row r, columns col .. col+3, starts:
// acol in block column b, else the strip (the same for the hops).  s >= 16:
// the group lies in one block.
template <class U>
__device__ __forceinline__ const U* strip_start(const U* strip, const U* acol, int r, int col,
                                                int n, int s, int b) {
  const int c = col - b * s;
  return c >= 0 && c < s ? acol + ((long long)r * s + c) : strip + ((long long)r * n + col);
}

// x, hidden from the compiler: an epilogue that indexes from launder(i0)
// recomputes its addresses instead of keeping the start's live across the
// mainloop (ptxas held them and spilled).
__device__ __forceinline__ int launder(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The 4-wide group v at (r, col) into the strip; local = rows[r] - b·s: a
// strip row inside block b takes its band row, copied as it lies.
template <class T>
__device__ __forceinline__ void put_strip(T* strip, const T* band, int local, const Reg<T>* v,
                                          int r, int col, int n, int s) {
  T* dst = strip + ((long long)r * n + col);
  if (local >= 0 && local < s) {
    *reinterpret_cast<Word4<T>*>(dst) =
        *reinterpret_cast<const Word4<T>*>(band + ((long long)local * n + col));
  } else {
    store4(dst, v);
  }
}

// The same with next hops: ks[e] is the k of element e's last strict
// improvement (kKept: none), whose hop is acol_s[r, k]; where none was, the
// start's hop (strip_s, or acol_s in block column b).  A strip row inside
// block b takes its band and band_s rows.
template <class T>
__device__ __forceinline__ void put_strip_succ(T* strip, int* strip_s, const T* band,
                                               const int* band_s, const int* acol_s, int local,
                                               const float* v, const int* ks, int r, int col,
                                               int n, int s, int b) {
  int* hops = strip_s + ((long long)r * n + col);
  put_strip(strip, band, local, v, r, col, n, s);
  if (local >= 0 && local < s) {
    *reinterpret_cast<int4*>(hops) =
        *reinterpret_cast<const int4*>(band_s + ((long long)local * n + col));
    return;
  }
  int4 hop = *reinterpret_cast<const int4*>(strip_start<int>(strip_s, acol_s, r, col, n, s, b));
  int* e4 = reinterpret_cast<int*>(&hop);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (ks[e] != kKept) e4[e] = acol_s[(long long)r * s + ks[e]];
  *reinterpret_cast<int4*>(hops) = hop;
}

// CTAs an SM the long relax asks of ptxas: two (at most 128 registers a
// thread), except for the 32-bit min / max steps and the saturating int16
// ones, whose 8 x 8 tile spilled at 128 registers (as the fused round's
// relax does; PERF.md): they take one CTA an SM and spill nothing.
template <class Op, class T>
constexpr int kRelaxCtas = (sizeof(T) == 4 && !std::is_same<Op, OrAndPacked>::value) ||
                                   std::is_same<Op, MinPlusI16>::value ||
                                   std::is_same<Op, MaxPlusI16>::value
                               ? 1
                               : 2;

// Long strips: one CTA a 128 x 128 tile of the (a, n) strip, the fused
// round's relax_kernel with the sweep's start and splice.  The sweep's
// buffers always meet the vector staging (fw_repair_del.py checks it).
template <class Op, class T>
__global__ void __launch_bounds__(kThreads, (kRelaxCtas<Op, T>))
relax_kernel(T* strip, const T* __restrict__ band, const T* __restrict__ acol,
             const int* __restrict__ rows, int n, int a, int s, int b) {
  __shared__ Slices<T> sm;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int ty = lane_ty(), tx = lane_tx();
  T pad;
  put(pad, Reg<T>(0));

  Reg<T> acc[8][8];
  for_groups(i0, j0, ty, tx, [&](int i, int h, int r, int col) {
    Reg<T>* v = &acc[i][4 * h];
    if (r < a && col < n) {
      load4(strip_start(strip, acol, r, col, n, s, b), v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = Reg<T>(0);
    }
  });
  const Shape sh{a, n, s, s, 0, n, 0, n, 0, n, 0};
  Stage<T, true> st(acol, band, sh, i0, j0);
  st.load(band, sh, sm.B[0], pad);
  fold_slices(st, band, sh, sm, pad,
              [&](const T* as, const T* bs, int) { fold_k<Op>(acc, as, bs, ty, tx); });
  for_groups(launder(i0), launder(j0), ty, tx, [&](int i, int h, int r, int col) {
    if (r < a && col < n) put_strip(strip, band, rows[r] - b * s, &acc[i][4 * h], r, col, n, s);
  });
}

// Short strips.  A 128-row tile at a = 8 would fold 16 times the strip's
// rows, so the short tile is H = 8 or 16 rows high (in a / H tiles; the
// wrapper picks H) and spreads the band's columns instead: warp w of a CTA
// owns 16 columns, lane (rg, cg) = (lane / 4, lane % 4) the R = H/8 rows
// rg·R .. rg·R + R - 1 by the 4 columns 4cg .. 4cg+3 of them, and a CTA
// holds as many warps (4, 2 or 1, short_warps) as leave at least one CTA
// an SM.  The CTA stages its H x s slice of acol once, transposed and
// widened (As[k][r], row stride H + 4), and the band in kShortBK-deep
// slices of its columns by 16-byte cp.async, two buffers: slice t + 1 is
// in flight while slice t folds.  At step k a lane reads its R rows of
// As[k] (one 4- or 8-byte load) and its 4 band values (one load; the
// warp's 8 row groups read the same 4 addresses), and makes 4R
// relaxations, k ascending.  (Tiles of 32 and 64 rows, which hold a strip
// of 64 rows in fewer CTAs, ran slower: PERF.md.)
constexpr int kShortBK = 16;    // the short tile's slice depth (s is a multiple)
constexpr int kShortCols = 16;  // a warp's columns

template <int H>
struct ShortTile {
  static_assert(H == 8 || H == 16, "a short tile's height");
  static constexpr int R = H / 8;   // rows a lane
  static constexpr int AS = H + 4;  // row stride of the staged acol slice
};

// R consecutive 4-byte values from shared memory (R = 1 or 2).
template <int R, class V>
__device__ __forceinline__ void lds_rows(const V* p, V* v) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else {
    lds_n<R>(p, v);
  }
}

// The short tile's staging and slice loop: fold(av, bv, k) relaxes the
// lane's R x 4 elements at depth k (av its R rows of acol[., k], bv its 4
// columns of band[k, .]), k ascending.  Columns past n load 0 and are
// never stored by the callers, nor are rows past a.
template <int H, class T, class Fold>
__device__ __forceinline__ void short_fold(const T* band, const T* acol, int n, int a, int s,
                                           int i0, int j0, Fold&& fold) {
  using V = Reg<T>;
  using Sh = ShortTile<H>;
  constexpr int kEPC = 16 / sizeof(T);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  V* As = reinterpret_cast<V*>(dyn_smem);         // s x AS
  T* Bs = reinterpret_cast<T*>(As + s * Sh::AS);  // 2 x kShortBK x W
  const int tid = threadIdx.x, threads = blockDim.x;
  const int W = kShortCols * (threads / 32), cpr = W / kEPC;  // columns, chunks a slice row
  const int lane = tid % 32, rg = lane / 4, c0 = kShortCols * (tid / 32) + 4 * (lane % 4);
  auto issue = [&](int k0, T* buf) {
    for (int q = tid; q < kShortBK * cpr; q += threads) {
      const int kk = q / cpr, c = (q % cpr) * kEPC;
      const bool live = j0 + c < n;  // n is a multiple of 16: whole chunks
      cp_async16(buf + kk * W + c, live ? band + ((long long)(k0 + kk) * n + j0 + c) : band,
                 live ? 16 : 0);
    }
    cp_async_commit();
  };
  issue(0, Bs);
  // acol rows i0 .. i0+H-1, four k a load; a warp's 32 lanes take
  // consecutive rows, so that their stores of one k are consecutive
  for (int q = tid; q < H * (s / 4); q += threads) {
    const int r = q % H, k = 4 * (q / H);
    V v[4];
    if (i0 + r < a) {
      load4(acol + ((long long)(i0 + r) * s + k), v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = V(0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) As[(k + e) * Sh::AS + r] = v[e];
  }
  const int slices = s / kShortBK;
  for (int t = 0; t < slices; ++t) {
    const T* cur = Bs + (t & 1) * kShortBK * W;
    if (t + 1 < slices) {
      issue((t + 1) * kShortBK, Bs + ((t + 1) & 1) * kShortBK * W);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice t (and, at t = 0, the acol slice) published
#pragma unroll
    for (int kk = 0; kk < kShortBK; ++kk) {
      const int k = t * kShortBK + kk;
      V av[Sh::R], bv[4];
      lds_rows<Sh::R>(As + (k * Sh::AS + rg * Sh::R), av);
      load4(cur + (kk * W + c0), bv);
      fold(av, bv, k);
    }
    __syncthreads();  // slice t's buffer free for slice t + 2
  }
}

template <int H, class Op, class T>
__global__ void __launch_bounds__(4 * 32)
short_relax_kernel(T* strip, const T* __restrict__ band, const T* __restrict__ acol,
                   const int* __restrict__ rows, int n, int a, int s, int b) {
  using Sh = ShortTile<H>;
  const int i0 = blockIdx.y * H, j0 = blockIdx.x * kShortCols * (blockDim.x / 32);
  const int lane = threadIdx.x % 32, rg = lane / 4;
  const int col = j0 + kShortCols * (threadIdx.x / 32) + 4 * (lane % 4);
  Reg<T> acc[Sh::R][4];
#pragma unroll
  for (int i = 0; i < Sh::R; ++i) {
    const int r = i0 + rg * Sh::R + i;
    if (r < a && col < n) {
      load4(strip_start(strip, acol, r, col, n, s, b), acc[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = Reg<T>(0);
    }
  }
  short_fold<H>(band, acol, n, a, s, i0, j0, [&](const Reg<T>* av, const Reg<T>* bv, int) {
#pragma unroll
    for (int i = 0; i < Sh::R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = Op::relax(acc[i][j], av[i], bv[j]);
  });
  const int ie = launder(i0), ce = launder(col);
#pragma unroll
  for (int i = 0; i < Sh::R; ++i) {
    const int r = ie + rg * Sh::R + i;
    if (r < a && ce < n) put_strip(strip, band, rows[r] - b * s, acc[i], r, ce, n, s);
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

// The successor relax (min-plus, strict <; Op the distance step): the
// fused successor relax's design (fw_round.cuh) on the same two tiles.  An
// element keeps, beside its distance, only the k of its last strict
// improvement (kKept: none), every candidate rounded to the storage before
// its compare (Op::mul) and nothing lifted; after the fold, one gather of
// acol_s[r, k] (put_strip_succ).  No successor slice is staged or read a k.
//
// Long strips: 128 x 64 tiles, 256 threads of 8 x 4, 8-deep slices
// (fold_k_succ, minplus_matmul.cuh).
template <class Op, class T>
__global__ void __launch_bounds__(kThreads, 2)
succ_relax_kernel(T* strip, int* strip_s, const T* __restrict__ band,
                  const int* __restrict__ band_s, const T* __restrict__ acol,
                  const int* __restrict__ acol_s, const int* __restrict__ rows, int n, int a,
                  int s, int b) {
  constexpr int BK = 8;
  __shared__ Slices<T, BK, kSuccCols> sm;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kSuccCols;
  const int ty = lane_ty(), tx = lane_tx();
  T pad;
  put(pad, 0.0f);

  float acc[8][4];
  for_groups<1>(i0, j0, ty, tx, [&](int i, int, int r, int col) {
    if (r < a && col < n) {
      load4(strip_start(strip, acol, r, col, n, s, b), acc[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
  });
  const Shape sh{a, n, s, s, 0, n, 0, n, 0, n, 0};
  Stage<T, true, BK, kSuccCols> st(acol, band, sh, i0, j0);
  st.load(band, sh, sm.B[0], pad);
  int ks[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ks[i][j] = kKept;
  fold_slices(st, band, sh, sm, pad, [&](const T* as, const T* bs, int k) {
    fold_k_succ<Op>(acc, ks, as, bs, ty, tx, k);
  });
  for_groups<1>(launder(i0), launder(j0), ty, tx, [&](int i, int, int r, int col) {
    if (r < a && col < n)
      put_strip_succ(strip, strip_s, band, band_s, acol_s, rows[r] - b * s, acc[i], ks[i], r,
                     col, n, s, b);
  });
}

// Short strips: short_relax_kernel's tile and slices.
template <int H, class Op, class T>
__global__ void __launch_bounds__(4 * 32)
short_succ_relax_kernel(T* strip, int* strip_s, const T* __restrict__ band,
                        const int* __restrict__ band_s, const T* __restrict__ acol,
                        const int* __restrict__ acol_s, const int* __restrict__ rows, int n,
                        int a, int s, int b) {
  using Sh = ShortTile<H>;
  const int i0 = blockIdx.y * H, j0 = blockIdx.x * kShortCols * (blockDim.x / 32);
  const int lane = threadIdx.x % 32, rg = lane / 4;
  const int col = j0 + kShortCols * (threadIdx.x / 32) + 4 * (lane % 4);
  float acc[Sh::R][4];
  int ks[Sh::R][4];
#pragma unroll
  for (int i = 0; i < Sh::R; ++i) {
    const int r = i0 + rg * Sh::R + i;
    if (r < a && col < n) {
      load4(strip_start(strip, acol, r, col, n, s, b), acc[i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) ks[i][e] = kKept;
  }
  short_fold<H>(band, acol, n, a, s, i0, j0, [&](const float* av, const float* bv, int k) {
#pragma unroll
    for (int i = 0; i < Sh::R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cand = Op::mul(av[i], bv[j]);
        const bool better = cand < acc[i][j];
        acc[i][j] = better ? cand : acc[i][j];
        ks[i][j] = better ? k : ks[i][j];
      }
  });
  const int ie = launder(i0), ce = launder(col);
#pragma unroll
  for (int i = 0; i < Sh::R; ++i) {
    const int r = ie + rg * Sh::R + i;
    if (r < a && ce < n)
      put_strip_succ(strip, strip_s, band, band_s, acol_s, rows[r] - b * s, acc[i], ks[i], r,
                     ce, n, s, b);
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

// Phase 0 (diag) or 1 (panels) of either sweep (Succ: the successor
// sweep), one instantiation per s.
template <int S, bool Succ, class Op, class T>
int launch_chain(int phase, const Bufs<T>& x, int n, int a, int b, cudaStream_t st) {
  cudaError_t err;
  if (phase == 0) {
    if constexpr (Succ) {
      succ_diag_kernel<S, Op, T><<<1, DiagShape<S>::kThreads, 0, st>>>(
          x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, n, b);
    } else {
      diag_kernel<S, Op, T><<<1, DiagShape<S>::kThreads, 0, st>>>(x.d_init, x.strip, x.pos,
                                                                   x.band, n, b);
    }
  } else {
    int split, ctas;
    if ((err = panels_grid<S>(n, a, &split, &ctas)) != cudaSuccess) return (int)err;
    const size_t smem = (size_t)S * (S + 4) * sizeof(Reg<T>);
    if constexpr (Succ) {
      if ((err = prepare(succ_panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
      succ_panels_kernel<S, Op, T><<<ctas, 2 * S / split, smem, st>>>(
          x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, x.acol, x.acol_s, n,
          a, b, split);
    } else {
      if ((err = prepare(panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
      panels_kernel<S, Op, T><<<ctas, 2 * S / split, smem, st>>>(x.d_init, x.strip, x.pos,
                                                                 x.band, x.acol, n, a, b, split);
    }
  }
  return (int)cudaGetLastError();
}

int cdiv(int x, int y) { return (x + y - 1) / y; }

// The short relax's warps a CTA: the most of 4, 2, 1 that leaves at least
// one CTA an SM (the fewer a CTA, the more often the acol slice is staged).
cudaError_t short_warps(int n, int tiles, int* warps) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *warps = 4;
  while (*warps > 1 && (long long)cdiv(n, kShortCols * *warps) * tiles < sms) *warps /= 2;
  return err;
}

template <int H, bool Succ, class Op, class T>
int launch_short(const Bufs<T>& x, int n, int a, int s, int b, cudaStream_t st) {
  int warps;
  const int tiles = cdiv(a, H);
  cudaError_t err = short_warps(n, tiles, &warps);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(n, kShortCols * warps), tiles);
  const size_t smem = (size_t)s * ShortTile<H>::AS * sizeof(Reg<T>) +
                      (size_t)2 * kShortBK * kShortCols * warps * sizeof(T);
  if constexpr (Succ) {
    if ((err = prepare(short_succ_relax_kernel<H, Op, T>, smem)) != cudaSuccess) return (int)err;
    short_succ_relax_kernel<H, Op, T><<<grid, 32 * warps, smem, st>>>(
        x.strip, x.strip_s, x.band, x.band_s, x.acol, x.acol_s, x.rows, n, a, s, b);
  } else {
    if ((err = prepare(short_relax_kernel<H, Op, T>, smem)) != cudaSuccess) return (int)err;
    short_relax_kernel<H, Op, T><<<grid, 32 * warps, smem, st>>>(x.strip, x.band, x.acol,
                                                                 x.rows, n, a, s, b);
  }
  return (int)cudaGetLastError();
}

// Phase 2 (relax) of either sweep on the tile of height h: 8 or 16 (the
// short tile), or kTile (the mainloop's); one instantiation per height,
// whatever s.
template <bool Succ, class Op, class T>
int launch_relax(const Bufs<T>& x, int n, int a, int s, int b, int h, cudaStream_t st) {
  switch (h) {
    case 8: return launch_short<8, Succ, Op>(x, n, a, s, b, st);
    case 16: return launch_short<16, Succ, Op>(x, n, a, s, b, st);
    case kTile:
      if constexpr (Succ) {
        succ_relax_kernel<Op, T><<<dim3(cdiv(n, kSuccCols), cdiv(a, kTile)), kThreads, 0, st>>>(
            x.strip, x.strip_s, x.band, x.band_s, x.acol, x.acol_s, x.rows, n, a, s, b);
      } else {
        relax_kernel<Op, T><<<dim3(cdiv(n, kTile), cdiv(a, kTile)), kThreads, 0, st>>>(
            x.strip, x.band, x.acol, x.rows, n, a, s, b);
      }
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Phase 0, 1 or 2 of round b of either sweep; h the relax's tile height.
template <bool Succ, class Op, class T>
int dispatch_sweep(int phase, const Bufs<T>& x, int n, int a, int s, int b, int h,
                   cudaStream_t st) {
  if (phase == 2) return launch_relax<Succ, Op>(x, n, a, s, b, h, st);
  switch (s) {
    case 16: return launch_chain<16, Succ, Op>(phase, x, n, a, b, st);
    case 32: return launch_chain<32, Succ, Op>(phase, x, n, a, b, st);
    case 64: return launch_chain<64, Succ, Op>(phase, x, n, a, b, st);
    case 128: return launch_chain<128, Succ, Op>(phase, x, n, a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int phase, int n, int a, int s, int b) {
  return phase < 0 || phase > 2 || s < 16 || s > 128 || (s & (s - 1)) || n < s || n % s || a < kStripRows ||
         a % kStripRows || b < 0 || b >= n / s;
}

}  // namespace
