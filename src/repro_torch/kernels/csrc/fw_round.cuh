// The kernels of the fused pivot round (diag, bands, relax) and of the
// successor round, templated on the storage type T of w and of the band
// buffers: fw_round.cu instantiates them for f32 (square and bordered),
// fw_round_lowered.cu for bf16, f16, int16 and packed int32 words.  What the
// launches do and why is in fw_round.cu; the diag and bands chains are in
// fw_phases.cuh, the relax kernels run on the mainloop of
// minplus_matmul.cuh, the steps are semiring.cuh's.  Registers hold V =
// float (f32, bf16, f16) or int (int16, packed): each value is widened from
// T on load and put back in T on store, exactly.
#pragma once

#include <cuda_runtime.h>

#include "fw_phases.cuh"
#include "minplus_matmul.cuh"

namespace {

// ------------------------------------------------------------------ diag
// One CTA a graph closes the pivot tile on DiagShape<S>'s register blocks
// (close_tile_blocks, fw_phases.cuh): thread (ty, tx) holds rows 4ty + 4T·h
// + e and columns 4tx + 4T·h + e of the tile.  The closed tile goes to
// block b of both band buffers, and to the owner-echo blocks pc / pr.
template <int S, class Op, class T>
__global__ void __launch_bounds__(DiagShape<S>::kThreads)
diag_kernel(const T* __restrict__ w, T* __restrict__ rowband, T* __restrict__ colband,
            int rows, int cols, int b, int pr, int pc) {
  using V = Reg<T>;
  constexpr int H = DiagShape<S>::H, TT = DiagShape<S>::T, M = DiagShape<S>::M;
  __shared__ __align__(16) V rowbuf[2][S];
  __shared__ __align__(16) V colbuf[2][S];
  const int ty = threadIdx.x / TT, tx = threadIdx.x % TT;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const T* wg = w + g * rows * cols;
  V t[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) load4(wg + (o + r) * cols + o + 4 * tx + 4 * TT * q, &t[i][4 * q]);
  }
  close_tile_blocks<S, Op>(t, rowbuf, colbuf, ty, tx);
  T* rb = rowband + g * S * cols;
  T* cb = colband + g * rows * S;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const int c = 4 * tx + 4 * TT * q;
      store4(rb + r * cols + o + c, &t[i][4 * q]);
      store4(cb + (o + r) * S + c, &t[i][4 * q]);
      if (pc >= 0) store4(rb + r * cols + (size_t)pc * S + c, &t[i][4 * q]);
      if (pr >= 0) store4(cb + ((size_t)pr * S + r) * S + c, &t[i][4 * q]);
    }
  }
}

// ----------------------------------------------------------------- bands
// Tile u = blockIdx.x / split < tc-1: row tile (b, j); otherwise col tile
// (i, b); j, i skip b.  The owner-echo tiles (j == pc, i == pr) already
// hold the closed corner (diag launch) and return at once.  A tile's S
// chains (its columns, or its rows) are independent: warp v of the tile
// owns 16 of them (close_band_lanes, fw_phases.cuh) and runs them with no
// barrier, and the tile's S/16 warps are cut into split CTAs
// (blockIdx.x % split), each staging the closed diagonal (rowband's block
// b, its operands lifted) in shared memory for itself, so that a launch of
// few tiles still fills the card.
template <int S, class Op, class T>
__global__ void __launch_bounds__(2 * S)
bands_kernel(const T* __restrict__ w, T* __restrict__ rowband, T* __restrict__ colband,
             int rows, int cols, int b, int pr, int pc, int split) {
  using V = Reg<T>;
  constexpr int RL = S / 8, DSt = S + 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  V* dS = reinterpret_cast<V*>(dyn_smem);  // S x DSt
  const int TC = cols / S;
  const int u = blockIdx.x / split;
  const bool is_row = u < TC - 1;
  int x = is_row ? u : u - (TC - 1);
  x = x < b ? x : x + 1;
  if (x == (is_row ? pc : pr)) return;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S, xo = (size_t)x * S;
  const T* wg = w + g * rows * cols;
  T* rb = rowband + g * S * cols;
  T* cb = colband + g * rows * S;
  const int lane = threadIdx.x % 32, rg = lane / 4, cg = lane % 4;
  const int v = (blockIdx.x % split) * (blockDim.x / 32) + threadIdx.x / 32;
  const int r0 = rg * RL, c0 = 16 * v + 4 * cg;  // the lane's block: rows r0.., columns c0..

  // xr[i][j]: row panel p[r0 + i][c0 + j] = w[o + r0 + i][xo + c0 + j];
  // col panel q[c0 + j][r0 + i] = w[xo + c0 + j][o + r0 + i].
  V xr[RL][4];
  if (is_row) {
#pragma unroll
    for (int i = 0; i < RL; ++i) load4(wg + (o + r0 + i) * cols + xo + c0, xr[i]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      V run[RL];
      load_n<RL>(wg + (xo + c0 + j) * cols + o + r0, run);
#pragma unroll
      for (int i = 0; i < RL; ++i) xr[i][j] = run[i];
    }
  }
  // The closed diagonal, lifted (Lifted<Op>): 4 elements of a row a load,
  // eight loads a thread in flight; a warp takes 32 rows of the transposed
  // copy (its stores then fall on distinct banks), 32 groups of a row of
  // the other.
#pragma unroll 8
  for (int idx = threadIdx.x; idx < S * S / 4; idx += blockDim.x) {
    const int r = is_row ? idx % S : idx / (S / 4);
    const int c = 4 * (is_row ? idx / S : idx % (S / 4));
    V e4[4];
    load4(rb + (size_t)r * cols + o + c, e4);
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
    for (int i = 0; i < RL; ++i) store4(rb + (size_t)(r0 + i) * cols + xo + c0, xr[i]);
  } else {
    close_band_lanes<S, true, Op>(xr, dS, rg, cg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      V run[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) run[i] = xr[i][j];
      store_n<RL>(cb + (xo + c0 + j) * S + r0, run);
    }
  }
}

// ----------------------------------------------------------------- relax
// Where the 4-wide group at row r, columns col .. col+3 of a round starts:
// the row band in row block b (or the owner echo pr), else the col band in
// column block b (or pc), else w; the same for the successor buffers.  For
// s >= 16 the four columns lie in one column block.  ls = log2(s).
template <class U>
__device__ __forceinline__ const U* start_of(const U* w, const U* rb, const U* cb, int r,
                                             int col, int cols, int ls, int b, int pr, int pc) {
  const int rblk = r >> ls, cblk = col >> ls;
  if (rblk == b || rblk == pr) return rb + ((r - (rblk << ls)) * cols + col);
  if (cblk == b || cblk == pc) return cb + ((r << ls) + col - (cblk << ls));
  return w + ((long long)r * cols + col);
}

// Whether the tile at t0 (a row or column offset; at most 128 wide) meets
// block blk (-1: none).
__device__ __forceinline__ bool meets(int t0, int s, int blk) {
  return blk >= 0 && blk * s < t0 + kTile && (blk + 1) * s > t0;
}

// The thread's 8 x C tile from start(r, c): a tile that meets no band block
// (most of them) loads w as the matmul loads C, the others pick each
// group's source by start_of.  Rows and columns past the block (whole
// groups: rows and cols are multiples of s) start from 0 and are never
// stored.  The relax kernels issue it before their first slice, so its
// addresses are dead before the slice's prefetch registers are live; the
// loads of both are in flight together all the same.
template <int C = 8, class T, class V>
__device__ __forceinline__ void start_tile(V (&acc)[8][C], const T* w, const T* rb,
                                           const T* cb, int rows, int cols, int s, int b,
                                           int pr, int pc, int i0, int j0, int ty, int tx) {
  const bool banded = meets(i0, s, b) || meets(i0, s, pr) || meets(j0, s, b) || meets(j0, s, pc);
  const int ls = __ffs(s) - 1;
  for_groups<C / 4>(i0, j0, ty, tx, [&](int i, int h, int r, int col) {
    V* v = &acc[i][4 * h];
    if (r >= rows || col >= cols) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = V(0);
    } else if (!banded) {
      load4(w + ((long long)r * cols + col), v);
    } else {
      load4(start_of(w, rb, cb, r, col, cols, ls, b, pr, pc), v);
    }
  });
}

// The relax of round b: w[r, c] = start(r, c) ⊕ ⊕_k colband[r, k] ⊗
// rowband[k, c], k = 0 .. s-1 ascending, on matmul_kernel's mainloop: one
// CTA a 128 x 128 output tile of (rows, cols), A = colband (lda s), B =
// rowband (ldb cols), C and out = w in place (each element is read by the
// thread that writes it, before it writes it).  Only the C load differs
// from the matmul's: each group starts from start_of.  The tile does not
// depend on s (k = s, a whole number of slices at run time).  The round's
// buffers always meet the vector staging (fw_round.py checks it).
template <class Op, class T>
__global__ void __launch_bounds__(kThreads, 2)
relax_kernel(T* w, const T* __restrict__ rowband, const T* __restrict__ colband, int rows,
             int cols, int s, int b, int pr, int pc) {
  __shared__ Slices<T> sm;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int ty = lane_ty(), tx = lane_tx();
  const long long g = blockIdx.z, rc = (long long)rows * cols;
  T pad;
  put(pad, Reg<T>(0));

  Reg<T> acc[8][8];
  start_tile(acc, w + g * rc, rowband + g * s * cols, colband + g * s * rows, rows, cols, s, b,
             pr, pc, i0, j0, ty, tx);

  const Shape sh{rows, cols, s, s, 0, cols, 0, cols, 0, cols, 0};
  Stage<T, true> st(colband + g * s * rows, rowband + g * s * cols, sh, i0, j0);
  st.load(rowband, sh, sm.B[0], pad);
  fold_slices(st, rowband, sh, sm, pad,
              [&](const T* as, const T* bs, int) { fold_k<Op>(acc, as, bs, ty, tx); });
  store_tile<true>(w + g * rc, cols, rows, cols, i0, j0, ty, tx, acc);
}

// ------------------------------------------------------- successor round
// Same three launches carrying an int32 next-hop tile beside each distance
// tile (min-plus only); Op is the distance step (StrictMinPlus in f32,
// MinPlusH<R> in bf16 / f16).  The diag and bands run the fused round's
// layouts through the successor bodies of fw_phases.cuh
// (close_tile_blocks_succ, close_band_lanes_succ), which round every
// candidate to the storage before its strict compare and lift nothing.
//
// diag: one CTA a graph on DiagShape<S>'s register blocks, thread (ty, tx)
// holding an M x M block of distances and one of next hops; the closed
// tile and its hops go to block b of the four band buffers.
template <int S, class Op, class T>
__global__ void __launch_bounds__(DiagShape<S>::kThreads)
succ_diag_kernel(const T* __restrict__ w, const int* __restrict__ succ,
                 T* __restrict__ rw, T* __restrict__ cw,
                 int* __restrict__ rs, int* __restrict__ cs, int n, int b) {
  constexpr int H = DiagShape<S>::H, TT = DiagShape<S>::T, M = DiagShape<S>::M;
  __shared__ __align__(16) float rowbuf[2][S];
  __shared__ __align__(16) float colbuf[2][S];
  __shared__ __align__(16) int colsbuf[2][S];
  const int ty = threadIdx.x / TT, tx = threadIdx.x % TT;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const T* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  float t[M][M];
  int ts[M][M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t at = (o + 4 * ty + 4 * TT * (i / 4) + i % 4) * n + o + 4 * tx;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      load4(wg + at + 4 * TT * q, &t[i][4 * q]);
      load4(sg + at + 4 * TT * q, &ts[i][4 * q]);
    }
  }
  close_tile_blocks_succ<S, Op>(t, ts, rowbuf, colbuf, colsbuf, ty, tx);
  T* rwg = rw + g * S * n;
  int* rsg = rs + g * S * n;
  T* cwg = cw + g * n * S;
  int* csg = cs + g * n * S;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const size_t r = 4 * ty + 4 * TT * (i / 4) + i % 4;
#pragma unroll
    for (int q = 0; q < H; ++q) {
      const int c = 4 * tx + 4 * TT * q;
      store4(rwg + r * n + o + c, &t[i][4 * q]);
      store4(rsg + r * n + o + c, &ts[i][4 * q]);
      store4(cwg + (o + r) * S + c, &t[i][4 * q]);
      store4(csg + (o + r) * S + c, &ts[i][4 * q]);
    }
  }
}

// bands: tile u = blockIdx.x / split < T-1 is row tile (b, x), else col
// tile (x, b), x skipping b, as bands_kernel: warp v of the tile owns 16 of
// its chains, lane (rg, cg) rows r0 = rg·S/8 .. by columns c0 = 16v + 4cg ..
// (the col tile transposed), and each of the split CTAs stages the closed
// diagonal's distances (rw block b) for itself.  The col lanes carry their
// hops; the row lanes keep the k of each element's last improvement and
// gather ds[r][k] (rs block b, written by the diag launch) after the chain,
// or keep the start's hop.
template <int S, class Op, class T>
__global__ void __launch_bounds__(2 * S)
succ_bands_kernel(const T* __restrict__ w, const int* __restrict__ succ,
                  T* __restrict__ rw, T* __restrict__ cw,
                  int* __restrict__ rs, int* __restrict__ cs, int n, int b, int split) {
  constexpr int RL = S / 8, DSt = S + 4;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  float* dS = reinterpret_cast<float*>(dyn_smem);  // S x DSt
  const int TT = n / S;
  const int u = blockIdx.x / split;
  const bool is_row = u < TT - 1;
  int x = is_row ? u : u - (TT - 1);
  x = x < b ? x : x + 1;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S, xo = (size_t)x * S;
  const T* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  T* rwg = rw + g * S * n;
  int* rsg = rs + g * S * n;
  T* cwg = cw + g * n * S;
  int* csg = cs + g * n * S;
  const int lane = threadIdx.x % 32, rg = lane / 4, cg = lane % 4;
  const int v = (blockIdx.x % split) * (blockDim.x / 32) + threadIdx.x / 32;
  const int r0 = rg * RL, c0 = 16 * v + 4 * cg;

  // xr[i][j]: row panel p[r0 + i][c0 + j] (xs: the k of its last
  // improvement); col panel q[c0 + j][r0 + i] (xs: its hop).
  float xr[RL][4];
  int xs[RL][4];
  if (is_row) {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      load4(wg + (o + r0 + i) * n + xo + c0, xr[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) xs[i][j] = kKept;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float run[RL];
      int runs[RL];
      load_n<RL>(wg + (xo + c0 + j) * n + o + r0, run);
      load_n<RL>(sg + (xo + c0 + j) * n + o + r0, runs);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        xr[i][j] = run[i];
        xs[i][j] = runs[i];
      }
    }
  }
  // The closed diagonal's distances, as bands_kernel stages them
  // (transposed for the row panel), not lifted.
#pragma unroll 8
  for (int idx = threadIdx.x; idx < S * S / 4; idx += blockDim.x) {
    const int r = is_row ? idx % S : idx / (S / 4);
    const int c = 4 * (is_row ? idx / S : idx % (S / 4));
    float e4[4];
    load4(rwg + (size_t)r * n + o + c, e4);
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
      load4(sg + (o + r) * n + xo + c0, hop);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (xs[i][j] != kKept) hop[j] = rsg[r * n + o + xs[i][j]];
      store4(rwg + r * n + xo + c0, xr[i]);
      store4(rsg + r * n + xo + c0, hop);
    }
  } else {
    close_band_lanes_succ<S, true, Op>(xr, xs, dS, rg, cg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float run[RL];
      int runs[RL];
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        run[i] = xr[i][j];
        runs[i] = xs[i][j];
      }
      store_n<RL>(cwg + (xo + c0 + j) * S + r0, run);
      store_n<RL>(csg + (xo + c0 + j) * S + r0, runs);
    }
  }
}

// The relax of the successor round (min-plus; Op the distance step:
// StrictMinPlus in f32, MinPlusH<R> in bf16 / f16) on the same mainloop.
// The next hop of an element is the a-side hop cs[r, k] of the last k whose
// candidate was strictly smaller than the running distance, or the start's
// where none was.  So a thread keeps, beside each distance, only that k
// (kKept = none), and gathers cs[r, k] once after the fold: no successor
// slice is staged or read per k.  A relaxation is then a compare and two
// selects (distance, k), the fewest that strict < allows: a k packed a
// byte an element would free registers but take a second instruction to
// insert it.  So the thread tile is 8 x 4 (64 registers of distances and
// k), on a 128 x 64 output tile, 8-deep slices (fold_k_succ,
// minplus_matmul.cuh, which the successor sweep's relax runs too).
template <class Op, class T>
__global__ void __launch_bounds__(kThreads, 2)
succ_relax_kernel(T* w, int* succ, const T* __restrict__ rw, const T* __restrict__ cw,
                  const int* __restrict__ rs, const int* __restrict__ cs, int n, int s, int b) {
  constexpr int BK = 8;
  __shared__ Slices<T, BK, kSuccCols> sm;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kSuccCols;
  const int ty = lane_ty(), tx = lane_tx();
  const long long nn = (long long)n * n, sn = (long long)s * n, g = blockIdx.z;
  T pad;
  put(pad, 0.0f);

  float acc[8][4];
  start_tile<4>(acc, w + g * nn, rw + g * sn, cw + g * sn, n, n, s, b, -1, -1, i0, j0, ty, tx);

  const Shape sh{n, n, s, s, 0, n, 0, n, 0, n, 0};
  Stage<T, true, BK, kSuccCols> st(cw + g * sn, rw + g * sn, sh, i0, j0);
  st.load(rw, sh, sm.B[0], pad);
  int ks[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ks[i][j] = kKept;
  fold_slices(st, rw, sh, sm, pad, [&](const T* as, const T* bs, int k) {
    fold_k_succ<Op>(acc, ks, as, bs, ty, tx, k);
  });
  store_tile<true, 4>(w + g * nn, n, n, n, i0, j0, ty, tx, acc);

  // The next hops: the start's where no k improved, else cs[r, k].
  succ += g * nn;
  rs += g * sn;
  cs += g * sn;
  const int ls = __ffs(s) - 1;
  const bool banded = meets(i0, s, b) || meets(j0, s, b);
  for_groups<1>(i0, j0, ty, tx, [&](int i, int, int r, int col) {
    if (r >= n || col >= n) return;
    const int* from = banded ? start_of<int>(succ, rs, cs, r, col, n, ls, b, -1, -1)
                             : succ + ((long long)r * n + col);
    int4 hop = *reinterpret_cast<const int4*>(from);
    int* e4 = reinterpret_cast<int*>(&hop);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ks[i][e] != kKept) e4[e] = cs[(r << ls) + ks[i][e]];
    *reinterpret_cast<int4*>(succ + (long long)r * n + col) = hop;
  });
}

// ------------------------------------------------------------- launching
constexpr size_t kDefaultSmem = 48 * 1024;

template <class K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Phase 0 (diag) or 1 (bands): the chains, one instantiation per s.
template <int S, class Op, class T>
int launch_chain(int phase, T* w, T* rb, T* cb, int B, int rows, int cols, int b, int pr,
                 int pc, cudaStream_t st) {
  const int TR = rows / S, TC = cols / S;
  if (phase == 0) {
    diag_kernel<S, Op, T><<<dim3(1, 1, B), DiagShape<S>::kThreads, 0, st>>>(w, rb, cb, rows,
                                                                           cols, b, pr, pc);
  } else {
    const int tiles = (TC - 1) + (TR - 1);
    int split = 1;
    cudaError_t err = band_split<S>(tiles, B, &split);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)S * (S + 4) * sizeof(Reg<T>);
    err = prepare(bands_kernel<S, Op, T>, smem);
    if (err != cudaSuccess) return (int)err;
    bands_kernel<S, Op, T><<<dim3(tiles * split, 1, B), 2 * S / split, smem, st>>>(
        w, rb, cb, rows, cols, b, pr, pc, split);
  }
  return (int)cudaGetLastError();
}

template <class Op, class T>
int dispatch_s(int phase, T* w, T* rb, T* cb, int B, int rows, int cols, int s, int b,
               int pr, int pc, cudaStream_t st) {
  if (s != 16 && s != 32 && s != 64 && s != 128) return (int)cudaErrorInvalidValue;
  switch (phase) {
    case 2:
      relax_kernel<Op, T><<<dim3((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, B),
                            kThreads, 0, st>>>(w, rb, cb, rows, cols, s, b, pr, pc);
      return (int)cudaGetLastError();
    case 0:
    case 1:
      switch (s) {
        case 16: return launch_chain<16, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, st);
        case 32: return launch_chain<32, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, st);
        case 64: return launch_chain<64, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, st);
        case 128: return launch_chain<128, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, st);
      }
  }
  return (int)cudaErrorInvalidValue;
}

template <int S, class Op, class T>
int launch_succ_chain(int phase, T* w, int* su, T* rw, T* cw, int* rs, int* cs, int B, int n,
                      int b, cudaStream_t st) {
  if (phase == 0) {
    succ_diag_kernel<S, Op, T><<<dim3(1, 1, B), DiagShape<S>::kThreads, 0, st>>>(
        w, su, rw, cw, rs, cs, n, b);
  } else {
    const int tiles = 2 * (n / S - 1);
    int split = 1;
    cudaError_t err = band_split<S>(tiles, B, &split);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)S * (S + 4) * sizeof(float);
    err = prepare(succ_bands_kernel<S, Op, T>, smem);
    if (err != cudaSuccess) return (int)err;
    succ_bands_kernel<S, Op, T><<<dim3(tiles * split, 1, B), 2 * S / split, smem, st>>>(
        w, su, rw, cw, rs, cs, n, b, split);
  }
  return (int)cudaGetLastError();
}

template <class Op, class T>
int dispatch_succ(int phase, void* w, void* succ, void* rw, void* cw, void* rs, void* cs,
                  int B, int n, int s, int b, cudaStream_t st) {
  T* pw = static_cast<T*>(w);
  int* su = static_cast<int*>(succ);
  T* prw = static_cast<T*>(rw);
  T* pcw = static_cast<T*>(cw);
  int* prs = static_cast<int*>(rs);
  int* pcs = static_cast<int*>(cs);
  if (s != 16 && s != 32 && s != 64 && s != 128) return (int)cudaErrorInvalidValue;
  switch (phase) {
    case 2:
      succ_relax_kernel<Op, T><<<dim3((n + kSuccCols - 1) / kSuccCols, (n + kTile - 1) / kTile,
                                      B),
                                 kThreads, 0, st>>>(pw, su, prw, pcw, prs, pcs, n, s, b);
      return (int)cudaGetLastError();
    case 0:
    case 1:
      switch (s) {
        case 16: return launch_succ_chain<16, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
        case 32: return launch_succ_chain<32, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
        case 64: return launch_succ_chain<64, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
        case 128:
          return launch_succ_chain<128, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
      }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
