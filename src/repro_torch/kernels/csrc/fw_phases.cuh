// The per-thread chains of the blocked Floyd-Warshall phases, shared by
// fw_round.cu (the full round's diag and bands) and fw_repair_del.cu (the
// restricted sweep).
// The kernels differ only in where their tiles come from and go to: each
// loads its registers and stages its closed diagonal, calls one of these
// bodies, and stores the result.
//
// Closure chains (diag, row and col panels) run on 8·S threads; thread
// (rg, c) = (tid / S, tid % S) owns rows rg + 8m of column c in t[].  The
// tile updates in place, so step k's operands (row k and column k as they
// stood at the start of step k) are published by their owners into a
// double-buffered shared vector before a barrier and read after it: one
// __syncthreads per step, k ascending.  The closed diagonal d is S x DS in
// shared memory (DS = S + 1, a padded row stride).  A caller syncs after
// staging d and before the chain.
//
// relax_chunk is the sweep's strip relax inner loop (fw_repair_del.cuh;
// the fused round's relax runs on the matmul's mainloop instead): thread
// (ty, tx) owns rows ty + TY·m and columns tx + 16q, and relaxes them over
// one bk-deep chunk staged in shared memory, k ascending.  As is rows x bk
// with row stride bk + 1, Bs is bk x S.
//
// The _succ forms carry an int32 next hop beside each distance and take a
// candidate only where it is strictly smaller (relax_succ, min-plus).
//
// Every chain is generic over the register type V (float or int) and the
// storage type T of its shared-memory operands (float, __nv_bfloat16,
// __half, short, int), both deduced from the arguments: shared operands
// cross through widen() / put() of semiring.cuh, which are exact.
#pragma once

#include "semiring.cuh"

namespace {

// _close_diag: t[r][c] ⊕= t[r][k] ⊗ t[k][c].
template <int S, class Op, class V, class T>
__device__ __forceinline__ void close_tile_chain(V (&t)[S / 8], T (*rowbuf)[S],
                                                 T (*colbuf)[S], int rg, int c) {
  constexpr int R = S / 8;
#pragma unroll
  for (int kb = 0; kb < R; ++kb) {
    for (int kk = 0; kk < 8; ++kk) {
      const int k = kb * 8 + kk, p = k & 1;
      if (rg == kk) put(rowbuf[p][c], t[kb]);
      if (c == k) {
#pragma unroll
        for (int m = 0; m < R; ++m) put(colbuf[p][rg + 8 * m], t[m]);
      }
      __syncthreads();
      const V bj = widen(rowbuf[p][c]);
#pragma unroll
      for (int m = 0; m < R; ++m) t[m] = Op::relax(t[m], widen(colbuf[p][rg + 8 * m]), bj);
    }
  }
}

// _close_row_panel: p[r][c] ⊕= d[r][k] ⊗ p[k][c].
template <int S, class Op, class V, class T>
__device__ __forceinline__ void close_row_chain(V (&t)[S / 8], const T* d,
                                                T (*buf)[S], int rg, int c) {
  constexpr int R = S / 8, DS = S + 1;
#pragma unroll
  for (int kb = 0; kb < R; ++kb) {
    for (int kk = 0; kk < 8; ++kk) {
      const int k = kb * 8 + kk, p = k & 1;
      if (rg == kk) put(buf[p][c], t[kb]);
      __syncthreads();
      const V bj = widen(buf[p][c]);
#pragma unroll
      for (int m = 0; m < R; ++m) t[m] = Op::relax(t[m], widen(d[(rg + 8 * m) * DS + k]), bj);
    }
  }
}

// _close_col_panel on 8·RA rows: p[r][c] ⊕= p[r][k] ⊗ d[k][c].
template <int S, int RA, class Op, class V, class T>
__device__ __forceinline__ void close_col_chain(V (&t)[RA], const T* d,
                                                T (*buf)[S], int rg, int c) {
  constexpr int DS = S + 1;
  for (int k = 0; k < S; ++k) {
    const int p = k & 1;
    if (c == k) {
#pragma unroll
      for (int m = 0; m < RA; ++m) put(buf[p][rg + 8 * m], t[m]);
    }
    __syncthreads();
    const V bj = widen(d[k * DS + c]);
#pragma unroll
    for (int m = 0; m < RA; ++m) t[m] = Op::relax(t[m], widen(buf[p][rg + 8 * m]), bj);
  }
}

// _relax_tile over one staged chunk.
template <int S, int RM, int TY, class Op, class V, class T>
__device__ __forceinline__ void relax_chunk(V (&acc)[RM][S / 16], const T* As,
                                            const T* Bs, int bk, int ty, int tx) {
  constexpr int CM = S / 16;
  for (int kk = 0; kk < bk; ++kk) {
    V a[RM], bv[CM];
#pragma unroll
    for (int m = 0; m < RM; ++m) a[m] = widen(As[(ty + TY * m) * (bk + 1) + kk]);
#pragma unroll
    for (int q = 0; q < CM; ++q) bv[q] = widen(Bs[kk * S + tx + 16 * q]);
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int q = 0; q < CM; ++q) acc[m][q] = Op::relax(acc[m][q], a[m], bv[q]);
  }
}

// ------------------------------------------------------------- successors
// The a-side next hop: diag the tile's own column k, row panel the closed
// diagonal's successor tile ds, col panel the tile's own column k, the
// sweep's relax the staged successor slice ASs.  Op is the distance step of relax_succ
// (StrictMinPlus in f32, MinPlusH<R> in bf16 / f16).
template <int S, class Op = StrictMinPlus, class T>
__device__ __forceinline__ void close_tile_chain_succ(float (&t)[S / 8], int (&ts)[S / 8],
                                                      T (*rowbuf)[S], T (*colbuf)[S],
                                                      int (*colsbuf)[S], int rg, int c) {
  constexpr int R = S / 8;
#pragma unroll
  for (int kb = 0; kb < R; ++kb) {
    for (int kk = 0; kk < 8; ++kk) {
      const int k = kb * 8 + kk, p = k & 1;
      if (rg == kk) put(rowbuf[p][c], t[kb]);
      if (c == k) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          put(colbuf[p][rg + 8 * m], t[m]);
          colsbuf[p][rg + 8 * m] = ts[m];
        }
      }
      __syncthreads();
      const float bj = widen(rowbuf[p][c]);
#pragma unroll
      for (int m = 0; m < R; ++m)
        relax_succ<Op>(t[m], ts[m], widen(colbuf[p][rg + 8 * m]), colsbuf[p][rg + 8 * m], bj);
    }
  }
}

template <int S, class Op = StrictMinPlus, class T>
__device__ __forceinline__ void close_row_chain_succ(float (&t)[S / 8], int (&ts)[S / 8],
                                                     const T* d, const int* ds,
                                                     T (*buf)[S], int rg, int c) {
  constexpr int R = S / 8, DS = S + 1;
#pragma unroll
  for (int kb = 0; kb < R; ++kb) {
    for (int kk = 0; kk < 8; ++kk) {
      const int k = kb * 8 + kk, p = k & 1;
      if (rg == kk) put(buf[p][c], t[kb]);
      __syncthreads();
      const float bj = widen(buf[p][c]);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const int r = rg + 8 * m;
        relax_succ<Op>(t[m], ts[m], widen(d[r * DS + k]), ds[r * DS + k], bj);
      }
    }
  }
}

template <int S, int RA, class Op = StrictMinPlus, class T>
__device__ __forceinline__ void close_col_chain_succ(float (&t)[RA], int (&ts)[RA],
                                                     const T* d, T (*buf)[S],
                                                     int (*sbuf)[S], int rg, int c) {
  constexpr int DS = S + 1;
  for (int k = 0; k < S; ++k) {
    const int p = k & 1;
    if (c == k) {
#pragma unroll
      for (int m = 0; m < RA; ++m) {
        put(buf[p][rg + 8 * m], t[m]);
        sbuf[p][rg + 8 * m] = ts[m];
      }
    }
    __syncthreads();
    const float bj = widen(d[k * DS + c]);
#pragma unroll
    for (int m = 0; m < RA; ++m)
      relax_succ<Op>(t[m], ts[m], widen(buf[p][rg + 8 * m]), sbuf[p][rg + 8 * m], bj);
  }
}

template <int S, int RM, int TY, class Op = StrictMinPlus, class T>
__device__ __forceinline__ void relax_chunk_succ(float (&acc)[RM][S / 16], int (&sacc)[RM][S / 16],
                                                 const T* As, const int* ASs,
                                                 const T* Bs, int bk, int ty, int tx) {
  constexpr int CM = S / 16;
  for (int kk = 0; kk < bk; ++kk) {
    float a[RM], bv[CM];
    int as[RM];
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      a[m] = widen(As[(ty + TY * m) * (bk + 1) + kk]);
      as[m] = ASs[(ty + TY * m) * (bk + 1) + kk];
    }
#pragma unroll
    for (int q = 0; q < CM; ++q) bv[q] = widen(Bs[kk * S + tx + 16 * q]);
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int q = 0; q < CM; ++q) relax_succ<Op>(acc[m][q], sacc[m][q], a[m], as[m], bv[q]);
  }
}

}  // namespace
