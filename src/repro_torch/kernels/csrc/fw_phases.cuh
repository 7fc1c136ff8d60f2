// The per-thread chains of the blocked Floyd-Warshall phases, shared by
// fw_round.cuh (the fused round's diag and bands, and its successor
// round), fw_phase.cuh (the 4-dispatch closure and bands) and
// fw_repair_del.cuh (the restricted sweep and its successor sweep).
// The kernels differ only in where their tiles come from and go to: each
// loads its registers and stages its closed diagonal, calls one of these
// bodies, and stores the result.
//
// Register-block chains (the fused round's diag and bands, the 4-dispatch
// closure and bands, the sweep's diag and panels).  The diag,
// close_tile_blocks: DiagShape<S>::T x T threads, thread (ty, tx) holding
// an M x M block (M = 4H) in 4-wide groups interleaved across the threads
// (rows 4ty + 4T·h + e, columns 4tx + 4T·h + e, h < H, e < 4), so that a
// warp's 16-byte shared loads of one vector fall on distinct banks.  Step
// k's row and column (as they stood at the start of step k) are written by
// their owners into double-buffered shared vectors as 16-byte stores, then
// one barrier, then each thread reads its M + M operands as 16-byte loads
// and does its M·M relaxations.  k = 4T·h + 4·t + e is unrolled over h and
// e, so the owner's register index (4h + e) and the buffer (e & 1) are
// constants; the loop over t is not, which keeps the code to 4H steps.
// The bands, close_band_lanes: each column of a row panel (and each row of
// a col panel) is an independent chain, so a warp owns 16 whole columns
// (rows) and needs no barrier.  Lane (rg, cg) = (lane / 4, lane % 4) holds
// S/8 consecutive rows by 4 columns of the panel, the col panel's
// transposed (x[i][j] = q[c0 + j][r0 + i]).  At step k it takes p[k][c]
// (q[r][k]) by __shfl_sync from the lane holding row k, before any lane
// updates it, and its S/8 operands d[r][k] (d[k][c]) as 16-byte loads from
// the closed diagonal staged in shared memory, transposed for the row
// panel (dS[k][r] = d[r][k]) and as it lies for the col panel, with row
// stride S + 4.  k = (S/8)·kb + kk is unrolled over kk: the register index
// kk is a constant, the source lane 4kb + cg a register.  Both chains keep
// their values lifted (semiring.cuh:Lifted: each operand lifted once, the
// published vectors, the staged diagonal and each shuffled value), which
// takes int16's sentinel tests and the 16-bit min-plus / max-plus round
// out of the relaxation.
//
// The successor chains carry an int32 next hop beside each distance and
// take a candidate only where it is strictly smaller (relax_succ,
// min-plus), its sum rounded to the storage first, nothing lifted.  The
// successor round's (close_tile_blocks_succ, close_band_lanes_succ) run on
// the layouts above: the diag's owners publish column k's hops beside its
// distances, the col lanes shuffle each hop with its value, and the row
// lanes keep the k of each element's last improvement in place of a hop.
// The successor sweep's diag and panels (fw_repair_del.cuh) run the same
// two bodies.
//
// Every chain is generic over the register type V (float or int) and the
// storage type T of its shared-memory operands (float, __nv_bfloat16,
// __half, short, int), both deduced from the arguments: shared operands
// cross through widen() / put() of semiring.cuh, which are exact.  The
// register-block chains keep their shared operands in V, widened once.
#pragma once

#include <cstring>

#include "semiring.cuh"

namespace {

// ------------------------------------------------- register-block chains
// N consecutive 4-byte values between shared memory and registers: 16-byte
// moves (8-byte for N = 2), at addresses aligned to them.
template <int N, class V>
__device__ __forceinline__ void lds_n(const V* p, V* v) {
  static_assert(sizeof(V) == 4 && (N % 4 == 0 || N == 2), "4-byte values, whole moves");
  if constexpr (N == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(v, &u, 8);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      memcpy(v + 4 * q, &u, 16);
    }
  }
}

template <class V>
__device__ __forceinline__ void sts4(V* p, const V* v) {
  uint4 u;
  memcpy(&u, v, 16);
  *reinterpret_cast<uint4*>(p) = u;
}

template <int S>
struct DiagShape {
  static constexpr int H = S == 128 ? 2 : 1;  // 4-wide groups a thread, each way
  static constexpr int T = S / (4 * H);       // threads each way
  static constexpr int M = 4 * H;             // elements a thread, each way
  static constexpr int kThreads = T * T;      // 256, 256, 64, 16 at S = 128 .. 16
};

// _close_diag: t[r][c] ⊕= t[r][k] ⊗ t[k][c] on DiagShape<S>'s blocks.
template <int S, class Op, class V>
__device__ __forceinline__ void close_tile_blocks(V (&t)[DiagShape<S>::M][DiagShape<S>::M],
                                                  V (*rowbuf)[S], V (*colbuf)[S], int ty,
                                                  int tx) {
  constexpr int H = DiagShape<S>::H, T = DiagShape<S>::T, M = DiagShape<S>::M;
  constexpr int kThreads = DiagShape<S>::kThreads;
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll 1
    for (int tk = 0; tk < T; ++tk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 4 * h + e, p = e & 1;  // k = 4T·h + 4·tk + e
        if (ty == tk) {
          V row[M];
#pragma unroll
          for (int j = 0; j < M; ++j) row[j] = Lifted<Op>::lift(t[m][j]);
#pragma unroll
          for (int q = 0; q < H; ++q) sts4(&rowbuf[p][4 * tx + 4 * T * q], &row[4 * q]);
        }
        if (tx == tk) {
          V col[M];
#pragma unroll
          for (int i = 0; i < M; ++i) col[i] = Lifted<Op>::lift(t[i][m]);
#pragma unroll
          for (int q = 0; q < H; ++q) sts4(&colbuf[p][4 * ty + 4 * T * q], &col[4 * q]);
        }
        if constexpr (kThreads <= 32) {
          __syncwarp(kThreads == 32 ? 0xffffffffu : (1u << kThreads) - 1);
        } else {
          __syncthreads();
        }
        V rv[M], cv[M];
#pragma unroll
        for (int q = 0; q < H; ++q) {
          lds_n<4>(&rowbuf[p][4 * tx + 4 * T * q], &rv[4 * q]);
          lds_n<4>(&colbuf[p][4 * ty + 4 * T * q], &cv[4 * q]);
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) t[i][j] = Lifted<Op>::relax(t[i][j], cv[i], rv[j]);
      }
    }
  }
}

// _close_row_panel (Col false: p[r][c] ⊕= d[r][k] ⊗ p[k][c]) or
// _close_col_panel (Col true: q[r][c] ⊕= q[r][k] ⊗ d[k][c], on the
// transpose x = q^T) of the lane's S/8 x 4 block; dS the staged diagonal,
// lifted (Lifted<Op>).
template <int S, bool Col, class Op, class V>
__device__ __forceinline__ void close_band_lanes(V (&x)[S / 8][4], const V* dS, int rg,
                                                 int cg) {
  constexpr int RL = S / 8, DSt = S + 4;
#pragma unroll 1
  for (int kb = 0; kb < 8; ++kb) {
    const int src = 4 * kb + cg;
    const V* drow = dS + kb * RL * DSt + rg * RL;
#pragma unroll
    for (int kk = 0; kk < RL; ++kk) {
      V sh[4], dv[RL];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sh[j] = Lifted<Op>::lift(__shfl_sync(0xffffffffu, x[kk][j], src));
      lds_n<RL>(drow + kk * DSt, dv);
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[i][j] = Col ? Lifted<Op>::relax(x[i][j], sh[j], dv[i])
                        : Lifted<Op>::relax(x[i][j], dv[i], sh[j]);
    }
  }
}

// CTAs a band tile of close_band_lanes is cut into (the fused round's
// bands, the 4-dispatch bands, the sweep's panels): the most of 1, 2 or 4 (at most its S/16
// warps) that keeps the launch within one CTA an SM, so that a launch of
// few tiles (n = 4096, a rank's bordered block, the sweep's T - 1 band
// tiles at n = 8192) spreads over the card.
template <int S>
cudaError_t band_split(int tiles, int B, int* split) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *split = 1;
  while (2 * *split <= (S / 16 < 4 ? S / 16 : 4) && (long long)tiles * B * 2 * *split <= sms)
    *split *= 2;
  return err;
}

// ------------------------------------------------------------- successors
// The chains of the successor round and of the successor sweep, on the
// same register blocks and band lanes.
// Each distance carries an int32 next hop, and every relaxation is
// relax_succ<Op>: cand = Op::mul(a, b), rounded to the storage before the
// compare, taken only where cand < t (NaN never is).  Nothing is lifted:
// the strict compare of an unrounded sum can take a candidate that rounds
// to the current distance, which the reference keeps.  Op is StrictMinPlus
// in f32, MinPlusH<R> in bf16 / f16.

// _close_diag with next hops, on DiagShape<S>'s blocks: ts[i][j] is the hop
// of t[i][j].  The a-side hop is the tile's own column k as it stood at the
// start of step k, so its owners publish it beside the column's distances.
template <int S, class Op>
__device__ __forceinline__ void close_tile_blocks_succ(
    float (&t)[DiagShape<S>::M][DiagShape<S>::M], int (&ts)[DiagShape<S>::M][DiagShape<S>::M],
    float (*rowbuf)[S], float (*colbuf)[S], int (*colsbuf)[S], int ty, int tx) {
  constexpr int H = DiagShape<S>::H, T = DiagShape<S>::T, M = DiagShape<S>::M;
  constexpr int kThreads = DiagShape<S>::kThreads;
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll 1
    for (int tk = 0; tk < T; ++tk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 4 * h + e, p = e & 1;  // k = 4T·h + 4·tk + e
        if (ty == tk) {
#pragma unroll
          for (int q = 0; q < H; ++q) sts4(&rowbuf[p][4 * tx + 4 * T * q], &t[m][4 * q]);
        }
        if (tx == tk) {
          float col[M];
          int cols[M];
#pragma unroll
          for (int i = 0; i < M; ++i) {
            col[i] = t[i][m];
            cols[i] = ts[i][m];
          }
#pragma unroll
          for (int q = 0; q < H; ++q) {
            sts4(&colbuf[p][4 * ty + 4 * T * q], &col[4 * q]);
            sts4(&colsbuf[p][4 * ty + 4 * T * q], &cols[4 * q]);
          }
        }
        if constexpr (kThreads <= 32) {
          __syncwarp(kThreads == 32 ? 0xffffffffu : (1u << kThreads) - 1);
        } else {
          __syncthreads();
        }
        float rv[M], cv[M];
        int cs[M];
#pragma unroll
        for (int q = 0; q < H; ++q) {
          lds_n<4>(&rowbuf[p][4 * tx + 4 * T * q], &rv[4 * q]);
          lds_n<4>(&colbuf[p][4 * ty + 4 * T * q], &cv[4 * q]);
          lds_n<4>(&colsbuf[p][4 * ty + 4 * T * q], &cs[4 * q]);
        }
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int j = 0; j < M; ++j) relax_succ<Op>(t[i][j], ts[i][j], cv[i], cs[i], rv[j]);
      }
    }
  }
}

// The k of no strict improvement (the successor row lanes, the successor
// relax).
constexpr int kKept = -1;

// close_band_lanes with next hops; dS the staged closed diagonal's
// distances.  Col panel (Col true, on x = q^T, xs = qs^T): the a-side is
// the band's own evolving column k, so each step shuffles both q[r][k] and
// its hop from the owner lane before any lane updates them.  Row panel: the
// a-side hop is the closed diagonal's ds[r][k], which the panel does not
// change, so an element's hop is ds[r][k] of the last k that improved it,
// or its start's: xs keeps that k (kKept at the start: the caller's) and
// the kernel gathers ds[r][k] once after the chain.  That stages no hop
// tile (the diagonal's distances alone: S·(S+4)·4 B) and reads none a step.
// A loop body is KU = min(S/8, 4) steps, not S/8.  On the H100, a body of
// 16 steps of 64 successor relaxations a lane (S = 128: ~100 KB of SASS in
// bf16 / f16, 64 KB in f32) ran at either of two speeds, 1.8× apart, by
// where the launch's buffers lay; 8 steps a body ran at the faster one, and
// 4 faster still where a tile is cut in two (one warp a scheduler), for
// the S/8/KU - 1 selects a value that pick the owner's register.
template <int S, bool Col, class Op>
__device__ __forceinline__ void close_band_lanes_succ(float (&x)[S / 8][4], int (&xs)[S / 8][4],
                                                      const float* dS, int rg, int cg) {
  constexpr int RL = S / 8, DSt = S + 4;
  constexpr int KU = RL > 4 ? 4 : RL;  // steps a loop body
#pragma unroll 1
  for (int kb = 0; kb < S / KU; ++kb) {  // k = KU·kb + kk
    const int src = 4 * (kb * KU / RL) + cg;
    // the owner's register is x[kk + KU·q], q = kb % (RL / KU), hidden from
    // the compiler so that it keeps one body for every q
    int q = kb % (RL / KU);
    asm volatile("" : "+r"(q));
    const float* drow = dS + kb * KU * DSt + rg * RL;
#pragma unroll
    for (int kk = 0; kk < KU; ++kk) {
      float sh[4], dv[RL];
      int shs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = x[kk][j];
        int h = xs[kk][j];
#pragma unroll
        for (int u = 1; u < RL / KU; ++u) {
          v = q == u ? x[kk + u * KU][j] : v;
          h = q == u ? xs[kk + u * KU][j] : h;
        }
        sh[j] = __shfl_sync(0xffffffffu, v, src);
        if constexpr (Col) shs[j] = __shfl_sync(0xffffffffu, h, src);
      }
      lds_n<RL>(drow + kk * DSt, dv);
      const int k = kb * KU + kk;
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (Col) {
            relax_succ<Op>(x[i][j], xs[i][j], sh[j], shs[j], dv[i]);
          } else {
            relax_succ<Op>(x[i][j], xs[i][j], dv[i], k, sh[j]);
          }
        }
    }
  }
}

}  // namespace
