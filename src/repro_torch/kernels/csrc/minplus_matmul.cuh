// The blocked semiring matmul C_out = [C_in ⊕] A ⊗⊕ B, templated on the
// semiring step Op, the storage type T of a, b, c and out, and the staging
// (Vec: 16-byte vector copies, or one element at a time):
// minplus_matmul.cu instantiates it for f32, minplus_matmul_lowered.cu for
// the storage lowerings.  What the launch does and why is in
// minplus_matmul.cu; the steps are semiring.cuh's.  Its mainloop (Stage,
// fold_k, the slice loop fold_slices, the lane layout and store_tile) also
// carries the fused round's relax kernels (fw_round.cuh) and the sweep's
// long-strip relax kernels (fw_repair_del.cuh).
//
// The A / B slices sit in shared memory in the storage type and the 8 x 8
// register tile in Reg<T> (float for f32 / bf16 / f16, int for int16 and
// int32 words): each value is widened on load and put back in T on store,
// exactly, and the step rounds or saturates after every op, so each
// element's chain is the f32 kernel's chain in the storage's arithmetic.
#pragma once

#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kTile = 128;      // output tile edge
constexpr int kThreads = 256;   // 16 x 16, an 8 x 8 register tile each
constexpr int kAS = kTile + 4;  // row stride of the k-major A slice

// Slice depth: 16 in the 4-byte storages; 8 in the 2-byte ones, whose
// rounded or saturating steps need the registers that a deeper slice's
// A prefetch would hold (ptxas spills them at 16).
template <class T>
constexpr int kBKOf = sizeof(T) == 2 ? 8 : 16;

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

// ------------------------------------------------------------ 4-wide moves
// Four consecutive elements of T: 16 bytes in a 4-byte storage, 8 in a
// 2-byte one, at an address aligned to that size.
template <class T>
using Word4 = typename std::conditional<sizeof(T) == 4, uint4, uint2>::type;

template <class T>
__device__ __forceinline__ void load4(const T* p, Reg<T>* o) {
  const Word4<T> w = *reinterpret_cast<const Word4<T>*>(p);
  T t[4];
  memcpy(t, &w, sizeof(w));
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = widen(t[e]);
}

template <class T>
__device__ __forceinline__ void store4(T* p, const Reg<T>* v) {
  T t[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) put(t[e], v[e]);
  Word4<T> w;
  memcpy(&w, t, sizeof(w));
  *reinterpret_cast<Word4<T>*>(p) = w;
}

// N consecutive elements of T to / from registers: 4-wide moves (load4 /
// store4) where N is a multiple of 4, else one at a time (N = 2, s = 16).
template <int N, class T>
__device__ __forceinline__ void load_n(const T* p, Reg<T>* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) load4(p + 4 * q, v + 4 * q);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) v[e] = widen(p[e]);
  }
}

template <int N, class T>
__device__ __forceinline__ void store_n(T* p, const Reg<T>* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) store4(p + 4 * q, v + 4 * q);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) put(p[e], v[e]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- staging
// N consecutive elements of T (8, 16 or 32 bytes) from global memory,
// aligned to min(16, their size), as 8- or 16-byte loads.
template <int N, class T>
__device__ __forceinline__ void load_vec(T (&dst)[N], const T* src) {
  constexpr int kB = N * (int)sizeof(T);
  if constexpr (kB == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    memcpy(dst, &w, kB);
  } else {
    static_assert(kB % 16 == 0, "whole 16-byte chunks");
    uint4 w[kB / 16];
#pragma unroll
    for (int i = 0; i < kB / 16; ++i) w[i] = reinterpret_cast<const uint4*>(src)[i];
    memcpy(dst, w, kB);
  }
}

// One slice: A rows i0 .. i0+127 by k0 .. k0+kBK-1, stored k-major (As[kk *
// kAS + r], A transposed on its way in), and B rows k0 .. k0+kBK-1 by
// columns j0 .. j0+N-1 (N = 128, or 64 for the successor relax), stored as
// it lies (Bs[kk * N + c]).  Elements
// past m, n or k are 0 (the pad); those past k are never folded.  A passes
// through registers (ra) so that its global loads of the next slice stay
// in flight while the current slice folds.  Vec: B by cp.async 16-byte
// copies (zero-filled past n and k), A by vector loads of kAE consecutive k
// of one row a thread; else B through registers (rb) too, one element at a
// time.  Each thread's pointers are set once and step a slice at a time.
template <class T, bool Vec, int BK = kBKOf<T>, int N = kTile>
struct Stage {
  static_assert(Vec || N == kTile, "the scalar staging is the matmul's, 128 wide");
  static constexpr int kBK = BK;
  static constexpr int kEPC = 16 / sizeof(T);         // elements a 16-byte chunk
  static constexpr int kAE = kTile * kBK / kThreads;  // A (or B) elements a thread: 8 or 4
  static constexpr int kBCPR = N / kEPC;              // B chunks a slice row
  static constexpr int kBQ = kBK * kBCPR;             // B chunks a slice: 512 or 128
  static constexpr int kBPer = kBQ > kThreads ? kBQ / kThreads : 1;  // a thread's: 2 or 1
  static constexpr int kBRows = kThreads / kBCPR;     // slice rows between them

  // Vec: A row tid % 128, k (tid / 128) * kAE + {0..kAE-1} (a warp's 32
  // rows then store conflict-free into one k row); B chunks tid (and tid +
  // 256 in f32).
  // Scalar: A k tid % kBK, rows tid / kBK + (256 / kBK) e; B column
  // tid % 128, rows tid / 128 + 2 e.
  T ra[kAE];
  T rb[Vec ? 1 : kAE];
  const T* ap;  // A at this thread's row and k offset, slice k0 (row past m: null)
  const T* bp;  // Vec: B at this thread's chunk, slice k0; scalar: B at column tid % 128
  int k0;       // the next slice to load
  int b_bytes;  // Vec: bytes of the chunk before column n (0: past n, or no chunk)

  __device__ __forceinline__ Stage(const T* a, const T* b, const Shape& sh, int i0, int j0) {
    const int tid = threadIdx.x;
    k0 = 0;
    if constexpr (Vec) {
      const int r = tid % kTile;
      ap = i0 + r < sh.m ? a + (long long)(i0 + r) * sh.lda + (tid / kTile) * kAE : nullptr;
      const int col = j0 + (tid % kBCPR) * kEPC;
      b_bytes = (tid < kBQ && col < sh.n) ? min(kEPC, sh.n - col) * (int)sizeof(T) : 0;
      bp = b + (long long)(tid / kBCPR) * sh.ldb + col;
    } else {
      const int r = tid / kBK;
      ap = a + (long long)(i0 + r) * sh.lda + tid % kBK;
      bp = b + j0 + tid % kTile;
      b_bytes = 0;
    }
  }

  // b: the batch's B, the address a copy of no bytes reads from.
  __device__ __forceinline__ void load(const T* b, const Shape& sh, T* Bs, T pad) {
    const int tid = threadIdx.x;
    if constexpr (Vec) {
      const int kq = k0 + (tid / kTile) * kAE;
      if (ap != nullptr && kq + kAE <= sh.k) {
        load_vec(ra, ap + k0);
      } else {
#pragma unroll
        for (int e = 0; e < kAE; ++e) ra[e] = (ap != nullptr && kq + e < sh.k) ? ap[k0 + e] : pad;
      }
#pragma unroll
      for (int c = 0; c < kBPer; ++c) {
        const int kk = tid / kBCPR + c * kBRows;
        const bool live = b_bytes > 0 && k0 + kk < sh.k;
        const T* src = bp + (long long)(k0 + c * kBRows) * sh.ldb;
        if (tid < kBQ)  // 2-byte storages: half the threads copy B
          cp_async16(Bs + kk * N + (tid % kBCPR) * kEPC, live ? src : b, live ? b_bytes : 0);
      }
      cp_async_commit();
    } else {
      const int kk = tid % kBK, c = tid % kTile;
#pragma unroll
      for (int e = 0; e < kAE; ++e) {
        const int r = tid / kBK + (kThreads / kBK) * e;
        ra[e] = (r < sh.m - (int)(blockIdx.y * kTile) && k0 + kk < sh.k)
                    ? ap[(long long)(kThreads / kBK) * e * sh.lda + k0]
                    : pad;
      }
#pragma unroll
      for (int e = 0; e < kAE; ++e) {
        const int kr = tid / kTile + (kThreads / kTile) * e;
        rb[e] = (k0 + kr < sh.k && c < sh.n - (int)(blockIdx.x * kTile))
                    ? bp[(long long)(k0 + kr) * sh.ldb]
                    : pad;
      }
    }
    k0 += kBK;
  }

  // Registers into the slice's buffers; Vec waits for its B copies.
  __device__ __forceinline__ void store(T* As, T* Bs) {
    const int tid = threadIdx.x;
    if constexpr (Vec) {
      const int r = tid % kTile, kq = (tid / kTile) * kAE;
#pragma unroll
      for (int e = 0; e < kAE; ++e) As[(kq + e) * kAS + r] = ra[e];
      cp_async_wait_all();
    } else {
      const int kk = tid % kBK, c = tid % kTile;
#pragma unroll
      for (int e = 0; e < kAE; ++e) As[kk * kAS + tid / kBK + (kThreads / kBK) * e] = ra[e];
#pragma unroll
      for (int e = 0; e < kAE; ++e) Bs[(tid / kTile + (kThreads / kTile) * e) * kTile + c] = rb[e];
    }
  }
};

// ------------------------------------------------------------------- fold
// Thread (ty, tx) owns rows 4ty + {0..3} and 64 + 4ty + {0..3}, columns
// 4tx + {0..3} and 64 + 4tx + {0..3}: each k reads its 8 A values and 8 B
// values as four 4-wide shared loads (broadcasts within the warp's 4 ty and
// 8 tx) and makes 64 relaxations.
template <class Op, class T>
__device__ __forceinline__ void fold_k(Reg<T> (&acc)[8][8], const T* as, const T* bs, int ty,
                                       int tx) {
  Reg<T> av[8], bv[8];
  load4(as + 4 * ty, av);
  load4(as + 64 + 4 * ty, av + 4);
  load4(bs + 4 * tx, bv);
  load4(bs + 64 + 4 * tx, bv + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = Op::relax(acc[i][j], av[i], bv[j]);
}

// The successor relax's step (fw_round.cuh and fw_repair_del.cuh: min-plus,
// strict <, Op the distance step): thread (ty, tx) of a 128 x kSuccCols
// tile owns rows 4ty + {0..3} and 64 + 4ty + {0..3}, columns 4tx + {0..3};
// each element takes a candidate only where it is strictly smaller, and
// keeps the k of that last improvement in ks (its hop is gathered after the
// fold).
constexpr int kSuccCols = 64;  // the successor relax's output tile width

template <class Op, class T>
__device__ __forceinline__ void fold_k_succ(float (&acc)[8][4], int (&ks)[8][4], const T* as,
                                            const T* bs, int ty, int tx, int k) {
  float av[8], bv[4];
  load4(as + 4 * ty, av);
  load4(as + 64 + 4 * ty, av + 4);
  load4(bs + 4 * tx, bv);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float cand = Op::mul(av[i], bv[j]);
      const bool better = cand < acc[i][j];
      acc[i][j] = better ? cand : acc[i][j];
      ks[i][j] = better ? k : ks[i][j];
    }
}

// Row i (0..7) of the register tile, as an offset in the output tile.
__device__ __forceinline__ int tile_row(int i, int ty) { return (i / 4) * 64 + 4 * ty + i % 4; }

// -------------------------------------------------------------- mainloop
// What every kernel on a 128-row output tile shares: matmul_kernel here,
// the fused round's relax_kernel and succ_relax_kernel (fw_round.cuh), the
// sweep's long-strip relax_kernel and succ_relax_kernel (fw_repair_del.cuh).
//
// A warp covers 4 ty by 8 tx, lane l at (ty + l / 8, tx + l % 8): each
// 4-wide read of a k row is then 4 distinct A and 8 distinct B addresses
// a warp, 64 and 128 bytes.
__device__ __forceinline__ int lane_ty() {
  return (threadIdx.x / 64) * 4 + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int lane_tx() {
  return ((threadIdx.x / 32) % 2) * 8 + threadIdx.x % 8;
}

// The two slice buffers of a CTA, BK deep, B N wide: A k-major, B as it
// lies.
template <class T, int BK = kBKOf<T>, int N = kTile>
struct Slices {
  __align__(16) T A[2][BK * kAS];
  __align__(16) T B[2][BK * N];
};

// f(i, h, r, col) for each 4-wide group of the thread's tile (H groups a
// row: 2 on a 128-wide tile, 1 on a 64-wide one): register row i, columns
// 4h .. 4h+3, at output row r and columns col .. col+3.
template <int H = 2, class F>
__device__ __forceinline__ void for_groups(int i0, int j0, int ty, int tx, F&& f) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h) f(i, h, i0 + tile_row(i, ty), j0 + h * 64 + 4 * tx);
}

// The slice loop.  The caller has issued slice 0 (st.load into sm.B[0])
// and started its tile meanwhile; fold(as, bs, k) folds depth k, whose A
// and B rows are at as and bs, for k ascending.  One barrier a slice:
// slice s + 1 loads (A into registers, B by cp.async into the other
// buffer) while slice s folds; the barrier after the fold both publishes
// slice s + 1 and frees slice s's buffers.  A last slice shorter than the
// depth folds to its own depth, never padded.
template <class T, bool Vec, int BK, int N, class Fold>
__device__ __forceinline__ void fold_slices(Stage<T, Vec, BK, N>& st, const T* b,
                                            const Shape& sh, Slices<T, BK, N>& sm, T pad,
                                            Fold&& fold) {
  constexpr int kBK = BK;
  st.store(sm.A[0], sm.B[0]);
  __syncthreads();
  const int slices = (sh.k + kBK - 1) / kBK;
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slices;
    if (more) st.load(b, sh, sm.B[cur ^ 1], pad);
    const T* as = sm.A[cur];
    const T* bs = sm.B[cur];
    if (more || sh.k % kBK == 0) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) fold(as + kk * kAS, bs + kk * N, s * kBK + kk);
    } else {
      const int kc = sh.k - s * kBK;
#pragma unroll 1
      for (int kk = 0; kk < kc; ++kk) fold(as + kk * kAS, bs + kk * N, s * kBK + kk);
    }
    if (more) st.store(sm.A[cur ^ 1], sm.B[cur ^ 1]);
    __syncthreads();
  }
}

// The tile (8 x C a thread) into out (row stride ldo), rows below m and
// columns below n.
template <bool Vec, int C = 8, class T>
__device__ __forceinline__ void store_tile(T* out, long long ldo, int m, int n, int i0, int j0,
                                           int ty, int tx, const Reg<T> (&acc)[8][C]) {
  for_groups<C / 4>(i0, j0, ty, tx, [&](int i, int h, int r, int col) {
    if (r >= m) return;
    T* dst = out + (long long)r * ldo + col;
    if (Vec && col + 4 <= n) {
      store4(dst, &acc[i][4 * h]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n) put(dst[e], acc[i][4 * h + e]);
    }
  });
}

// Two CTAs an SM: at most 128 registers a thread, no spills in the vector
// instantiations (chip_smoke.py's device phase prints them).
template <class Op, class T, bool Vec>
__global__ void __launch_bounds__(kThreads, 2)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* c, T* out, Shape sh,
              T zero) {
  __shared__ Slices<T> sm;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int ty = lane_ty(), tx = lane_tx();
  const long long g = blockIdx.z;
  a += g * sh.sa;
  b += g * sh.sb;
  out += g * sh.so;
  if (c != nullptr) c += g * sh.sc;
  T pad;  // what rows and columns past the end load: 0, fed only to themselves
  put(pad, Reg<T>(0));

  Stage<T, Vec> st(a, b, sh, i0, j0);
  st.load(b, sh, sm.B[0], pad);

  // The tile starts from C_in, or from the ⊕-identity without c.
  Reg<T> acc[8][8];
  const Reg<T> z = widen(zero);
  for_groups(i0, j0, ty, tx, [&](int i, int h, int r, int col) {
    Reg<T>* v = &acc[i][4 * h];
    if (c == nullptr || r >= sh.m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = z;
    } else if (Vec && col + 4 <= sh.n) {
      load4(c + (long long)r * sh.ldc + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = col + e < sh.n ? widen(c[(long long)r * sh.ldc + col + e]) : z;
    }
  });

  fold_slices(st, b, sh, sm, pad,
              [&](const T* as, const T* bs, int) { fold_k<Op>(acc, as, bs, ty, tx); });
  store_tile<Vec>(out, sh.ldo, sh.m, sh.n, i0, j0, ty, tx, acc);
}

// staging: 1 = 16-byte vector copies (every pointer 16-byte aligned, every
// row and batch stride a whole number of 16 bytes:
// minplus_matmul.py:staging), 0 = one element at a time.
template <class Op, class T>
int launch_matmul(const void* a, const void* b, const void* c, void* out, int B,
                  const Shape& sh, unsigned zero_bits, int staging, cudaStream_t st) {
  const dim3 grid((sh.n + kTile - 1) / kTile, (sh.m + kTile - 1) / kTile, B);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const T* tc = static_cast<const T*>(c);
  T* to = static_cast<T*>(out);
  const T z = from_bits<T>(zero_bits);
  if (staging == 1)
    matmul_kernel<Op, T, true><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, sh, z);
  else if (staging == 0)
    matmul_kernel<Op, T, false><<<grid, kThreads, 0, st>>>(ta, tb, tc, to, sh, z);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace
