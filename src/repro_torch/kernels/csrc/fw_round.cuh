// The kernels of the fused pivot round (diag, bands, relax) and of the
// successor round, templated on the storage type T of w and of the band
// buffers: fw_round.cu instantiates them for f32 (square and bordered),
// fw_round_lowered.cu for bf16, f16, int16 and packed int32 words.  What the
// launches do and why is in fw_round.cu; the per-thread chains are in
// fw_phases.cuh, the steps in semiring.cuh.  Registers hold V = float (f32,
// bf16, f16) or int (int16, packed): each value is widened from T on load
// and put back in T on store, exactly.
#pragma once

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

constexpr int kRelaxThreads = 256;  // 16 x 16, each owning TM x TM outputs

// ------------------------------------------------------------------ diag
// Thread (rg, c) = (tid / S, tid % S) owns rows rg + 8m of column c.
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
diag_kernel(const T* __restrict__ w, T* __restrict__ rowband, T* __restrict__ colband,
            int rows, int cols, int b, int pr, int pc) {
  constexpr int R = S / 8;
  __shared__ T rowbuf[2][S];
  __shared__ T colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const T* wg = w + g * rows * cols;
  Reg<T> t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = widen(wg[(o + rg + 8 * m) * cols + o + c]);
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
  T* rb = rowband + g * S * cols;
  T* cb = colband + g * rows * S;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = rg + 8 * m;
    put(rb[(size_t)r * cols + o + c], t[m]);
    put(cb[(o + r) * S + c], t[m]);
    if (pc >= 0) put(rb[(size_t)r * cols + (size_t)pc * S + c], t[m]);
    if (pr >= 0) put(cb[((size_t)pr * S + r) * S + c], t[m]);
  }
}

// ----------------------------------------------------------------- bands
// blockIdx.x < tc-1: row tile (b, j); otherwise col tile (i, b); j, i skip
// b.  The owner-echo tiles (j == pc, i == pr) already hold the closed
// corner (diag launch) and return at once.  The closed diagonal comes from
// rowband's block b, staged in shared memory with a padded row stride.
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
bands_kernel(const T* __restrict__ w, T* __restrict__ rowband, T* __restrict__ colband,
             int rows, int cols, int b, int pr, int pc) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* d = reinterpret_cast<T*>(dyn_smem);  // S x DS
  __shared__ T buf[2][S];
  const int TC = cols / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const bool is_row = blockIdx.x < TC - 1;
  int x = is_row ? blockIdx.x : blockIdx.x - (TC - 1);
  x = x < b ? x : x + 1;
  if (x == (is_row ? pc : pr)) return;
  const T* wg = w + g * rows * cols;
  T* rb = rowband + g * S * cols;
  T* cb = colband + g * rows * S;

  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = rb[(size_t)(idx / S) * cols + o + idx % S];
  Reg<T> t[R];
  const size_t r0 = is_row ? o : (size_t)x * S;
  const size_t c0 = is_row ? (size_t)x * S : o;
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = widen(wg[(r0 + rg + 8 * m) * cols + c0 + c]);
  __syncthreads();

  if (is_row) {
    close_row_chain<S, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) put(rb[(size_t)(rg + 8 * m) * cols + c0 + c], t[m]);
  } else {
    close_col_chain<S, R, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) put(cb[(r0 + rg + 8 * m) * S + c], t[m]);
  }
}

// ----------------------------------------------------------------- relax
// One CTA per (s,s) tile; thread (ty, tx) owns rows ty + 16m, cols tx + 16q.
// Shared memory: A slice (S x bk, row stride bk+1) from colband, B slice
// (bk x S) from rowband.
template <int S, class Op, class T>
__global__ void __launch_bounds__(kRelaxThreads)
relax_kernel(T* __restrict__ w, const T* __restrict__ rowband, const T* __restrict__ colband,
             int rows, int cols, int b, int pr, int pc, int bk) {
  constexpr int TM = S / 16;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* As = reinterpret_cast<T*>(dyn_smem);  // S x (bk + 1)
  T* Bs = As + S * (bk + 1);               // bk x S
  const int TC = cols / S;
  const int ti = blockIdx.x / TC, tj = blockIdx.x % TC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t g = blockIdx.z;
  T* wg = w + g * rows * cols;
  const T* rb = rowband + g * S * cols;
  const T* cb = colband + g * rows * S;

  const T* src;
  size_t ld;
  if (ti == b || ti == pr) {
    src = rb + (size_t)tj * S;
    ld = cols;
  } else if (tj == b || tj == pc) {
    src = cb + (size_t)ti * S * S;
    ld = S;
  } else {
    src = wg + (size_t)ti * S * cols + (size_t)tj * S;
    ld = cols;
  }
  Reg<T> acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[m][q] = widen(src[(ty + 16 * m) * ld + tx + 16 * q]);

  for (int k0 = 0; k0 < S; k0 += bk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int r = idx / bk, kk = idx % bk;
      As[r * (bk + 1) + kk] = cb[((size_t)ti * S + r) * S + k0 + kk];
    }
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int kk = idx / S, cc = idx % S;
      Bs[kk * S + cc] = rb[(size_t)(k0 + kk) * cols + (size_t)tj * S + cc];
    }
    __syncthreads();
    relax_chunk<S, TM, 16, Op>(acc, As, Bs, bk, ty, tx);
  }
  T* dst = wg + (size_t)ti * S * cols + (size_t)tj * S;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) put(dst[(size_t)(ty + 16 * m) * cols + tx + 16 * q], acc[m][q]);
}

// ------------------------------------------------------- successor round
// Same three launches carrying an int32 next-hop tile beside each distance
// tile (min-plus only), through the _succ chains of fw_phases.cuh; Op is
// the distance step (StrictMinPlus in f32, MinPlusH<R> in bf16 / f16).
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
succ_diag_kernel(const T* __restrict__ w, const int* __restrict__ succ,
                 T* __restrict__ rw, T* __restrict__ cw,
                 int* __restrict__ rs, int* __restrict__ cs, int n, int b) {
  constexpr int R = S / 8;
  __shared__ T rowbuf[2][S];
  __shared__ T colbuf[2][S];
  __shared__ int colsbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const T* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  float t[R];
  int ts[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    t[m] = widen(wg[(o + rg + 8 * m) * n + o + c]);
    ts[m] = sg[(o + rg + 8 * m) * n + o + c];
  }
  close_tile_chain_succ<S, Op>(t, ts, rowbuf, colbuf, colsbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = rg + 8 * m;
    put(rw[g * S * n + (size_t)r * n + o + c], t[m]);
    rs[g * S * n + (size_t)r * n + o + c] = ts[m];
    put(cw[g * n * S + (o + r) * S + c], t[m]);
    cs[g * n * S + (o + r) * S + c] = ts[m];
  }
}

template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
succ_bands_kernel(const T* __restrict__ w, const int* __restrict__ succ,
                  T* __restrict__ rw, T* __restrict__ cw,
                  int* __restrict__ rs, int* __restrict__ cs, int n, int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* ds = reinterpret_cast<int*>(dyn_smem);  // S x DS successors of the closed diag
  T* d = reinterpret_cast<T*>(ds + S * DS);    // S x DS closed diag
  __shared__ T buf[2][S];
  __shared__ int sbuf[2][S];
  const int TT = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const bool is_row = blockIdx.x < TT - 1;
  int x = is_row ? blockIdx.x : blockIdx.x - (TT - 1);
  x = x < b ? x : x + 1;
  const T* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  T* rwg = rw + g * S * n;
  int* rsg = rs + g * S * n;

  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S) {
    const size_t at = (size_t)(idx / S) * n + o + idx % S;
    d[(idx / S) * DS + idx % S] = rwg[at];
    ds[(idx / S) * DS + idx % S] = rsg[at];
  }
  float t[R];
  int ts[R];
  const size_t r0 = is_row ? o : (size_t)x * S;
  const size_t c0 = is_row ? (size_t)x * S : o;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    t[m] = widen(wg[(r0 + rg + 8 * m) * n + c0 + c]);
    ts[m] = sg[(r0 + rg + 8 * m) * n + c0 + c];
  }
  __syncthreads();

  if (is_row) {
    close_row_chain_succ<S, Op>(t, ts, d, ds, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      put(rwg[(size_t)(rg + 8 * m) * n + c0 + c], t[m]);
      rsg[(size_t)(rg + 8 * m) * n + c0 + c] = ts[m];
    }
  } else {
    close_col_chain_succ<S, R, Op>(t, ts, d, buf, sbuf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      put(cw[g * n * S + (r0 + rg + 8 * m) * S + c], t[m]);
      cs[g * n * S + (r0 + rg + 8 * m) * S + c] = ts[m];
    }
  }
}

template <int S, class Op, class T>
__global__ void __launch_bounds__(kRelaxThreads)
succ_relax_kernel(T* __restrict__ w, int* __restrict__ succ,
                  const T* __restrict__ rw, const T* __restrict__ cw,
                  const int* __restrict__ rs, const int* __restrict__ cs,
                  int n, int b, int bk) {
  constexpr int TM = S / 16;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* ASs = reinterpret_cast<int*>(dyn_smem);  // S x (bk + 1) successors
  T* As = reinterpret_cast<T*>(ASs + S * (bk + 1));  // S x (bk + 1)
  T* Bs = As + S * (bk + 1);                         // bk x S
  const int TT = n / S;
  const int ti = blockIdx.x / TT, tj = blockIdx.x % TT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t g = blockIdx.z;
  T* wg = w + g * n * n;
  int* sg = succ + g * n * n;
  const T* rwg = rw + g * S * n;
  const int* rsg = rs + g * S * n;
  const T* cwg = cw + g * n * S;
  const int* csg = cs + g * n * S;

  const T* src;
  const int* ssrc;
  size_t ld;
  if (ti == b) {
    src = rwg + (size_t)tj * S;
    ssrc = rsg + (size_t)tj * S;
    ld = n;
  } else if (tj == b) {
    src = cwg + (size_t)ti * S * S;
    ssrc = csg + (size_t)ti * S * S;
    ld = S;
  } else {
    src = wg + (size_t)ti * S * n + (size_t)tj * S;
    ssrc = sg + (size_t)ti * S * n + (size_t)tj * S;
    ld = n;
  }
  float acc[TM][TM];
  int sacc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      acc[m][q] = widen(src[(ty + 16 * m) * ld + tx + 16 * q]);
      sacc[m][q] = ssrc[(ty + 16 * m) * ld + tx + 16 * q];
    }

  for (int k0 = 0; k0 < S; k0 += bk) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int r = idx / bk, kk = idx % bk;
      const size_t at = ((size_t)ti * S + r) * S + k0 + kk;
      As[r * (bk + 1) + kk] = cwg[at];
      ASs[r * (bk + 1) + kk] = csg[at];
    }
    for (int idx = threadIdx.x; idx < S * bk; idx += kRelaxThreads) {
      const int kk = idx / S, cc = idx % S;
      Bs[kk * S + cc] = rwg[(size_t)(k0 + kk) * n + (size_t)tj * S + cc];
    }
    __syncthreads();
    relax_chunk_succ<S, TM, 16, Op>(acc, sacc, As, ASs, Bs, bk, ty, tx);
  }
  T* dst = wg + (size_t)ti * S * n + (size_t)tj * S;
  int* sdst = sg + (size_t)ti * S * n + (size_t)tj * S;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      put(dst[(size_t)(ty + 16 * m) * n + tx + 16 * q], acc[m][q]);
      sdst[(size_t)(ty + 16 * m) * n + tx + 16 * q] = sacc[m][q];
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

template <int S, class Op, class T>
int launch_round(int phase, T* w, T* rb, T* cb, int B, int rows, int cols, int b, int pr,
                 int pc, int bk, cudaStream_t st) {
  const int TR = rows / S, TC = cols / S;
  cudaError_t err;
  if (phase == 0) {
    diag_kernel<S, Op, T><<<dim3(1, 1, B), 8 * S, 0, st>>>(w, rb, cb, rows, cols, b, pr, pc);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * sizeof(T);
    if ((err = prepare(bands_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    bands_kernel<S, Op, T><<<dim3((TC - 1) + (TR - 1), 1, B), 8 * S, smem, st>>>(
        w, rb, cb, rows, cols, b, pr, pc);
  } else {
    const size_t smem = ((size_t)S * (bk + 1) + (size_t)bk * S) * sizeof(T);
    if ((err = prepare(relax_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    relax_kernel<S, Op, T><<<dim3(TR * TC, 1, B), kRelaxThreads, smem, st>>>(
        w, rb, cb, rows, cols, b, pr, pc, bk);
  }
  return (int)cudaGetLastError();
}

template <class Op, class T>
int dispatch_s(int phase, T* w, T* rb, T* cb, int B, int rows, int cols, int s, int b,
               int pr, int pc, int bk, cudaStream_t st) {
  switch (s) {
    case 16: return launch_round<16, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 32: return launch_round<32, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 64: return launch_round<64, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 128: return launch_round<128, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int S, class Op, class T>
int launch_succ(int phase, T* w, int* su, T* rw, T* cw, int* rs, int* cs, int B, int n,
                int b, cudaStream_t st) {
  const int TT = n / S;
  const int bk = S < 32 ? S : 32;
  cudaError_t err;
  if (phase == 0) {
    succ_diag_kernel<S, Op, T><<<dim3(1, 1, B), 8 * S, 0, st>>>(w, su, rw, cw, rs, cs, n, b);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * (sizeof(int) + sizeof(T));
    if ((err = prepare(succ_bands_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    succ_bands_kernel<S, Op, T><<<dim3(2 * (TT - 1), 1, B), 8 * S, smem, st>>>(
        w, su, rw, cw, rs, cs, n, b);
  } else {
    const size_t smem =
        (size_t)S * (bk + 1) * (sizeof(int) + sizeof(T)) + (size_t)bk * S * sizeof(T);
    if ((err = prepare(succ_relax_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    succ_relax_kernel<S, Op, T><<<dim3(TT * TT, 1, B), kRelaxThreads, smem, st>>>(
        w, su, rw, cw, rs, cs, n, b, bk);
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
  switch (s) {
    case 16: return launch_succ<16, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 32: return launch_succ<32, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 64: return launch_succ<64, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 128: return launch_succ<128, Op>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
