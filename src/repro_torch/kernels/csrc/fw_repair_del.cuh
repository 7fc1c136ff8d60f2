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
// Thread (rg, c) owns rows rg + 8m of column c in registers.
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
diag_kernel(const T* __restrict__ d_init, const T* __restrict__ strip,
            const int* __restrict__ pos, T* __restrict__ band, int n, int b) {
  constexpr int R = S / 8;
  __shared__ T rowbuf[2][S];
  __shared__ T colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  Reg<T> t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = widen(band_row(d_init, strip, pos, o, rg + 8 * m, n)[o + c]);
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) put(band[(size_t)(rg + 8 * m) * n + o + c], t[m]);
}

// ---------------------------------------------------------------- panels
// blockIdx.x < T-1: band tile x (skipping b), rows of the overlay;
// otherwise strip tile blockIdx.x - (T-1), 8 rows of block column b.  The
// closed diagonal comes from band block b, staged in shared memory with a
// padded row stride.
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
panels_kernel(const T* __restrict__ d_init, const T* __restrict__ strip,
              const int* __restrict__ pos, T* __restrict__ band, T* __restrict__ acol, int n,
              int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  T* d = reinterpret_cast<T*>(dyn_smem);  // S x DS
  __shared__ T buf[2][S];
  const int TT = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = band[(size_t)(idx / S) * n + o + idx % S];

  if (blockIdx.x < TT - 1) {
    const int x = blockIdx.x < b ? blockIdx.x : blockIdx.x + 1;
    const size_t c0 = (size_t)x * S;
    Reg<T> t[R];
#pragma unroll
    for (int m = 0; m < R; ++m)
      t[m] = widen(band_row(d_init, strip, pos, o, rg + 8 * m, n)[c0 + c]);
    __syncthreads();
    close_row_chain<S, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) put(band[(size_t)(rg + 8 * m) * n + c0 + c], t[m]);
  } else {
    const size_t r = (size_t)(blockIdx.x - (TT - 1)) * kStripRows + rg;
    Reg<T> t[1] = {widen(strip[r * n + o + c])};
    __syncthreads();
    close_col_chain<S, 1, Op>(t, d, buf, rg, c);
    put(acol[r * S + c], t[0]);
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
// (min-plus, strict <), through the _succ chains of fw_phases.cuh; Op is
// the distance step (StrictMinPlus in f32, MinPlusH<R> in bf16 / f16).
template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
succ_diag_kernel(const T* __restrict__ d_init, const int* __restrict__ s_init,
                 const T* __restrict__ strip, const int* __restrict__ strip_s,
                 const int* __restrict__ pos, T* __restrict__ band, int* __restrict__ band_s,
                 int n, int b) {
  constexpr int R = S / 8;
  __shared__ T rowbuf[2][S];
  __shared__ T colbuf[2][S];
  __shared__ int colsbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  float t[R];
  int ts[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    t[m] = widen(band_row(d_init, strip, pos, o, rg + 8 * m, n)[o + c]);
    ts[m] = band_row(s_init, strip_s, pos, o, rg + 8 * m, n)[o + c];
  }
  close_tile_chain_succ<S, Op>(t, ts, rowbuf, colbuf, colsbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const size_t at = (size_t)(rg + 8 * m) * n + o + c;
    put(band[at], t[m]);
    band_s[at] = ts[m];
  }
}

template <int S, class Op, class T>
__global__ void __launch_bounds__(8 * S)
succ_panels_kernel(const T* __restrict__ d_init, const int* __restrict__ s_init,
                   const T* __restrict__ strip, const int* __restrict__ strip_s,
                   const int* __restrict__ pos, T* __restrict__ band, int* __restrict__ band_s,
                   T* __restrict__ acol, int* __restrict__ acol_s, int n, int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  int* ds = reinterpret_cast<int*>(dyn_smem);  // S x DS successors of the closed diag
  T* d = reinterpret_cast<T*>(ds + S * DS);    // S x DS closed diag
  __shared__ T buf[2][S];
  __shared__ int sbuf[2][S];
  const int TT = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S) {
    const size_t at = (size_t)(idx / S) * n + o + idx % S;
    d[(idx / S) * DS + idx % S] = band[at];
    ds[(idx / S) * DS + idx % S] = band_s[at];
  }

  if (blockIdx.x < TT - 1) {
    const int x = blockIdx.x < b ? blockIdx.x : blockIdx.x + 1;
    const size_t c0 = (size_t)x * S;
    float t[R];
    int ts[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      t[m] = widen(band_row(d_init, strip, pos, o, rg + 8 * m, n)[c0 + c]);
      ts[m] = band_row(s_init, strip_s, pos, o, rg + 8 * m, n)[c0 + c];
    }
    __syncthreads();
    close_row_chain_succ<S, Op>(t, ts, d, ds, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const size_t at = (size_t)(rg + 8 * m) * n + c0 + c;
      put(band[at], t[m]);
      band_s[at] = ts[m];
    }
  } else {
    const size_t r = (size_t)(blockIdx.x - (TT - 1)) * kStripRows + rg;
    float t[1] = {widen(strip[r * n + o + c])};
    int ts[1] = {strip_s[r * n + o + c]};
    __syncthreads();
    close_col_chain_succ<S, 1, Op>(t, ts, d, buf, sbuf, rg, c);
    put(acol[r * S + c], t[0]);
    acol_s[r * S + c] = ts[0];
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

template <int S, class Op, class T>
int launch_sweep(int phase, const Bufs<T>& x, int n, int a, int b, int bk, cudaStream_t st) {
  const int TT = n / S, A = a / kStripRows;
  cudaError_t err;
  if (phase == 0) {
    diag_kernel<S, Op, T><<<1, 8 * S, 0, st>>>(x.d_init, x.strip, x.pos, x.band, n, b);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * sizeof(T);
    if ((err = prepare(panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    panels_kernel<S, Op, T><<<TT - 1 + A, 8 * S, smem, st>>>(x.d_init, x.strip, x.pos, x.band,
                                                             x.acol, n, b);
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
    succ_diag_kernel<S, Op, T><<<1, 8 * S, 0, st>>>(x.d_init, x.s_init, x.strip, x.strip_s,
                                                    x.pos, x.band, x.band_s, n, b);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * (sizeof(int) + sizeof(T));
    if ((err = prepare(succ_panels_kernel<S, Op, T>, smem)) != cudaSuccess) return (int)err;
    succ_panels_kernel<S, Op, T><<<TT - 1 + A, 8 * S, smem, st>>>(
        x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, x.acol, x.acol_s, n,
        b);
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
