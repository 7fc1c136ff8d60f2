// Restricted row sweep of the decremental repair for Hopper (sm_90a):
// three launches per pivot round.
//
// Replaces the TPU kernel src/repro/kernels/fw_repair_del.py:_sweep_round
// (_sweep_round_kernel, driven once per round by fw_repair_del_sweep), and
// gives the reference's XLA-only successor sweep
// (fw_repair_del_sweep_with_successors_ref) its kernel twin.
//
// After marking, only the a affected rows of the reset matrix d_init can
// change.  The sweep is blocked FW restricted to them: the a rows live in
// a compact (a, n) strip, and round b
//
//   1. diag   — one CTA closes the (s, s) pivot tile of the overlaid band
//               (_close_diag) into band block b.  The overlay is read, not
//               built: band row r is the strip row that holds matrix row
//               o + r where there is one (pos[o + r] >= 0), else row o + r
//               of d_init.
//   2. panels — T-1 CTAs close the band's other tiles against the diag
//               (_close_row_panel) into band; a / 8 CTAs close the strip's
//               block column b (_close_col_panel) into acol (a, s), 8 rows
//               each.
//   3. relax  — (a / 8) * T CTAs relax every (8, s) strip tile against
//               acol ⊗ band in bk chunks, k ascending (_relax_tile).  Tiles
//               of block column b start from acol, the others from the
//               strip; strip rows inside block b then take their band rows.
//
// The TPU kernel runs a round as one sequential grid and keeps the band and
// acol in VMEM scratch; here they are device buffers the wrapper allocates
// once per sweep, and the three launches run in order on one stream.
// The strip tile is 8 rows high at every a (the wrapper pads the strip to
// a multiple of 8 with inert rows).
//
// Exactness.  Each element sees the chain of the reference's XLA twin
// fw_repair_del_sweep_ref, in its order, through the chains of
// fw_phases.cuh that fw_round.cu runs too: only the loads (the overlay,
// the strip) and the stores (band, acol, the splice) are this file's.
// The twin re-relaxes the strip's block column b after splicing acol in
// (the Pallas kernel skips that tile); so does the relax launch.  Padding
// strip rows (index n) hold a copy of row n-1, are relaxed like the others
// and never read back: pos never names them and the wrapper drops them.
// The sweep is sound for the ⊕-idempotent semirings only; plus_mul has no
// entry here (the engine re-solves).  The successor sweep (min-plus) takes
// a candidate only where it is strictly smaller, in every phase.
//
// Bound on this card.  Round b does s·n·s relaxations on the band and
// a·n·s on the strip (2 fp32 operations each, 67 TFLOP/s) and moves ~
// (s + 2a)·n words, so the sweep is bound by operations: n²(s + a) · 2 /
// 67e12 s, 0.27 ms at n = 8192, s = 128, a = 8.  At small a the band
// closure dominates, and its diag and panels launches are serial chains of
// s barrier-separated steps on 1 and T-1 CTAs: latency, not the card's
// rates, sets their time.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

constexpr int kStripRows = 8;                   // the strip tile's height
constexpr int kRelaxThreads = kStripRows * 16;  // thread (ty, tx): row ty, cols tx + 16q

// Row r of round b's overlaid band (o = b·s): a strip row or a d_init row.
template <class V>
__device__ __forceinline__ const V* band_row(const V* d_init, const V* strip,
                                             const int* pos, size_t o, int r,
                                             int n) {
  const int p = pos[o + r];
  return p >= 0 ? strip + (size_t)p * n : d_init + (o + r) * n;
}

// ------------------------------------------------------------------ diag
// Thread (rg, c) owns rows rg + 8m of column c in registers.
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
diag_kernel(const float* __restrict__ d_init, const float* __restrict__ strip,
            const int* __restrict__ pos, float* __restrict__ band, int n, int b) {
  constexpr int R = S / 8;
  __shared__ float rowbuf[2][S];
  __shared__ float colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  float t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = band_row(d_init, strip, pos, o, rg + 8 * m, n)[o + c];
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) band[(size_t)(rg + 8 * m) * n + o + c] = t[m];
}

// ---------------------------------------------------------------- panels
// blockIdx.x < T-1: band tile x (skipping b), rows of the overlay;
// otherwise strip tile blockIdx.x - (T-1), 8 rows of block column b.  The
// closed diagonal comes from band block b, staged in shared memory with a
// padded row stride.
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
panels_kernel(const float* __restrict__ d_init, const float* __restrict__ strip,
              const int* __restrict__ pos, float* __restrict__ band,
              float* __restrict__ acol, int n, int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ float d[];  // S x DS
  __shared__ float buf[2][S];
  const int T = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = band[(size_t)(idx / S) * n + o + idx % S];

  if (blockIdx.x < T - 1) {
    const int x = blockIdx.x < b ? blockIdx.x : blockIdx.x + 1;
    const size_t c0 = (size_t)x * S;
    float t[R];
#pragma unroll
    for (int m = 0; m < R; ++m) t[m] = band_row(d_init, strip, pos, o, rg + 8 * m, n)[c0 + c];
    __syncthreads();
    close_row_chain<S, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) band[(size_t)(rg + 8 * m) * n + c0 + c] = t[m];
  } else {
    const size_t r = (size_t)(blockIdx.x - (T - 1)) * kStripRows + rg;
    float t[1] = {strip[r * n + o + c]};
    __syncthreads();
    close_col_chain<S, 1, Op>(t, d, buf, rg, c);
    acol[r * S + c] = t[0];
  }
}

// ----------------------------------------------------------------- relax
// One CTA per (8, S) strip tile (ti, tj); thread (ty, tx) owns row ty and
// columns tx + 16q.  Shared memory: acol slice (8 x bk, row stride bk+1),
// band slice (bk x S).
template <int S, class Op>
__global__ void __launch_bounds__(kRelaxThreads)
relax_kernel(float* __restrict__ strip, const float* __restrict__ band,
             const float* __restrict__ acol, const int* __restrict__ rows, int n,
             int b, int bk) {
  constexpr int CM = S / 16;
  extern __shared__ float smem[];
  float* As = smem;                         // 8 x (bk + 1)
  float* Bs = smem + kStripRows * (bk + 1);  // bk x S
  const int T = n / S;
  const int ti = blockIdx.x / T, tj = blockIdx.x % T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t r = (size_t)ti * kStripRows + ty, c0 = (size_t)tj * S;

  float acc[1][CM];
#pragma unroll
  for (int q = 0; q < CM; ++q)
    acc[0][q] = tj == b ? acol[r * S + tx + 16 * q] : strip[r * n + c0 + tx + 16 * q];

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
    strip[r * n + j] = in_blk ? band[(size_t)local * n + j] : acc[0][q];
  }
}

// ------------------------------------------------------- successor sweep
// The same three launches carrying an int32 next-hop twin of every buffer
// (min-plus, strict <), through the _succ chains of fw_phases.cuh.
template <int S>
__global__ void __launch_bounds__(8 * S)
succ_diag_kernel(const float* __restrict__ d_init, const int* __restrict__ s_init,
                 const float* __restrict__ strip, const int* __restrict__ strip_s,
                 const int* __restrict__ pos, float* __restrict__ band,
                 int* __restrict__ band_s, int n, int b) {
  constexpr int R = S / 8;
  __shared__ float rowbuf[2][S];
  __shared__ float colbuf[2][S];
  __shared__ int colsbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  float t[R];
  int ts[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    t[m] = band_row(d_init, strip, pos, o, rg + 8 * m, n)[o + c];
    ts[m] = band_row(s_init, strip_s, pos, o, rg + 8 * m, n)[o + c];
  }
  close_tile_chain_succ<S>(t, ts, rowbuf, colbuf, colsbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const size_t at = (size_t)(rg + 8 * m) * n + o + c;
    band[at] = t[m];
    band_s[at] = ts[m];
  }
}

template <int S>
__global__ void __launch_bounds__(8 * S)
succ_panels_kernel(const float* __restrict__ d_init, const int* __restrict__ s_init,
                   const float* __restrict__ strip, const int* __restrict__ strip_s,
                   const int* __restrict__ pos, float* __restrict__ band,
                   int* __restrict__ band_s, float* __restrict__ acol,
                   int* __restrict__ acol_s, int n, int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ float dsm[];
  float* d = dsm;                                  // S x DS closed diag
  int* ds = reinterpret_cast<int*>(dsm + S * DS);  // S x DS its successors
  __shared__ float buf[2][S];
  __shared__ int sbuf[2][S];
  const int T = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t o = (size_t)b * S;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S) {
    const size_t at = (size_t)(idx / S) * n + o + idx % S;
    d[(idx / S) * DS + idx % S] = band[at];
    ds[(idx / S) * DS + idx % S] = band_s[at];
  }

  if (blockIdx.x < T - 1) {
    const int x = blockIdx.x < b ? blockIdx.x : blockIdx.x + 1;
    const size_t c0 = (size_t)x * S;
    float t[R];
    int ts[R];
#pragma unroll
    for (int m = 0; m < R; ++m) {
      t[m] = band_row(d_init, strip, pos, o, rg + 8 * m, n)[c0 + c];
      ts[m] = band_row(s_init, strip_s, pos, o, rg + 8 * m, n)[c0 + c];
    }
    __syncthreads();
    close_row_chain_succ<S>(t, ts, d, ds, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const size_t at = (size_t)(rg + 8 * m) * n + c0 + c;
      band[at] = t[m];
      band_s[at] = ts[m];
    }
  } else {
    const size_t r = (size_t)(blockIdx.x - (T - 1)) * kStripRows + rg;
    float t[1] = {strip[r * n + o + c]};
    int ts[1] = {strip_s[r * n + o + c]};
    __syncthreads();
    close_col_chain_succ<S, 1>(t, ts, d, buf, sbuf, rg, c);
    acol[r * S + c] = t[0];
    acol_s[r * S + c] = ts[0];
  }
}

template <int S>
__global__ void __launch_bounds__(kRelaxThreads)
succ_relax_kernel(float* __restrict__ strip, int* __restrict__ strip_s,
                  const float* __restrict__ band, const int* __restrict__ band_s,
                  const float* __restrict__ acol, const int* __restrict__ acol_s,
                  const int* __restrict__ rows, int n, int b, int bk) {
  constexpr int CM = S / 16;
  extern __shared__ float smem[];
  float* As = smem;                                               // 8 x (bk + 1)
  int* ASs = reinterpret_cast<int*>(smem + kStripRows * (bk + 1));  // 8 x (bk + 1)
  float* Bs = smem + 2 * kStripRows * (bk + 1);                   // bk x S
  const int T = n / S;
  const int ti = blockIdx.x / T, tj = blockIdx.x % T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t r = (size_t)ti * kStripRows + ty, c0 = (size_t)tj * S;

  float acc[1][CM];
  int sacc[1][CM];
#pragma unroll
  for (int q = 0; q < CM; ++q) {
    const int cc = tx + 16 * q;
    acc[0][q] = tj == b ? acol[r * S + cc] : strip[r * n + c0 + cc];
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
    relax_chunk_succ<S, 1, kStripRows>(acc, sacc, As, ASs, Bs, bk, ty, tx);
  }
  const int local = rows[r] - b * S;
  const bool in_blk = local >= 0 && local < S;
#pragma unroll
  for (int q = 0; q < CM; ++q) {
    const size_t j = c0 + tx + 16 * q;
    strip[r * n + j] = in_blk ? band[(size_t)local * n + j] : acc[0][q];
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

struct Bufs {  // one sweep's device buffers (see the entry points below)
  const float* d_init;
  const int* s_init;
  const int* pos;
  const int* rows;
  float* strip;
  int* strip_s;
  float* band;
  int* band_s;
  float* acol;
  int* acol_s;
};

template <int S, class Op>
int launch_sweep(int phase, const Bufs& x, int n, int a, int b, int bk,
                 cudaStream_t st) {
  const int T = n / S, A = a / kStripRows;
  cudaError_t err;
  if (phase == 0) {
    diag_kernel<S, Op><<<1, 8 * S, 0, st>>>(x.d_init, x.strip, x.pos, x.band, n, b);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * sizeof(float);
    if ((err = prepare(panels_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    panels_kernel<S, Op><<<T - 1 + A, 8 * S, smem, st>>>(x.d_init, x.strip, x.pos,
                                                          x.band, x.acol, n, b);
  } else {
    const size_t smem = ((size_t)kStripRows * (bk + 1) + (size_t)bk * S) * sizeof(float);
    if ((err = prepare(relax_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    relax_kernel<S, Op><<<A * T, kRelaxThreads, smem, st>>>(x.strip, x.band, x.acol,
                                                            x.rows, n, b, bk);
  }
  return (int)cudaGetLastError();
}

template <int S>
int launch_succ(int phase, const Bufs& x, int n, int a, int b, cudaStream_t st) {
  const int T = n / S, A = a / kStripRows;
  const int bk = S < 32 ? S : 32;
  cudaError_t err;
  if (phase == 0) {
    succ_diag_kernel<S><<<1, 8 * S, 0, st>>>(x.d_init, x.s_init, x.strip, x.strip_s,
                                             x.pos, x.band, x.band_s, n, b);
  } else if (phase == 1) {
    const size_t smem = 2 * (size_t)S * (S + 1) * sizeof(float);
    if ((err = prepare(succ_panels_kernel<S>, smem)) != cudaSuccess) return (int)err;
    succ_panels_kernel<S><<<T - 1 + A, 8 * S, smem, st>>>(
        x.d_init, x.s_init, x.strip, x.strip_s, x.pos, x.band, x.band_s, x.acol,
        x.acol_s, n, b);
  } else {
    const size_t smem =
        (2 * (size_t)kStripRows * (bk + 1) + (size_t)bk * S) * sizeof(float);
    if ((err = prepare(succ_relax_kernel<S>, smem)) != cudaSuccess) return (int)err;
    succ_relax_kernel<S><<<A * T, kRelaxThreads, smem, st>>>(
        x.strip, x.strip_s, x.band, x.band_s, x.acol, x.acol_s, x.rows, n, b, bk);
  }
  return (int)cudaGetLastError();
}

template <class Op>
int dispatch_s(int phase, const Bufs& x, int n, int a, int s, int b, int bk,
               cudaStream_t st) {
  switch (s) {
    case 16: return launch_sweep<16, Op>(phase, x, n, a, b, bk, st);
    case 32: return launch_sweep<32, Op>(phase, x, n, a, b, bk, st);
    case 64: return launch_sweep<64, Op>(phase, x, n, a, b, bk, st);
    case 128: return launch_sweep<128, Op>(phase, x, n, a, b, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int phase, int n, int a, int s, int b) {
  return phase < 0 || phase > 2 || s < 16 || n < s || n % s || a < kStripRows ||
         a % kStripRows || b < 0 || b >= n / s;
}

}  // namespace

// phase: 0 = diag, 1 = panels, 2 = relax of round b.  semiring: 0 min_plus,
// 1 max_plus, 2 max_min, 3 or_and.  d_init (n,n); pos (n,) int32, the
// strip row holding each matrix row or -1; rows (a,) int32, the matrix row
// of each strip row (n for padding); strip (a,n), band (s,n), acol (a,s);
// f32 unless named, contiguous on the device.  s in {16, 32, 64, 128};
// a a multiple of 8; bk divides s.
extern "C" int fw_repair_del_launch(int phase, const void* d_init, const void* pos,
                                    const void* rows, void* strip, void* band,
                                    void* acol, int n, int a, int s, int b, int bk,
                                    int semiring, void* stream) {
  if (bad_shape(phase, n, a, s, b) || bk < 1 || s % bk) return (int)cudaErrorInvalidValue;
  const Bufs x{static_cast<const float*>(d_init), nullptr, static_cast<const int*>(pos),
               static_cast<const int*>(rows), static_cast<float*>(strip), nullptr,
               static_cast<float*>(band), nullptr, static_cast<float*>(acol), nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch_s<MinPlus>(phase, x, n, a, s, b, bk, st);
    case 1: return dispatch_s<MaxPlus>(phase, x, n, a, s, b, bk, st);
    case 2:
    case 3: return dispatch_s<MaxMin>(phase, x, n, a, s, b, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The successor sweep (min-plus): s_init, strip_s, band_s, acol_s are the
// int32 next-hop twins of d_init, strip, band, acol.
extern "C" int fw_repair_del_succ_launch(int phase, const void* d_init,
                                         const void* s_init, const void* pos,
                                         const void* rows, void* strip, void* strip_s,
                                         void* band, void* band_s, void* acol,
                                         void* acol_s, int n, int a, int s, int b,
                                         void* stream) {
  if (bad_shape(phase, n, a, s, b)) return (int)cudaErrorInvalidValue;
  const Bufs x{static_cast<const float*>(d_init), static_cast<const int*>(s_init),
               static_cast<const int*>(pos), static_cast<const int*>(rows),
               static_cast<float*>(strip), static_cast<int*>(strip_s),
               static_cast<float*>(band), static_cast<int*>(band_s),
               static_cast<float*>(acol), static_cast<int*>(acol_s)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 16: return launch_succ<16>(phase, x, n, a, b, st);
    case 32: return launch_succ<32>(phase, x, n, a, b, st);
    case 64: return launch_succ<64>(phase, x, n, a, b, st);
    case 128: return launch_succ<128>(phase, x, n, a, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
