// Fused Floyd-Warshall pivot round for Hopper (sm_90a): three launches.
//
// Replaces the TPU kernels src/repro/kernels/fw_round.py:fw_round
// (_round_kernel), fw_round.py:fw_round_bordered (the same _round_kernel on
// a rectangular tile grid with _bordered_order) and
// fw_round.py:fw_round_with_successors (_round_succ_kernel); also stands
// for their Pallas-Triton lowerings in src/repro/kernels/fw_round_gpu.py.
//
// The TPU kernel runs a whole round as one sequential grid and carries the
// closed pivot bands from step to step in VMEM scratch.  A CUDA grid runs
// its blocks in no order, so each round here is three launches on one
// stream, and the closed bands live in two device buffers, rowband
// (B,s,cols) and colband (B,rows,s) (four with successors), that the
// wrapper allocates once per solve:
//
//   1. diag  — one CTA per graph closes the (s,s) pivot tile (_close_diag)
//              and writes it into both band buffers at block b.
//   2. bands — (tc-1)+(tr-1) CTAs per graph close the row tiles
//              (_close_row_panel) and col tiles (_close_col_panel) of round
//              b against it.
//   3. relax — tr*tc CTAs per graph relax every (s,s) tile against bk-deep
//              band slices staged through shared memory (_relax_tile).
//              Tiles in row band b start from the row band, then tiles in
//              col band b from the col band, else from w (the splice of
//              fw_round.py:266-269).  Every tile is re-relaxed, pivot bands
//              included, k ascending, so plus_mul matches the reference.
//              Phase 3 writes w in place: it reads bands only from the
//              band buffers.  The batch rides gridDim.z.
//
// The square round runs the three kernels on (n,n) with rows = cols = n,
// pivot b and no owner echo.  The bordered round of the distributed solve
// runs them on a rank's (s+n_r, s+n_c) bordered block with the pivot
// pinned at b = 0 and two owner-echo tile coordinates (pr, pc), -1 where
// the rank holds no copy of the global pivot band (fw_round.py:247, 255,
// 266-269): the diag launch also writes the closed corner over row-band
// block pc and col-band block pr, whose band tiles the bands launch then
// leaves alone, and the relax launch starts rows in block pr from the row
// band and columns in block pc from the col band, as it does block b.
//
// Exactness.  Each element sees the reference's ⊕/⊗ chain in the
// reference's order, built from the steps of semiring.cuh by the chains of
// fw_phases.cuh (shared with fw_repair_del.cu).  Phases 1-2 update in
// place, so step k's operands are published into a double-buffered shared
// vector before a barrier and read after it: one __syncthreads per step.
// plus_mul's step is one single-rounded __fmaf_rn, as XLA contracts it in
// the reference.  min and max propagate NaN (min.NaN / max.NaN), as
// torch.minimum and jnp.minimum do; fminf/fmaxf would drop it.  The
// successor round takes a candidate only where cand < t, strictly.
//
// Bound on this card.  A relaxation is ~2 fp32 operations (add and min, or
// one FMA): n^3 relaxations per solve against the 67 TFLOP/s non-tensor
// pipe, versus 2*n^2 words of traffic per round at 3.35 TB/s.  At s = 128
// the relax launch does s relaxations per word it moves, so it is bound by
// operations, not bytes.  Its design: each thread keeps a TMxTM
// accumulator in registers (TM = s/16, 256 threads), and reads TM + TM
// operands from shared memory per TM*TM relaxations.  The diag and bands
// launches are short serial chains of s steps; they are bound by latency,
// which their registers-resident tiles and single barrier per step keep
// small.  tensor cores (wgmma) do not apply to a tropical ⊕.  A bordered
// round does rows*cols*s relaxations on its (rows, cols) block and is
// bound the same way.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

constexpr int kRelaxThreads = 256;  // 16 x 16, each owning TM x TM outputs

// ------------------------------------------------------------------ diag
// Thread (rg, c) = (tid / S, tid % S) owns rows rg + 8m of column c.
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
diag_kernel(const float* __restrict__ w, float* __restrict__ rowband,
            float* __restrict__ colband, int rows, int cols, int b, int pr, int pc) {
  constexpr int R = S / 8;
  __shared__ float rowbuf[2][S];
  __shared__ float colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const float* wg = w + g * rows * cols;
  float t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = wg[(o + rg + 8 * m) * cols + o + c];
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
  float* rb = rowband + g * S * cols;
  float* cb = colband + g * rows * S;
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = rg + 8 * m;
    rb[(size_t)r * cols + o + c] = t[m];
    cb[(o + r) * S + c] = t[m];
    if (pc >= 0) rb[(size_t)r * cols + (size_t)pc * S + c] = t[m];
    if (pr >= 0) cb[((size_t)pr * S + r) * S + c] = t[m];
  }
}

// ----------------------------------------------------------------- bands
// blockIdx.x < tc-1: row tile (b, j); otherwise col tile (i, b); j, i skip
// b.  The owner-echo tiles (j == pc, i == pr) already hold the closed
// corner (diag launch) and return at once.  The closed diagonal comes from
// rowband's block b, staged in shared memory with a padded row stride.
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
bands_kernel(const float* __restrict__ w, float* __restrict__ rowband,
             float* __restrict__ colband, int rows, int cols, int b, int pr, int pc) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ float d[];  // S x DS
  __shared__ float buf[2][S];
  const int TC = cols / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const bool is_row = blockIdx.x < TC - 1;
  int x = is_row ? blockIdx.x : blockIdx.x - (TC - 1);
  x = x < b ? x : x + 1;
  if (x == (is_row ? pc : pr)) return;
  const float* wg = w + g * rows * cols;
  float* rb = rowband + g * S * cols;
  float* cb = colband + g * rows * S;

  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = rb[(size_t)(idx / S) * cols + o + idx % S];
  float t[R];
  const size_t r0 = is_row ? o : (size_t)x * S;
  const size_t c0 = is_row ? (size_t)x * S : o;
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = wg[(r0 + rg + 8 * m) * cols + c0 + c];
  __syncthreads();

  if (is_row) {
    close_row_chain<S, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) rb[(size_t)(rg + 8 * m) * cols + c0 + c] = t[m];
  } else {
    close_col_chain<S, R, Op>(t, d, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) cb[(r0 + rg + 8 * m) * S + c] = t[m];
  }
}

// ----------------------------------------------------------------- relax
// One CTA per (s,s) tile; thread (ty, tx) owns rows ty + 16m, cols tx + 16q.
// Shared memory: A slice (S x bk, row stride bk+1) from colband, B slice
// (bk x S) from rowband.
template <int S, class Op>
__global__ void __launch_bounds__(kRelaxThreads)
relax_kernel(float* __restrict__ w, const float* __restrict__ rowband,
             const float* __restrict__ colband, int rows, int cols, int b, int pr,
             int pc, int bk) {
  constexpr int TM = S / 16;
  extern __shared__ float smem[];
  float* As = smem;                 // S x (bk + 1)
  float* Bs = smem + S * (bk + 1);  // bk x S
  const int TC = cols / S;
  const int ti = blockIdx.x / TC, tj = blockIdx.x % TC;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t g = blockIdx.z;
  float* wg = w + g * rows * cols;
  const float* rb = rowband + g * S * cols;
  const float* cb = colband + g * rows * S;

  const float* src;
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
  float acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[m][q] = src[(ty + 16 * m) * ld + tx + 16 * q];

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
  float* dst = wg + (size_t)ti * S * cols + (size_t)tj * S;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) dst[(size_t)(ty + 16 * m) * cols + tx + 16 * q] = acc[m][q];
}

// ------------------------------------------------------- successor round
// Same three launches carrying an int32 next-hop tile beside each distance
// tile (min-plus only), through the _succ chains of fw_phases.cuh.
template <int S>
__global__ void __launch_bounds__(8 * S)
succ_diag_kernel(const float* __restrict__ w, const int* __restrict__ succ,
                 float* __restrict__ rw, float* __restrict__ cw,
                 int* __restrict__ rs, int* __restrict__ cs, int n, int b) {
  constexpr int R = S / 8;
  __shared__ float rowbuf[2][S];
  __shared__ float colbuf[2][S];
  __shared__ int colsbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const float* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  float t[R];
  int ts[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    t[m] = wg[(o + rg + 8 * m) * n + o + c];
    ts[m] = sg[(o + rg + 8 * m) * n + o + c];
  }
  close_tile_chain_succ<S>(t, ts, rowbuf, colbuf, colsbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int r = rg + 8 * m;
    rw[g * S * n + (size_t)r * n + o + c] = t[m];
    rs[g * S * n + (size_t)r * n + o + c] = ts[m];
    cw[g * n * S + (o + r) * S + c] = t[m];
    cs[g * n * S + (o + r) * S + c] = ts[m];
  }
}

template <int S>
__global__ void __launch_bounds__(8 * S)
succ_bands_kernel(const float* __restrict__ w, const int* __restrict__ succ,
                  float* __restrict__ rw, float* __restrict__ cw,
                  int* __restrict__ rs, int* __restrict__ cs, int n, int b) {
  constexpr int R = S / 8, DS = S + 1;
  extern __shared__ float dsm[];
  float* d = dsm;                              // S x DS closed diag
  int* ds = reinterpret_cast<int*>(dsm + S * DS);  // S x DS its successors
  __shared__ float buf[2][S];
  __shared__ int sbuf[2][S];
  const int T = n / S;
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const size_t g = blockIdx.z;
  const size_t o = (size_t)b * S;
  const bool is_row = blockIdx.x < T - 1;
  int x = is_row ? blockIdx.x : blockIdx.x - (T - 1);
  x = x < b ? x : x + 1;
  const float* wg = w + g * n * n;
  const int* sg = succ + g * n * n;
  float* rwg = rw + g * S * n;
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
    t[m] = wg[(r0 + rg + 8 * m) * n + c0 + c];
    ts[m] = sg[(r0 + rg + 8 * m) * n + c0 + c];
  }
  __syncthreads();

  if (is_row) {
    close_row_chain_succ<S>(t, ts, d, ds, buf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      rwg[(size_t)(rg + 8 * m) * n + c0 + c] = t[m];
      rsg[(size_t)(rg + 8 * m) * n + c0 + c] = ts[m];
    }
  } else {
    close_col_chain_succ<S, R>(t, ts, d, buf, sbuf, rg, c);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      cw[g * n * S + (r0 + rg + 8 * m) * S + c] = t[m];
      cs[g * n * S + (r0 + rg + 8 * m) * S + c] = ts[m];
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kRelaxThreads)
succ_relax_kernel(float* __restrict__ w, int* __restrict__ succ,
                  const float* __restrict__ rw, const float* __restrict__ cw,
                  const int* __restrict__ rs, const int* __restrict__ cs,
                  int n, int b, int bk) {
  constexpr int TM = S / 16;
  extern __shared__ float smem[];
  float* As = smem;                                    // S x (bk + 1)
  int* ASs = reinterpret_cast<int*>(smem + S * (bk + 1));  // S x (bk + 1)
  float* Bs = smem + 2 * S * (bk + 1);                 // bk x S
  const int T = n / S;
  const int ti = blockIdx.x / T, tj = blockIdx.x % T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t g = blockIdx.z;
  float* wg = w + g * n * n;
  int* sg = succ + g * n * n;
  const float* rwg = rw + g * S * n;
  const int* rsg = rs + g * S * n;
  const float* cwg = cw + g * n * S;
  const int* csg = cs + g * n * S;

  const float* src;
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
      acc[m][q] = src[(ty + 16 * m) * ld + tx + 16 * q];
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
    relax_chunk_succ<S, TM, 16>(acc, sacc, As, ASs, Bs, bk, ty, tx);
  }
  float* dst = wg + (size_t)ti * S * n + (size_t)tj * S;
  int* sdst = sg + (size_t)ti * S * n + (size_t)tj * S;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      dst[(size_t)(ty + 16 * m) * n + tx + 16 * q] = acc[m][q];
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

template <int S, class Op>
int launch_round(int phase, float* w, float* rb, float* cb, int B, int rows, int cols,
                 int b, int pr, int pc, int bk, cudaStream_t st) {
  const int TR = rows / S, TC = cols / S;
  cudaError_t err;
  if (phase == 0) {
    diag_kernel<S, Op><<<dim3(1, 1, B), 8 * S, 0, st>>>(w, rb, cb, rows, cols, b, pr, pc);
  } else if (phase == 1) {
    const size_t smem = (size_t)S * (S + 1) * sizeof(float);
    if ((err = prepare(bands_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    bands_kernel<S, Op><<<dim3((TC - 1) + (TR - 1), 1, B), 8 * S, smem, st>>>(
        w, rb, cb, rows, cols, b, pr, pc);
  } else {
    const size_t smem = ((size_t)S * (bk + 1) + (size_t)bk * S) * sizeof(float);
    if ((err = prepare(relax_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    relax_kernel<S, Op><<<dim3(TR * TC, 1, B), kRelaxThreads, smem, st>>>(
        w, rb, cb, rows, cols, b, pr, pc, bk);
  }
  return (int)cudaGetLastError();
}

template <class Op>
int dispatch_s(int phase, float* w, float* rb, float* cb, int B, int rows, int cols,
               int s, int b, int pr, int pc, int bk, cudaStream_t st) {
  switch (s) {
    case 16: return launch_round<16, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 32: return launch_round<32, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 64: return launch_round<64, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
    case 128: return launch_round<128, Op>(phase, w, rb, cb, B, rows, cols, b, pr, pc, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_round(int phase, void* w, void* rowband, void* colband, int B, int rows,
                   int cols, int s, int b, int pr, int pc, int bk, int semiring,
                   void* stream) {
  float* pw = static_cast<float*>(w);
  float* rb = static_cast<float*>(rowband);
  float* cb = static_cast<float*>(colband);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch_s<MinPlus>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, bk, st);
    case 1: return dispatch_s<MaxPlus>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, bk, st);
    case 2:
    case 3: return dispatch_s<MaxMin>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, bk, st);
    case 4: return dispatch_s<PlusMul>(phase, pw, rb, cb, B, rows, cols, s, b, pr, pc, bk, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <int S>
int launch_succ(int phase, float* w, int* su, float* rw, float* cw, int* rs,
                int* cs, int B, int n, int b, cudaStream_t st) {
  const int T = n / S;
  const int bk = S < 32 ? S : 32;
  cudaError_t err;
  if (phase == 0) {
    succ_diag_kernel<S><<<dim3(1, 1, B), 8 * S, 0, st>>>(w, su, rw, cw, rs, cs, n, b);
  } else if (phase == 1) {
    const size_t smem = 2 * (size_t)S * (S + 1) * sizeof(float);
    if ((err = prepare(succ_bands_kernel<S>, smem)) != cudaSuccess) return (int)err;
    succ_bands_kernel<S><<<dim3(2 * (T - 1), 1, B), 8 * S, smem, st>>>(
        w, su, rw, cw, rs, cs, n, b);
  } else {
    const size_t smem = (2 * (size_t)S * (bk + 1) + (size_t)bk * S) * sizeof(float);
    if ((err = prepare(succ_relax_kernel<S>, smem)) != cudaSuccess) return (int)err;
    succ_relax_kernel<S><<<dim3(T * T, 1, B), kRelaxThreads, smem, st>>>(
        w, su, rw, cw, rs, cs, n, b, bk);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// phase: 0 = diag, 1 = bands, 2 = relax.  semiring: 0 min_plus,
// 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.  s in {16, 32, 64, 128};
// bk divides s.  w (B,n,n), rowband (B,s,n), colband (B,n,s), contiguous f32.
extern "C" int fw_round_launch(int phase, void* w, void* rowband, void* colband,
                               int B, int n, int s, int b, int bk, int semiring,
                               void* stream) {
  return dispatch_round(phase, w, rowband, colband, B, n, n, s, b, -1, -1, bk, semiring,
                        stream);
}

// The bordered round: w (B,rows,cols) with the pivot at tile (0,0), rowband
// (B,s,cols), colband (B,rows,s); pr / pc the owner-echo tile coordinates
// (-1 = none), shared by the batch.  A single tile has no bands: the
// wrapper does not launch phase 1 when rows == cols == s.
extern "C" int fw_round_bordered_launch(int phase, void* w, void* rowband, void* colband,
                                        int B, int rows, int cols, int s, int pr, int pc,
                                        int bk, int semiring, void* stream) {
  return dispatch_round(phase, w, rowband, colband, B, rows, cols, s, 0, pr, pc, bk,
                        semiring, stream);
}

// The successor round: w f32 and succ int32 (B,n,n); distance bands rw
// (B,s,n) / cw (B,n,s) and successor bands rs / cs of the same shapes.
extern "C" int fw_round_succ_launch(int phase, void* w, void* succ, void* rw,
                                    void* cw, void* rs, void* cs, int B, int n,
                                    int s, int b, void* stream) {
  float* pw = static_cast<float*>(w);
  int* su = static_cast<int*>(succ);
  float* prw = static_cast<float*>(rw);
  float* pcw = static_cast<float*>(cw);
  int* prs = static_cast<int*>(rs);
  int* pcs = static_cast<int*>(cs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 16: return launch_succ<16>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 32: return launch_succ<32>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 64: return launch_succ<64>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
    case 128: return launch_succ<128>(phase, pw, su, prw, pcw, prs, pcs, B, n, b, st);
  }
  return (int)cudaErrorInvalidValue;
}
