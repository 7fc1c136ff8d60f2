// Phases 1 and 2 of the 4-dispatch Floyd-Warshall round for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fw_phase1.py:fw_phase1
// (_phase1_kernel) and src/repro/kernels/fw_phase2.py:fw_phase2_row /
// fw_phase2_col (_row_kernel / _col_kernel).  Phase 3 of that round is
// minplus_matmul.cu.
//
//   closure  — one CTA per graph closes an (s,s) tile: s sequential steps
//              t ⊕= t[:,k] ⊗ t[k,:] (close_tile_chain).
//   row band — one CTA per S-wide tile of an (s,n) band closes it against
//              the closed diagonal: p ⊕= d[:,k] ⊗ p[k,:] (close_row_chain).
//   col band — one CTA per S-high tile of an (n,s) band: p ⊕= p[:,k] ⊗
//              d[k,:] (close_col_chain).
//
// Unlike fw_round.cu's bands launch, the band launches cover every tile of
// the band, the pivot's own included, as the TPU kernels grid over all n/bt
// tiles: the caller splices the closed diagonal over it afterwards (for
// plus_mul the recompute is not a no-op).  A band tile holds S columns (row
// band) or S rows (col band) whatever the reference's bt, which chooses no
// element's chain.  The band length n is any value >= 1: the last tile's
// lanes past n load 0 and store nothing.  That is exact because a column of
// a row band (a row of a col band) evolves from its own values and the
// diagonal only.
//
// Exactness.  The chains are fw_round.cu's, from fw_phases.cuh, built from
// the steps of semiring.cuh: k ascending, step k's operands published into
// a double-buffered shared vector before one barrier a step; plus_mul one
// __fmaf_rn a step; min.NaN / max.NaN.  The closed diagonal sits in shared
// memory with a padded row stride (S + 1).
//
// Bound on this card.  s³ relaxations per tile on O(s²) words: a closure of
// s = 128 moves 128 KiB and does 2·128³ operations, well under a
// microsecond either way.  What bounds these launches is the chain's
// latency: s steps of one barrier each, on one CTA (closure) or one wave of
// n/S CTAs (bands).  The design keeps the tile in registers (S/8 values a
// thread, 8·S threads) so that a step is a shared read, a barrier and S/8
// register relaxations.
//
// Strides.  Every operand is a (B, rows, cols) view with unit column stride
// and its own row and batch strides, so that a caller passes slices of a
// larger matrix (w[..., o, o], w[..., o, :], w[..., :, o]) without a copy.
// The outputs must not overlap the inputs.
//
// Interface: plain C, pointers and the stream as void*; the entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_phases.cuh"

namespace {

// A (rows x cols) operand of graph g: base + g * batch + r * ld + c.
struct View {
  const float* p;
  long long ld, batch;
};

template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
closure_kernel(View in, float* __restrict__ out, long long ld_o, long long bs_o) {
  constexpr int R = S / 8;
  __shared__ float rowbuf[2][S];
  __shared__ float colbuf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const float* src = in.p + blockIdx.z * in.batch;
  float* dst = out + blockIdx.z * bs_o;
  float t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = src[(rg + 8 * m) * in.ld + c];
  close_tile_chain<S, Op>(t, rowbuf, colbuf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) dst[(rg + 8 * m) * ld_o + c] = t[m];
}

// Stage the closed (S,S) diagonal of graph blockIdx.z with row stride S + 1.
template <int S>
__device__ __forceinline__ void stage_diag(float* d, View diag) {
  constexpr int DS = S + 1;
  const float* dg = diag.p + blockIdx.z * diag.batch;
  for (int idx = threadIdx.x; idx < S * S; idx += 8 * S)
    d[(idx / S) * DS + idx % S] = dg[(idx / S) * diag.ld + idx % S];
}

// blockIdx.x: the band tile of columns [x·S, x·S + S).
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
row_band_kernel(View diag, View band, float* __restrict__ out, long long ld_o,
                long long bs_o, int n) {
  constexpr int R = S / 8;
  extern __shared__ float d[];  // S x (S + 1)
  __shared__ float buf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const int col = blockIdx.x * S + c;
  const bool live = col < n;
  const float* src = band.p + blockIdx.z * band.batch;
  float* dst = out + blockIdx.z * bs_o;
  stage_diag<S>(d, diag);
  float t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) t[m] = live ? src[(rg + 8 * m) * band.ld + col] : 0.0f;
  __syncthreads();
  close_row_chain<S, Op>(t, d, buf, rg, c);
  if (live) {
#pragma unroll
    for (int m = 0; m < R; ++m) dst[(rg + 8 * m) * ld_o + col] = t[m];
  }
}

// blockIdx.x: the band tile of rows [x·S, x·S + S).
template <int S, class Op>
__global__ void __launch_bounds__(8 * S)
col_band_kernel(View diag, View band, float* __restrict__ out, long long ld_o,
                long long bs_o, int n) {
  constexpr int R = S / 8;
  extern __shared__ float d[];  // S x (S + 1)
  __shared__ float buf[2][S];
  const int c = threadIdx.x % S, rg = threadIdx.x / S;
  const long long r0 = (long long)blockIdx.x * S;
  const float* src = band.p + blockIdx.z * band.batch;
  float* dst = out + blockIdx.z * bs_o;
  stage_diag<S>(d, diag);
  float t[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const long long r = r0 + rg + 8 * m;
    t[m] = r < n ? src[r * band.ld + c] : 0.0f;
  }
  __syncthreads();
  close_col_chain<S, R, Op>(t, d, buf, rg, c);
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const long long r = r0 + rg + 8 * m;
    if (r < n) dst[r * ld_o + c] = t[m];
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
int launch_phase(int kind, View diag, View band, float* out, long long ld_o,
                 long long bs_o, int B, int n, cudaStream_t st) {
  cudaError_t err;
  const size_t smem = (size_t)S * (S + 1) * sizeof(float);
  const int tiles = (n + S - 1) / S;
  if (kind == 0) {
    closure_kernel<S, Op><<<dim3(1, 1, B), 8 * S, 0, st>>>(diag, out, ld_o, bs_o);
  } else if (kind == 1) {
    if ((err = prepare(row_band_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    row_band_kernel<S, Op><<<dim3(tiles, 1, B), 8 * S, smem, st>>>(diag, band, out, ld_o,
                                                                    bs_o, n);
  } else if (kind == 2) {
    if ((err = prepare(col_band_kernel<S, Op>, smem)) != cudaSuccess) return (int)err;
    col_band_kernel<S, Op><<<dim3(tiles, 1, B), 8 * S, smem, st>>>(diag, band, out, ld_o,
                                                                    bs_o, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class Op>
int dispatch_s(int kind, View diag, View band, float* out, long long ld_o, long long bs_o,
               int B, int n, int s, cudaStream_t st) {
  switch (s) {
    case 16: return launch_phase<16, Op>(kind, diag, band, out, ld_o, bs_o, B, n, st);
    case 32: return launch_phase<32, Op>(kind, diag, band, out, ld_o, bs_o, B, n, st);
    case 64: return launch_phase<64, Op>(kind, diag, band, out, ld_o, bs_o, B, n, st);
    case 128: return launch_phase<128, Op>(kind, diag, band, out, ld_o, bs_o, B, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// kind: 0 = closure of diag (B,s,s) into out; 1 = row band (B,s,n) against
// the closed diag; 2 = col band (B,n,s).  band is unused by kind 0.
// semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.
// s in {16, 32, 64, 128}.  Each operand: base pointer, row stride and batch
// stride in floats, unit column stride.
extern "C" int fw_phase_launch(int kind, const void* diag, long long ld_d, long long bs_d,
                               const void* band, long long ld_b, long long bs_b,
                               void* out, long long ld_o, long long bs_o, int B, int n,
                               int s, int semiring, void* stream) {
  const View dv{static_cast<const float*>(diag), ld_d, bs_d};
  const View bv{static_cast<const float*>(band), ld_b, bs_b};
  float* po = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return dispatch_s<MinPlus>(kind, dv, bv, po, ld_o, bs_o, B, n, s, st);
    case 1: return dispatch_s<MaxPlus>(kind, dv, bv, po, ld_o, bs_o, B, n, s, st);
    case 2:
    case 3: return dispatch_s<MaxMin>(kind, dv, bv, po, ld_o, bs_o, B, n, s, st);
    case 4: return dispatch_s<PlusMul>(kind, dv, bv, po, ld_o, bs_o, B, n, s, st);
  }
  return (int)cudaErrorInvalidValue;
}
