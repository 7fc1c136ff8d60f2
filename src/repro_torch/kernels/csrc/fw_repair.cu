// Rank-1 repair of a closed distance matrix for Hopper (sm_90a): two
// launches per batch of up to 64 edge updates.
//
// Replaces the TPU kernels src/repro/kernels/fw_repair.py:fw_repair
// (_repair_kernel) and fw_repair.py:fw_repair_with_successors
// (_repair_succ_kernel).  Both apply E updates (u_e, v_e, w_e) in order:
//
//   c ⊕= (c[:, u_e] ⊗ w_e) ⊗ c[v_e, :]            (e = 0 .. E-1)
//
// each step reading column u_e and row v_e as they stood before it.  The
// TPU kernel runs one sequential grid: E stage steps evolve the pivot rows
// into VMEM scratch, then T apply steps fold all E updates into each row
// band.  A CUDA grid runs its blocks in no order, so here the two stages
// are two launches on one stream, with the staged rows in an (E, n) device
// buffer:
//
//   1. stage — P[g] = row v_g before step g.  Row v_g takes the updates
//      e < g; each needs the scalar (row v_g at column u_e, before step e),
//      which lives in another thread's column.  So every CTA first solves
//      the E x E restriction of the stage to the columns u_0 .. u_{E-1} in
//      shared memory (a wavefront: step t folds edge t into rows g > t,
//      whose row t is final by then; one barrier pair per step) and keeps
//      the scalars ⊗ w as A[g][t].  With the scalars known the columns are
//      independent: each thread evolves one column of the E rows in
//      registers.  n / 128 CTAs of 128 threads.
//   2. apply — every row i in the same way: its scalars (row i at column
//      u_e before step e) come from an E-vector evolution against the
//      staged rows at columns u_b, one thread per row; then the CTA's 32
//      rows stream through the columns in chunks of 128, each thread
//      holding a 4 x 4 tile, with 16-row slices of the staged rows staged
//      through shared memory, so each slice read from L2 serves 32 rows.
//
// The successor twin (min-plus only) runs the stage launch on its strict
// relaxation (the staged distances do not depend on next hops) and an
// apply launch that carries the next hop: an improved (i, j) takes v_e
// where i == u_e, else succ[i, u_e] as it stood before step e.
//
// Exactness.  Each element sees the reference's chain in its order:
// (c[i,u] ⊗ w) first, then ⊗ c[v,j] and ⊕ c[i,j] — for plus_mul one
// __fmaf_rn(__fmul_rn(c[i,u], w), c[v,j], c[i,j]), as XLA contracts the
// reference (measured on the CPU); min/max propagate NaN (min.NaN /
// max.NaN); the successor twin takes a candidate only where cand < c.
// Scalars and staged rows are computed by the same operation sequence in
// both launches, so row v_e of the apply equals P[e] bit for bit.  Edges
// beyond 64 are applied by further launch pairs (the wrapper's loop),
// which is the same sequence of steps.
//
// Bound on this card.  The apply launch reads and writes every element
// once (2·n²·word) and does E relaxations on it (~2·E·n² fp32 operations
// at 67 TFLOP/s): at E = 16, n = 8192 it is bound by bytes (0.16 ms); the
// two meet near E = 80.  The stage launch moves ~2·E·n words.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "semiring.cuh"

namespace {

constexpr int kMaxEdges = 64;     // edges one launch pair carries
constexpr int kStageThreads = 128;  // one column each
constexpr int kRows = 32;         // rows per apply CTA
constexpr int kCols = 128;        // column chunk of the apply CTA
constexpr int kSlice = 16;        // staged rows per shared-memory slice
constexpr int kApplyThreads = 256;  // 8 row groups of 4 x 32 lanes of 4 columns

// ------------------------------------------------------------------ stage
template <int EM, class Op>
__global__ void __launch_bounds__(kStageThreads)
stage_kernel(const float* __restrict__ d, float* __restrict__ staged,
             const int* __restrict__ u, const int* __restrict__ v,
             const float* __restrict__ w, int n, int E) {
  __shared__ float M[EM][EM + 1];  // row v_g at column u_b, evolving
  __shared__ float A[EM][EM + 1];  // A[g][t] = (row v_g at u_t before step t) ⊗ w_t
  __shared__ int us[EM], vs[EM];
  __shared__ float ws[EM];
  const int tid = threadIdx.x;
  if (tid < E) {
    us[tid] = u[tid];
    vs[tid] = v[tid];
    ws[tid] = w[tid];
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kStageThreads)
    M[idx / E][idx % E] = d[(size_t)vs[idx / E] * n + us[idx % E]];
  __syncthreads();
  for (int t = 0; t < E; ++t) {
    for (int g = t + 1 + tid; g < E; g += kStageThreads) A[g][t] = Op::mul(M[g][t], ws[t]);
    __syncthreads();
    const int k = E - 1 - t;  // rows g > t, columns b > t (column t is read no more)
    for (int idx = tid; idx < k * k; idx += kStageThreads) {
      const int g = t + 1 + idx / k, b = t + 1 + idx % k;
      M[g][b] = Op::relax(M[g][b], A[g][t], M[t][b]);
    }
    __syncthreads();
  }

  const int j = blockIdx.x * kStageThreads + tid;
  if (j >= n) return;
  float x[EM];
#pragma unroll
  for (int g = 0; g < EM; ++g) x[g] = g < E ? d[(size_t)vs[g] * n + j] : 0.f;
#pragma unroll
  for (int t = 0; t < EM; ++t) {
#pragma unroll
    for (int g = t + 1; g < EM; ++g)
      if (g < E) x[g] = Op::relax(x[g], A[g][t], x[t]);
  }
#pragma unroll
  for (int g = 0; g < EM; ++g)
    if (g < E) staged[(size_t)g * n + j] = x[g];
}

// ------------------------------------------------------------------ apply
template <int EM, class Op>
__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(const float* __restrict__ d, float* __restrict__ out,
             const float* __restrict__ staged, const int* __restrict__ u,
             const float* __restrict__ w, int n, int E) {
  __shared__ float PU[EM][EM + 1];                // PU[e][b] = P[e][u_b]
  __shared__ __align__(16) float A[EM][kRows];    // (row i at u_e before step e) ⊗ w_e
  __shared__ float Ps[kSlice][kCols];
  __shared__ int us[EM];
  __shared__ float ws[EM];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kRows;
  if (tid < E) {
    us[tid] = u[tid];
    ws[tid] = w[tid];
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kApplyThreads)
    PU[idx / E][idx % E] = staged[(size_t)(idx / E) * n + us[idx % E]];
  __syncthreads();
  if (tid < kRows) {  // the scalars of row i0 + tid
    const int i = i0 + tid;
    float y[EM];
#pragma unroll
    for (int b = 0; b < EM; ++b) y[b] = (b < E && i < n) ? d[(size_t)i * n + us[b]] : 0.f;
#pragma unroll
    for (int e = 0; e < EM; ++e) {
      if (e < E) {
        const float a = Op::mul(y[e], ws[e]);
        A[e][tid] = a;
#pragma unroll
        for (int b = e + 1; b < EM; ++b)
          if (b < E) y[b] = Op::relax(y[b], a, PU[e][b]);
      }
    }
  }

  const int tx = tid % 32, ty = tid / 32;  // rows ty*4 + m, columns tx + 32q
  for (int j0 = 0; j0 < n; j0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        acc[m][q] = (i < n && j < n) ? d[(size_t)i * n + j] : 0.f;
      }
    for (int e0 = 0; e0 < E; e0 += kSlice) {
      const int ec = min(kSlice, E - e0);
      __syncthreads();  // A is written; the previous slice is consumed
      for (int idx = tid; idx < ec * kCols; idx += kApplyThreads) {
        const int j = j0 + idx % kCols;
        Ps[idx / kCols][idx % kCols] = j < n ? staged[(size_t)(e0 + idx / kCols) * n + j] : 0.f;
      }
      __syncthreads();
      for (int ee = 0; ee < ec; ++ee) {
        const float4 a4 = *reinterpret_cast<const float4*>(&A[e0 + ee][ty * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        float p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = Ps[ee][tx + 32 * q];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] = Op::relax(acc[m][q], a[m], p[q]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        if (i < n && j < n) out[(size_t)i * n + j] = acc[m][q];
      }
  }
}

// Successor apply (min-plus): the same schedule carrying next hops.
template <int EM>
__global__ void __launch_bounds__(kApplyThreads)
succ_apply_kernel(const float* __restrict__ d, const int* __restrict__ succ,
                  float* __restrict__ out, int* __restrict__ succ_out,
                  const float* __restrict__ staged, const int* __restrict__ u,
                  const int* __restrict__ v, const float* __restrict__ w, int n,
                  int E) {
  __shared__ float PU[EM][EM + 1];
  __shared__ __align__(16) float A[EM][kRows];  // (row i at u_e before step e) + w_e
  __shared__ __align__(16) int H[EM][kRows];    // the hop an improvement takes
  __shared__ float Ps[kSlice][kCols];
  __shared__ int us[EM], vs[EM];
  __shared__ float ws[EM];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kRows;
  if (tid < E) {
    us[tid] = u[tid];
    vs[tid] = v[tid];
    ws[tid] = w[tid];
  }
  __syncthreads();
  for (int idx = tid; idx < E * E; idx += kApplyThreads)
    PU[idx / E][idx % E] = staged[(size_t)(idx / E) * n + us[idx % E]];
  __syncthreads();
  if (tid < kRows) {
    const int i = i0 + tid;
    float y[EM];
    int ys[EM];
#pragma unroll
    for (int b = 0; b < EM; ++b) {
      const bool in = b < E && i < n;
      y[b] = in ? d[(size_t)i * n + us[b]] : 0.f;
      ys[b] = in ? succ[(size_t)i * n + us[b]] : 0;
    }
#pragma unroll
    for (int e = 0; e < EM; ++e) {
      if (e < E) {
        const float a = __fadd_rn(y[e], ws[e]);
        const int h = i == us[e] ? vs[e] : ys[e];
        A[e][tid] = a;
        H[e][tid] = h;
#pragma unroll
        for (int b = e + 1; b < EM; ++b) {
          if (b < E) relax_succ(y[b], ys[b], a, h, PU[e][b]);
        }
      }
    }
  }

  const int tx = tid % 32, ty = tid / 32;
  for (int j0 = 0; j0 < n; j0 += kCols) {
    float acc[4][4];
    int sacc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        const bool in = i < n && j < n;
        acc[m][q] = in ? d[(size_t)i * n + j] : 0.f;
        sacc[m][q] = in ? succ[(size_t)i * n + j] : 0;
      }
    for (int e0 = 0; e0 < E; e0 += kSlice) {
      const int ec = min(kSlice, E - e0);
      __syncthreads();
      for (int idx = tid; idx < ec * kCols; idx += kApplyThreads) {
        const int j = j0 + idx % kCols;
        Ps[idx / kCols][idx % kCols] = j < n ? staged[(size_t)(e0 + idx / kCols) * n + j] : 0.f;
      }
      __syncthreads();
      for (int ee = 0; ee < ec; ++ee) {
        const float4 a4 = *reinterpret_cast<const float4*>(&A[e0 + ee][ty * 4]);
        const int4 h4 = *reinterpret_cast<const int4*>(&H[e0 + ee][ty * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const int h[4] = {h4.x, h4.y, h4.z, h4.w};
        float p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) p[q] = Ps[ee][tx + 32 * q];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) relax_succ(acc[m][q], sacc[m][q], a[m], h[m], p[q]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty * 4 + m, j = j0 + tx + 32 * q;
        if (i < n && j < n) {
          out[(size_t)i * n + j] = acc[m][q];
          succ_out[(size_t)i * n + j] = sacc[m][q];
        }
      }
  }
}

// ------------------------------------------------------------- launching
// EM, the compile-time edge capacity, is the smallest of 8/16/32/64 >= E.
#define REPAIR_DISPATCH_EM(E, LAUNCH) \
  do {                                \
    if ((E) <= 8) {                   \
      LAUNCH(8);                      \
    } else if ((E) <= 16) {           \
      LAUNCH(16);                     \
    } else if ((E) <= 32) {           \
      LAUNCH(32);                     \
    } else {                          \
      LAUNCH(64);                     \
    }                                 \
  } while (0)

template <class Op>
int launch_stage(const float* d, float* staged, const int* u, const int* v,
                 const float* w, int n, int E, cudaStream_t st) {
  const int grid = (n + kStageThreads - 1) / kStageThreads;
#define STAGE(EMV) \
  stage_kernel<EMV, Op><<<grid, kStageThreads, 0, st>>>(d, staged, u, v, w, n, E)
  REPAIR_DISPATCH_EM(E, STAGE);
#undef STAGE
  return (int)cudaGetLastError();
}

template <class Op>
int launch_repair(int phase, const float* d, float* out, float* staged,
                  const int* u, const int* v, const float* w, int n, int E,
                  cudaStream_t st) {
  if (phase == 0) return launch_stage<Op>(d, staged, u, v, w, n, E, st);
  const int grid = (n + kRows - 1) / kRows;
#define APPLY(EMV) \
  apply_kernel<EMV, Op><<<grid, kApplyThreads, 0, st>>>(d, out, staged, u, w, n, E)
  REPAIR_DISPATCH_EM(E, APPLY);
#undef APPLY
  return (int)cudaGetLastError();
}

}  // namespace

// phase: 0 = stage (rows v_e of d -> staged (E, n)), 1 = apply (d, staged
// -> out).  semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and,
// 4 plus_mul.  d, out (n, n) f32, staged (E, n) f32, u / v (E,) int32 in
// [0, n), w (E,) f32, all contiguous on the device; 1 <= E <= 64.
extern "C" int fw_repair_launch(int phase, const void* d, void* out, void* staged,
                                const void* u, const void* v, const void* w,
                                int n, int E, int semiring, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const float* pd = static_cast<const float*>(d);
  float* po = static_cast<float*>(out);
  float* ps = static_cast<float*>(staged);
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const float* pw = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch_repair<MinPlus>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 1: return launch_repair<MaxPlus>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 2:
    case 3: return launch_repair<MaxMin>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 4: return launch_repair<PlusMul>(phase, pd, po, ps, pu, pv, pw, n, E, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The successor twin (min-plus): phase 0 stages the distances with the
// strict relaxation; phase 1 applies to d and succ (n, n) int32 -> out,
// succ_out.
extern "C" int fw_repair_succ_launch(int phase, const void* d, const void* succ,
                                     void* out, void* succ_out, void* staged,
                                     const void* u, const void* v, const void* w,
                                     int n, int E, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const float* pd = static_cast<const float*>(d);
  float* ps = static_cast<float*>(staged);
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const float* pw = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phase == 0)
    return launch_stage<StrictMinPlus>(pd, ps, pu, pv, pw, n, E, st);
  const int grid = (n + kRows - 1) / kRows;
  const int* psu = static_cast<const int*>(succ);
  float* po = static_cast<float*>(out);
  int* pso = static_cast<int*>(succ_out);
#define SUCC_APPLY(EMV)                                                \
  succ_apply_kernel<EMV><<<grid, kApplyThreads, 0, st>>>(pd, psu, po, pso, \
                                                         ps, pu, pv, pw, n, E)
  REPAIR_DISPATCH_EM(E, SUCC_APPLY);
#undef SUCC_APPLY
  return (int)cudaGetLastError();
}
