// Rank-E repair of a closed distance matrix for Hopper (sm_90a): two
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
// are two launches on one stream, with their results in device buffers:
//
//   1. stage — P[g] = row v_g before step g, into staged (E, n).  Row v_g
//      takes the updates e < g; each needs the scalar (row v_g at column
//      u_e, before step e), which lives in another thread's column.  So
//      every CTA first solves the E x E restriction M of the stage to the
//      columns u_0 .. u_{E-1} in shared memory (a wavefront: step t folds
//      edge t into rows g > t, whose row t is final by then; one barrier
//      pair per step) and keeps the scalars ⊗ w as A[g][t].  With the
//      scalars known the columns are independent: each thread evolves one
//      column of the E rows, 16 rows in registers at a time.  Then each
//      thread evolves one row i of the matrix against M's upper triangle
//      (M[e][b], b > e, is P[e][u_b], by the same steps as column u_b's
//      thread takes) and writes its row scalars scal[i][e] = (row i at
//      column u_e before step e) ⊗ w_e into an (n, E) buffer: the
//      prologue every apply CTA used to run, once a row.  n / 128 CTAs of
//      128 threads, M in dynamic shared memory: one instantiation a
//      semiring serves every E.
//   2. apply — out = d ⊕ scal ⊗ P, a rank-E semiring update with k = e
//      ascending: a pure stream.  A 2-D grid of 128-row tiles by one
//      warp's width of 16-byte vectors (128 columns of a 4-byte storage,
//      256 of a 2-byte one): n = 8192 is 4096 or 2048 CTAs, n = 4096 1024
//      or 512 (64-row tiles ran 2-4 % slower on the H100: PERF.md).
//      Each CTA stages its P slice (E x columns) and scalar slice (128 x E)
//      into shared memory once, lifted (semiring.cuh:Lifted); each thread
//      holds 4 rows of one vector, loads the next 4 rows while these fold,
//      and stores 16-byte vectors.  The E loop reads shared memory at run
//      time, so one instantiation a semiring serves every E.  Where a row of
//      d, out or staged does not start 16-byte aligned (n not a multiple of
//      the vector, or a view), the same kernel moves one element at a time.
//
// The successor twin (min-plus only) runs the stage launch on its strict
// relaxation (the staged distances do not depend on next hops), which also
// writes hop[i][e], the hop an improvement of row i at step e takes: v_e
// where i == u_e, else succ[i, u_e] as it stood before step e.  Its apply
// keeps, beside each distance, the e of its last strict improvement, and
// gathers hop[i][e] after the fold.
//
// Exactness.  Each element sees the reference's chain in its order:
// (c[i,u] ⊗ w) first, then ⊗ c[v,j] and ⊕ c[i,j] — for plus_mul one
// __fmaf_rn(__fmul_rn(c[i,u], w), c[v,j], c[i,j]), as XLA contracts the
// reference (measured on the CPU); min/max propagate NaN (min.NaN /
// max.NaN); the successor twin takes a candidate only where cand < c.
// The scalars c[i,u] ⊗ w are values of the storage, so their buffer holds
// them exactly.  Edges beyond 64 are applied by further launch pairs (the
// wrapper's loop), which is the same sequence of steps.
//
// Bound on this card.  The apply launch reads and writes every element
// once (2·n²·word) and does E relaxations on it (~2·E·n² fp32 operations
// at 67 TFLOP/s): at E = 16, n = 8192 it is bound by bytes (0.16 ms); the
// two meet near E = 80.  The stage launch moves ~3·E·n words.
//
// The kernels are fw_repair.cuh's, templated on the storage type; this
// file instantiates each once a semiring for f32, fw_repair_lowered.cu for
// the storage lowerings.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair.cuh"

namespace {

template <class Op>
int launch(int phase, const float* d, float* out, float* staged, float* scal, const int* u,
           const int* v, const float* w, int n, int E, int vec, cudaStream_t st) {
  if (phase == 0)
    return launch_stage<Op, float, false>(d, nullptr, staged, scal, nullptr, u, v, w, n, E, st);
  return launch_apply<Op, float>(d, out, staged, scal, n, E, vec, st);
}

}  // namespace

// phase: 0 = stage (rows v_e of d -> staged (E, n), row scalars -> scal
// (n, E)), 1 = apply (d, staged, scal -> out, out != d).  semiring:
// 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul.  d, out (n, n)
// f32, staged, scal, w f32, u / v (E,) int32 in [0, n), all contiguous on
// the device; 1 <= E <= 64.  vec: 1 = the apply moves 16-byte vectors
// (every row of d, out and staged 16-byte aligned), 0 = one element at a
// time.
extern "C" int fw_repair_launch(int phase, const void* d, void* out, void* staged, void* scal,
                                const void* u, const void* v, const void* w, int n, int E,
                                int semiring, int vec, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const float* pd = static_cast<const float*>(d);
  float* po = static_cast<float*>(out);
  float* ps = static_cast<float*>(staged);
  float* pa = static_cast<float*>(scal);
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const float* pw = static_cast<const float*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (semiring) {
    case 0: return launch<MinPlus>(phase, pd, po, ps, pa, pu, pv, pw, n, E, vec, st);
    case 1: return launch<MaxPlus>(phase, pd, po, ps, pa, pu, pv, pw, n, E, vec, st);
    case 2:
    case 3: return launch<MaxMin>(phase, pd, po, ps, pa, pu, pv, pw, n, E, vec, st);
    case 4: return launch<PlusMul>(phase, pd, po, ps, pa, pu, pv, pw, n, E, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The successor twin (min-plus): phase 0 stages the distances with the
// strict relaxation and writes the row scalars and hops (n, E) int32;
// phase 1 applies to d and succ (n, n) int32 -> out, succ_out.
extern "C" int fw_repair_succ_launch(int phase, const void* d, const void* succ, void* out,
                                     void* succ_out, void* staged, void* scal, void* hop,
                                     const void* u, const void* v, const void* w, int n, int E,
                                     int vec, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const float* pd = static_cast<const float*>(d);
  const int* pg = static_cast<const int*>(succ);
  float* ps = static_cast<float*>(staged);
  float* pa = static_cast<float*>(scal);
  int* ph = static_cast<int*>(hop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (phase == 0)
    return launch_stage<StrictMinPlus, float, true>(
        pd, pg, ps, pa, ph, static_cast<const int*>(u), static_cast<const int*>(v),
        static_cast<const float*>(w), n, E, st);
  return launch_succ_apply<MinPlus, float>(pd, pg, static_cast<float*>(out),
                                           static_cast<int*>(succ_out), ps, pa, ph, n, E, vec,
                                           st);
}
