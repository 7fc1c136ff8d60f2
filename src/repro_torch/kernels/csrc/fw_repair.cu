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
// The kernels are fw_repair.cuh's, templated on the storage type; this
// file instantiates them for f32 with every edge capacity 8 / 16 / 32 / 64,
// fw_repair_lowered.cu for the storage lowerings.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair.cuh"

namespace {

constexpr int kMaxEdges = 64;  // edges one launch pair carries

template <class Op>
int launch(int phase, const float* d, float* out, float* staged, const int* u, const int* v,
           const float* w, int n, int E, cudaStream_t st) {
  return launch_repair<Op, float, 8, 16, 32, 64>(phase, d, out, staged, u, v, w, n, E, st);
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
    case 0: return launch<MinPlus>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 1: return launch<MaxPlus>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 2:
    case 3: return launch<MaxMin>(phase, pd, po, ps, pu, pv, pw, n, E, st);
    case 4: return launch<PlusMul>(phase, pd, po, ps, pu, pv, pw, n, E, st);
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
  return launch_repair_succ<MinPlus, float, 8, 16, 32, 64>(
      phase, static_cast<const float*>(d), static_cast<const int*>(succ),
      static_cast<float*>(out), static_cast<int*>(succ_out), static_cast<float*>(staged),
      static_cast<const int*>(u), static_cast<const int*>(v), static_cast<const float*>(w), n,
      E, static_cast<cudaStream_t>(stream));
}
