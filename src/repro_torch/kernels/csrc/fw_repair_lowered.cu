// Rank-E repair on the storage lowerings, for Hopper (sm_90a).
//
// Replaces the same TPU kernels as fw_repair.cu —
// src/repro/kernels/fw_repair.py:fw_repair (_repair_kernel) and
// fw_repair_with_successors (_repair_succ_kernel) — for the storages those
// Pallas calls compile for in the reference (encode_weights,
// fw_repair.py:70-87) and the reference engine serves
// (src/repro/apsp/engine.py:563-705):
//
//   * bf16 / f16 with the five float semirings,
//   * the saturating int16 lowerings min_plus_i16, max_plus_i16,
//     max_min_i16 and or_and_i16,
//   * the bit-packed or_and_packed: one int32 word plane of 32 graphs, an
//     update's w a lane mask (⊗ = AND, ⊕ = OR on all 32 lanes at once),
//   * the int32 carrier of the integer or_and / plus_mul storages,
//   * the successor repair on bf16 / f16 distances with int32 next hops.
//
// The launches are fw_repair.cu's two (stage, apply; fw_repair.cuh),
// instantiated on the storage type: d, the staged rows, the row scalars
// and the weights are held in the storage type, registers and shared
// memory in 32 bits.  The stage rounds or saturates after every op
// (semiring.cuh), in the reference's order; the apply relaxes on lifted
// operands where Lifted<Op> keeps the same values (bf16 / f16 min-plus and
// max-plus: the round moves to the store; int16 min-plus and max-plus: the
// sentinels to the operands, the clamp to the store), every other step
// rounding after each op (the successor candidate (d[i,u] + w) + d[v,j]
// with two roundings, taken where strictly smaller).  The apply reads 8
// elements of a 2-byte storage a 16-byte vector, 256 columns a tile.  One
// launch pair carries up to 64 edges, as in f32 (at E = 64 the apply's
// slices take 97 KB of shared memory, the successor apply's 130 KB);
// longer batches run further pairs, which is the same sequence of steps.
//
// Bound on this card.  As in fw_repair.cu the apply launch reads and
// writes every word once and does E relaxations on it: bf16 / f16 at
// 2·n²·2 B and at most 4 operations a relaxation (min- / max-plus,
// lifted: 2), int16 2 B and 2 (min- / max-plus, lifted), packed 4 B and 1
// for 32 graphs, int32 4 B and 2.  At E = 16, n = 8192 all are bound by
// bytes.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair.cuh"

namespace {

struct Args {
  int phase;
  const void* d;
  void* out;
  void* staged;
  void* scal;
  const int* u;
  const int* v;
  const void* w;
  int n, E, vec;
  cudaStream_t st;
};

template <class Op, class T>
int run(const Args& a) {
  if (a.phase == 0)
    return launch_stage<Op, T, false>(
        static_cast<const T*>(a.d), nullptr, static_cast<T*>(a.staged),
        static_cast<T*>(a.scal), nullptr, a.u, a.v, static_cast<const T*>(a.w), a.n, a.E, a.st);
  return launch_apply<Op, T>(static_cast<const T*>(a.d), static_cast<T*>(a.out),
                             static_cast<const T*>(a.staged), static_cast<const T*>(a.scal),
                             a.n, a.E, a.vec, a.st);
}

template <class T, class R>
int run_half(int sid, const Args& a) {
  switch (sid) {
    case 0: return run<MinPlusH<R>, T>(a);
    case 1: return run<MaxPlusH<R>, T>(a);
    case 2:
    case 3: return run<MaxMin, T>(a);
    case 4: return run<PlusMulH<R>, T>(a);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int storage, int sid, const Args& a) {
  if (storage == 0) return run_half<__nv_bfloat16, RoundBf16>(sid, a);
  if (storage == 1) return run_half<__half, RoundF16>(sid, a);
  if (storage == 2) {
    switch (sid) {
      case 0: return run<MinPlusI16, short>(a);
      case 1: return run<MaxPlusI16, short>(a);
      case 2:
      case 3: return run<MaxMinI16, short>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (storage == 3 && sid == 3) return run<OrAndPacked, int>(a);
  if (storage == 4 && sid == 3) return run<MaxMinI16, int>(a);
  if (storage == 4 && sid == 4) return run<PlusMulI32, int>(a);
  return (int)cudaErrorInvalidValue;
}

template <class T, class R>
int run_succ(int phase, const void* d, const int* succ, void* out, int* succ_out, void* staged,
             void* scal, int* hop, const int* u, const int* v, const void* w, int n, int E,
             int vec, cudaStream_t st) {
  if (phase == 0)
    return launch_stage<Strict<MinPlusH<R>>, T, true>(
        static_cast<const T*>(d), succ, static_cast<T*>(staged), static_cast<T*>(scal), hop, u,
        v, static_cast<const T*>(w), n, E, st);
  return launch_succ_apply<MinPlusH<R>, T>(static_cast<const T*>(d), succ, static_cast<T*>(out),
                                           succ_out, static_cast<const T*>(staged),
                                           static_cast<const T*>(scal), hop, n, E, vec, st);
}

}  // namespace

// phase: 0 = stage (rows v_e of d -> staged (E, n), row scalars -> scal
// (n, E)), 1 = apply (d, staged, scal -> out, out != d).  storage: 0 bf16,
// 1 f16, 2 int16, 3 packed int32 words, 4 int32 integers.  semiring:
// 0 min_plus, 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul (bf16 / f16);
// int16 takes 0-3 (the *_i16 lowerings), packed 3 only, int32 3 and 4.
// d, out (n, n), staged, scal and w in the storage type, u / v (E,) int32
// in [0, n), all contiguous on the device; 1 <= E <= 64.  vec as
// fw_repair_launch's.
extern "C" int fw_repair_lowered_launch(int phase, int storage, int semiring, const void* d,
                                        void* out, void* staged, void* scal, const void* u,
                                        const void* v, const void* w, int n, int E, int vec,
                                        void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{phase, d, out, staged, scal, static_cast<const int*>(u),
               static_cast<const int*>(v), w, n, E, vec, static_cast<cudaStream_t>(stream)};
  return dispatch(storage, semiring, a);
}

// The successor repair on bf16 (storage 0) or f16 (storage 1) distances:
// phase 0 stages the distances with the strict relaxation and writes the
// row scalars and hops (n, E) int32; phase 1 applies to d and succ (n, n)
// int32 -> out, succ_out.
extern "C" int fw_repair_lowered_succ_launch(int phase, int storage, const void* d,
                                             const void* succ, void* out, void* succ_out,
                                             void* staged, void* scal, void* hop, const void* u,
                                             const void* v, const void* w, int n, int E,
                                             int vec, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const int* ps = static_cast<const int*>(succ);
  int* pso = static_cast<int*>(succ_out);
  int* ph = static_cast<int*>(hop);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 0)
    return run_succ<__nv_bfloat16, RoundBf16>(phase, d, ps, out, pso, staged, scal, ph, pu, pv,
                                              w, n, E, vec, st);
  if (storage == 1)
    return run_succ<__half, RoundF16>(phase, d, ps, out, pso, staged, scal, ph, pu, pv, w, n, E,
                                      vec, st);
  return (int)cudaErrorInvalidValue;
}
