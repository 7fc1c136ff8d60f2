// Rank-1 repair on the storage lowerings, for Hopper (sm_90a).
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
// instantiated on the storage type: d, the staged rows and the weights are
// held in the storage type, registers and shared memory in 32 bits with the
// rounding or saturation of semiring.cuh after every op, in the reference's
// order ((d[i,u] ⊗ w) ⊗ d[v,j], then ⊕ d[i,j]; the successor candidate
// (d[i,u] + w) + d[v,j] with two roundings, taken where strictly smaller).
// One launch pair carries up to 32 edges (edge capacities 16 and 32 only,
// to keep this file's build short); longer batches run further pairs, which
// is the same sequence of steps.
//
// Bound on this card.  As in fw_repair.cu the apply launch reads and
// writes every word once and does E relaxations on it: bf16 / f16 at
// 2·n²·2 B and 3 operations a relaxation (plus_mul 4), int16 2 B and 6,
// packed 4 B and 1 for 32 graphs, int32 4 B and 2.  At E = 16, n = 8192 all
// but int16 are bound by bytes.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_repair.cuh"

namespace {

constexpr int kMaxEdges = 32;  // edges one launch pair carries

struct Args {
  int phase;
  const void* d;
  void* out;
  void* staged;
  const int* u;
  const int* v;
  const void* w;
  int n, E;
  cudaStream_t st;
};

template <class Op, class T>
int run(const Args& a) {
  return launch_repair<Op, T, 16, 32>(a.phase, static_cast<const T*>(a.d),
                                      static_cast<T*>(a.out), static_cast<T*>(a.staged), a.u,
                                      a.v, static_cast<const T*>(a.w), a.n, a.E, a.st);
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

}  // namespace

// phase: 0 = stage (rows v_e of d -> staged (E, n)), 1 = apply (d, staged
// -> out).  storage: 0 bf16, 1 f16, 2 int16, 3 packed int32 words, 4 int32
// integers.  semiring: 0 min_plus, 1 max_plus, 2 max_min, 3 or_and,
// 4 plus_mul (bf16 / f16); int16 takes 0-3 (the *_i16 lowerings), packed 3
// only, int32 3 and 4.  d, out (n, n), staged (E, n) and w (E,) in the
// storage type, u / v (E,) int32 in [0, n), all contiguous on the device;
// 1 <= E <= 32.
extern "C" int fw_repair_lowered_launch(int phase, int storage, int semiring, const void* d,
                                        void* out, void* staged, const void* u, const void* v,
                                        const void* w, int n, int E, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const Args a{phase, d, out, staged, static_cast<const int*>(u), static_cast<const int*>(v),
               w, n, E, static_cast<cudaStream_t>(stream)};
  return dispatch(storage, semiring, a);
}

// The successor repair on bf16 (storage 0) or f16 (storage 1) distances:
// phase 0 stages the distances with the strict relaxation; phase 1
// applies to d and succ (n, n) int32 -> out, succ_out.
extern "C" int fw_repair_lowered_succ_launch(int phase, int storage, const void* d,
                                             const void* succ, void* out, void* succ_out,
                                             void* staged, const void* u, const void* v,
                                             const void* w, int n, int E, void* stream) {
  if (E < 1 || E > kMaxEdges || n < 1 || phase < 0 || phase > 1)
    return (int)cudaErrorInvalidValue;
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const int* ps = static_cast<const int*>(succ);
  int* pso = static_cast<int*>(succ_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 0) {
    using T = __nv_bfloat16;
    return launch_repair_succ<MinPlusH<RoundBf16>, T, 16, 32>(
        phase, static_cast<const T*>(d), ps, static_cast<T*>(out), pso, static_cast<T*>(staged),
        pu, pv, static_cast<const T*>(w), n, E, st);
  }
  if (storage == 1) {
    using T = __half;
    return launch_repair_succ<MinPlusH<RoundF16>, T, 16, 32>(
        phase, static_cast<const T*>(d), ps, static_cast<T*>(out), pso, static_cast<T*>(staged),
        pu, pv, static_cast<const T*>(w), n, E, st);
  }
  return (int)cudaErrorInvalidValue;
}
