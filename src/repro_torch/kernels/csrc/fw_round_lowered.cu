// The fused pivot round on the storage lowerings, for Hopper (sm_90a).
//
// Replaces the same TPU kernels as fw_round.cu — src/repro/kernels/
// fw_round.py:fw_round (_round_kernel) and fw_round_with_successors
// (_round_succ_kernel) — for the storage lowerings those Pallas calls
// compile for in the reference (src/repro/core/semiring.py:96-285):
//
//   * bf16 / f16 with the five float semirings (the identity lowering),
//   * the saturating int16 lowerings min_plus_i16, max_plus_i16,
//     max_min_i16 and or_and_i16,
//   * the bit-packed or_and_packed: 32 graphs per int32 word, ⊕ = OR,
//     ⊗ = AND,
//   * the integer storages of or_and and plus_mul (bool, int8, uint8,
//     int16, int32, uint32 inputs; src/repro/apsp/api.py:_coerce keeps
//     their dtype), computed on an int32 carrier: or_and as integer
//     max/min, plus_mul as wrapping add and multiply (PlusMulI32),
//   * the successor round on bf16 / f16 distances with int32 next hops.
//
// The launches are fw_round.cu's three (diag, bands, relax; fw_round.cuh),
// instantiated on the storage type: tiles in shared memory and the band
// buffers are held in the storage type, so a round moves half the bytes of
// f32 (int16, bf16, f16) or 1/32 of them per graph (packed).  Arithmetic
// runs in 32-bit registers with the rounding or saturation of semiring.cuh
// after every op, in the f32 chain's order (k ascending), so each
// element's chain is the reference's, bit for bit.
//
// The bordered round of the distributed solve (fw_round.py:fw_round_bordered)
// runs the same instantiations: the launches take the block's rows and
// cols, the pivot and the owner-echo tiles at run time (fw_round.cu says
// how), so the square round passes (n, n, b, -1, -1) and the bordered one
// (rows, cols, 0, pr, pc).
//
// Bound on this card.  A round reads and writes n^2 words and does n^2 * s
// relaxations.  At s = 128 the relax launch does s relaxations per word it
// moves, so it is bound by operations.  Counted as for f32 (min-plus: add,
// min = 2), one operation for each arithmetic op, rounding or select made
// per (i, j, k): a bf16 / f16 min-plus relaxation is 3 (add, round, min;
// plus_mul 4 in bf16: mul, round, add, round; 1 HFMA in f16), an int16
// tropical one 6 integer ops
// (add, clamp ×2, the two sentinel selects, min; each sentinel test looks
// at one operand, so it is made once per (i, k) or (k, j), not per
// triple), a packed one 1 LOP3 for 32 graphs, an int32 one 2 (min, max or
// mul, add).  Tensor cores do not apply:
// the tropical ⊕ is not a sum, and plus_mul rounds after every step in
// 16 bits (bf16 twice), which no MMA reproduces.
//
// Interface: plain C, pointers and the stream as void*, each entry point
// returns the cudaError_t of its launch (0 = launched).

#include <cuda_runtime.h>

#include "fw_round.cuh"

namespace {

// bf16 / f16: the five float semirings (or_and is max/min on {0,1}).
#define GEOM B, rows, cols, s, b, pr, pc, st
template <class T, class R>
int dispatch_half(int phase, int sid, T* w, T* rb, T* cb, int B, int rows, int cols, int s,
                  int b, int pr, int pc, cudaStream_t st) {
  switch (sid) {
    case 0: return dispatch_s<MinPlusH<R>>(phase, w, rb, cb, GEOM);
    case 1: return dispatch_s<MaxPlusH<R>>(phase, w, rb, cb, GEOM);
    case 2:
    case 3: return dispatch_s<MaxMin>(phase, w, rb, cb, GEOM);
    case 4: return dispatch_s<PlusMulH<R>>(phase, w, rb, cb, GEOM);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch_lowered(int phase, int storage, int sid, void* w, void* rowband, void* colband,
                     int B, int rows, int cols, int s, int b, int pr, int pc, cudaStream_t st) {
  if (storage == 0) {
    using T = __nv_bfloat16;
    return dispatch_half<T, RoundBf16>(phase, sid, static_cast<T*>(w), static_cast<T*>(rowband),
                                       static_cast<T*>(colband), GEOM);
  }
  if (storage == 1) {
    using T = __half;
    return dispatch_half<T, RoundF16>(phase, sid, static_cast<T*>(w), static_cast<T*>(rowband),
                                      static_cast<T*>(colband), GEOM);
  }
  if (storage == 2) {
    short* pw = static_cast<short*>(w);
    short* rb = static_cast<short*>(rowband);
    short* cb = static_cast<short*>(colband);
    switch (sid) {
      case 0: return dispatch_s<MinPlusI16>(phase, pw, rb, cb, GEOM);
      case 1: return dispatch_s<MaxPlusI16>(phase, pw, rb, cb, GEOM);
      case 2:
      case 3: return dispatch_s<MaxMinI16>(phase, pw, rb, cb, GEOM);
    }
    return (int)cudaErrorInvalidValue;
  }
  int* pw = static_cast<int*>(w);
  int* rb = static_cast<int*>(rowband);
  int* cb = static_cast<int*>(colband);
  if (storage == 3 && sid == 3) return dispatch_s<OrAndPacked>(phase, pw, rb, cb, GEOM);
  if (storage == 4 && sid == 3) return dispatch_s<MaxMinI16>(phase, pw, rb, cb, GEOM);
  if (storage == 4 && sid == 4) return dispatch_s<PlusMulI32>(phase, pw, rb, cb, GEOM);
  return (int)cudaErrorInvalidValue;
}
#undef GEOM

}  // namespace

// phase: 0 = diag, 1 = bands, 2 = relax.  storage: 0 bf16, 1 f16, 2 int16,
// 3 packed int32 words, 4 int32 integers.  semiring: 0 min_plus,
// 1 max_plus, 2 max_min, 3 or_and, 4 plus_mul (bf16 / f16); int16 takes
// 0-3 (the *_i16 lowerings), packed 3 only, int32 3 and 4.  s in {16, 32,
// 64, 128}.  w (B,n,n), rowband (B,s,n), colband (B,n,s), contiguous, in the
// storage type, 16-byte aligned.
extern "C" int fw_round_lowered_launch(int phase, int storage, int semiring, void* w,
                                       void* rowband, void* colband, int B, int n, int s,
                                       int b, void* stream) {
  return dispatch_lowered(phase, storage, semiring, w, rowband, colband, B, n, n, s, b, -1, -1,
                          static_cast<cudaStream_t>(stream));
}

// The bordered round on the storage lowerings: w (B,rows,cols) with the
// pivot at tile (0,0), rowband (B,s,cols), colband (B,rows,s), in the
// storage type; pr / pc the owner-echo tile coordinates (-1 = none), shared
// by the batch; storage and semiring as fw_round_lowered_launch.  A single
// tile has no bands: the wrapper does not launch phase 1 when rows == cols
// == s.
extern "C" int fw_round_bordered_lowered_launch(int phase, int storage, int semiring, void* w,
                                                void* rowband, void* colband, int B, int rows,
                                                int cols, int s, int pr, int pc, void* stream) {
  return dispatch_lowered(phase, storage, semiring, w, rowband, colband, B, rows, cols, s, 0,
                          pr, pc, static_cast<cudaStream_t>(stream));
}

// The successor round on bf16 (storage 0) or f16 (storage 1) distances:
// w and its bands rw (B,s,n) / cw (B,n,s) in the storage type, succ and
// its bands rs / cs int32.
extern "C" int fw_round_lowered_succ_launch(int phase, int storage, void* w, void* succ,
                                            void* rw, void* cw, void* rs, void* cs, int B,
                                            int n, int s, int b, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (storage == 0)
    return dispatch_succ<MinPlusH<RoundBf16>, __nv_bfloat16>(phase, w, succ, rw, cw, rs, cs,
                                                             B, n, s, b, st);
  if (storage == 1)
    return dispatch_succ<MinPlusH<RoundF16>, __half>(phase, w, succ, rw, cw, rs, cs, B, n, s,
                                                     b, st);
  return (int)cudaErrorInvalidValue;
}
