// The semiring steps every kernel of repro_torch builds its chains from.
//
// mul(a, b) = a ⊗ b; relax(acc, a, b) = acc ⊕ (a ⊗ b).  Registers are 32
// bits wide (float or int); tiles are stored in the storage type T and
// cross into registers through widen() and back through put(), which are
// exact: a register only ever holds a value of its storage type.
//
// f32.  or_and runs on MaxMin (max/min on {0,1}).  min and max propagate
// NaN (min.NaN / max.NaN), as torch.minimum and jnp.minimum do; fminf /
// fmaxf would drop it.  On equal operands XLA's min returns -0 for (+0, -0)
// and its max +0, in either argument order; min.NaN.f32 / max.NaN.f32 do
// the same on the H100 (measured by chip_smoke.py's signed-zero phase, both
// argument orders), so they need no sign fix.  plus_mul's relax is one
// single-rounded __fmaf_rn, as XLA contracts c + a*b in the reference.
// StrictMinPlus is the successor twins' distance step, and relax_succ its
// form carrying the next hop: a candidate is taken only where it is
// strictly smaller.
//
// bf16 / f16 (RoundBf16 / RoundF16).  XLA computes each 16-bit op in f32
// and rounds the result to the storage type, and does not contract c + a*b
// there: every ⊗ and every ⊕ rounds on its own.  So each step here is an
// explicit __fadd_rn / __fmul_rn (never contracted into an FMA by nvcc)
// followed by a round to nearest even into the storage type.  min / max
// are exact in any width and reuse the f32 steps.  No native 16-bit
// arithmetic (__hadd, __hfma, __hmin): a 16-bit add rounds once from the
// exact sum, which can differ from f32-then-round.
//
// int16 (the saturating tropical lowerings).  Widen to int32, add, clamp to
// [-32768, 32767], then the sentinels override: the other sentinel first,
// the dominant one (the lowering's ⊕-identity) last, so INF ⊗ NINF is the
// ⊕-identity (repro/core/semiring.py:_sat_tropical_mul).  max_min_i16 and
// or_and_i16 are integer max/min, which cannot overflow.
//
// Packed or_and.  32 graphs per int32 word: relax = acc | (a & b).
//
// int32 (the integer storages of or_and and plus_mul: bool, int8, uint8,
// int16, int32, uint32, computed on an int32 carrier).  or_and is integer
// max/min (MaxMinI16 on int storage); plus_mul's ⊗ and ⊕ are two wrapping
// ops through unsigned (PlusMulI32), so no signed overflow occurs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// ------------------------------------------------- storage <-> registers
// Register type of a storage type: float for f32 / bf16 / f16, int for
// int16 and int32.
template <class T>
struct RegOf {
  using type = float;
};
template <>
struct RegOf<short> {
  using type = int;
};
template <>
struct RegOf<int> {
  using type = int;
};
template <class T>
using Reg = typename RegOf<T>::type;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ int widen(short x) { return x; }
__device__ __forceinline__ int widen(int x) { return x; }

__device__ __forceinline__ void put(float& d, float v) { d = v; }
__device__ __forceinline__ void put(__nv_bfloat16& d, float v) { d = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half& d, float v) { d = __float2half_rn(v); }
__device__ __forceinline__ void put(short& d, int v) { d = static_cast<short>(v); }
__device__ __forceinline__ void put(int& d, int v) { d = v; }

// ------------------------------------------------------------------- f32
struct MinPlus {
  static __device__ __forceinline__ float mul(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return min_nan(acc, __fadd_rn(a, b));
  }
};
struct MaxPlus {
  static __device__ __forceinline__ float mul(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return max_nan(acc, __fadd_rn(a, b));
  }
};
struct MaxMin {
  static __device__ __forceinline__ float mul(float a, float b) { return min_nan(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return max_nan(acc, min_nan(a, b));
  }
};
struct PlusMul {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return __fmaf_rn(a, b, acc);
  }
};
// The successor twins' distance step on Op's ⊗ (MinPlus in f32,
// MinPlusH<R> in bf16 / f16): a candidate is taken only where it is
// strictly smaller.
template <class Op>
struct Strict {
  static __device__ __forceinline__ float mul(float a, float b) { return Op::mul(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    const float cand = Op::mul(a, b);
    return cand < acc ? cand : acc;
  }
};
using StrictMinPlus = Strict<MinPlus>;

// ------------------------------------------------------------ bf16 / f16
struct RoundBf16 {
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
struct RoundF16 {
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
};

template <class R>
struct MinPlusH {
  static __device__ __forceinline__ float mul(float a, float b) { return R::round(__fadd_rn(a, b)); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return min_nan(acc, mul(a, b));
  }
};
template <class R>
struct MaxPlusH {
  static __device__ __forceinline__ float mul(float a, float b) { return R::round(__fadd_rn(a, b)); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return max_nan(acc, mul(a, b));
  }
};
template <class R>
struct PlusMulH {
  static __device__ __forceinline__ float mul(float a, float b) { return R::round(__fmul_rn(a, b)); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return R::round(__fadd_rn(acc, mul(a, b)));
  }
};

// ----------------------------------------------------------------- int16
constexpr int kI16Inf = 32767;
constexpr int kI16NInf = -32768;

template <int Dominant, int Other>
__device__ __forceinline__ int sat_mul(int a, int b) {
  int s = min(max(a + b, kI16NInf), kI16Inf);
  s = (a == Other || b == Other) ? Other : s;
  return (a == Dominant || b == Dominant) ? Dominant : s;
}

struct MinPlusI16 {
  static __device__ __forceinline__ int mul(int a, int b) { return sat_mul<kI16Inf, kI16NInf>(a, b); }
  static __device__ __forceinline__ int relax(int acc, int a, int b) { return min(acc, mul(a, b)); }
};
struct MaxPlusI16 {
  static __device__ __forceinline__ int mul(int a, int b) { return sat_mul<kI16NInf, kI16Inf>(a, b); }
  static __device__ __forceinline__ int relax(int acc, int a, int b) { return max(acc, mul(a, b)); }
};
struct MaxMinI16 {  // max_min_i16 and or_and_i16
  static __device__ __forceinline__ int mul(int a, int b) { return min(a, b); }
  static __device__ __forceinline__ int relax(int acc, int a, int b) { return max(acc, min(a, b)); }
};
struct PlusMulI32 {  // wrapping mod 2^32, as XLA's int32 add and multiply
  static __device__ __forceinline__ int mul(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ int relax(int acc, int a, int b) {
    return static_cast<int>(static_cast<unsigned>(acc) + static_cast<unsigned>(mul(a, b)));
  }
};
struct OrAndPacked {
  static __device__ __forceinline__ int mul(int a, int b) { return a & b; }
  static __device__ __forceinline__ int relax(int acc, int a, int b) { return acc | (a & b); }
};

// ------------------------------------------------------------ successors
// The strict-improvement step with its next hop: cand = a ⊗ b in Op's
// storage rounding (StrictMinPlus: f32; MinPlusH<R>: bf16 / f16).
template <class Op = StrictMinPlus>
__device__ __forceinline__ void relax_succ(float& t, int& ts, float a, int as, float b) {
  const float cand = Op::mul(a, b);
  const bool better = cand < t;
  t = better ? cand : t;
  ts = better ? as : ts;
}

}  // namespace
