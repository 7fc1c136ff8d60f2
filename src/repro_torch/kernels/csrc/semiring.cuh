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
// and rounds the result to the storage type: min-plus and max-plus add in
// f32 and round (__fadd_rn, never contracted by nvcc, then a round to
// nearest even); min / max are exact in any width and reuse the f32 steps.
// plus_mul differs by storage.  bf16: XLA does not contract c + a*b, so ⊗
// rounds and ⊕ rounds again (__fmul_rn, round, __fadd_rn, round).  f16:
// XLA's CPU backend, on a CPU with AVX-512 FP16, contracts the reference's
// jitted f16 c + a*b into one f16 FMA, rounded once from the exact value;
// here that is __hfma (HFMA: one rounding, subnormals kept) on the f16
// values, which the float registers hold exactly.  No other native 16-bit
// arithmetic (__hadd, __hmin): a 16-bit add rounds once from the exact sum,
// which can differ from f32-then-round.
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
  // plus_mul's step: ⊗ rounded, then ⊕ rounded.
  static __device__ __forceinline__ float fma(float a, float b, float acc) {
    return round(__fadd_rn(acc, round(__fmul_rn(a, b))));
  }
};
struct RoundF16 {
  static __device__ __forceinline__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  // plus_mul's step: one f16 FMA (the conversions in are exact).
  static __device__ __forceinline__ float fma(float a, float b, float acc) {
    return __half2float(__hfma(__float2half_rn(a), __float2half_rn(b), __float2half_rn(acc)));
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
    return R::fma(a, b, acc);
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

// ------------------------------------------------------- lifted operands
// A chain that reuses each operand for many relaxations (the fused round's
// register-block diag and band lanes) may keep its values lifted: every
// value it takes as an operand passes through Lifted<Op>::lift once (the
// published vectors, the staged diagonal, each shuffled value), its
// accumulators step by Lifted<Op>::relax, and put() of an accumulator, or
// lift() of it as an operand, is Op's chain value, bit for bit.  For
// most steps lift is the identity and relax Op's.  Two differ:
//
// int16 min-plus / max-plus: the sentinel tests leave the relaxation.  The
// dominant sentinel lifts to ±2^20 and the other to ∓2^17, so that a sum
// holding the dominant one lies past it, one holding only the other past
// that, and a sum of two finite values is the plain one; one clamp against
// the other sentinel then gives sat_mul's value, and the accumulator (an
// int16 value) bounds the dominant side: min(acc, clamp(x)) =
// max(min(acc, x), NINF).
//
// bf16 / f16 min-plus / max-plus: the round after min / max moves to the
// operands.  Rounding R is monotone and R(v) = v on the storage's values,
// so R(min(acc, x)) = min(R(acc), R(x)) (NaN and the ±0 rule of min.NaN /
// max.NaN included: -0 < +0 in both): an accumulator kept unrounded in f32
// rounds to the chain's value, lift rounds it where it becomes an operand,
// and put() rounds it on store.  A relaxation is then __fadd_rn and one
// min / max, as in f32.
template <class Op>
struct Lifted {
  template <class V>
  static __device__ __forceinline__ V lift(V v) { return v; }
  template <class V>
  static __device__ __forceinline__ V relax(V acc, V a, V b) { return Op::relax(acc, a, b); }
};
template <>
struct Lifted<MinPlusI16> {
  static __device__ __forceinline__ int lift(int v) {
    return v == kI16Inf ? (1 << 20) : v == kI16NInf ? -(1 << 17) : v;
  }
  static __device__ __forceinline__ int relax(int acc, int a, int b) {
    return max(min(acc, a + b), kI16NInf);
  }
};
template <>
struct Lifted<MaxPlusI16> {
  static __device__ __forceinline__ int lift(int v) {
    return v == kI16NInf ? -(1 << 20) : v == kI16Inf ? (1 << 17) : v;
  }
  static __device__ __forceinline__ int relax(int acc, int a, int b) {
    return min(max(acc, a + b), kI16Inf);
  }
};
template <class R>
struct Lifted<MinPlusH<R>> {
  static __device__ __forceinline__ float lift(float v) { return R::round(v); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return min_nan(acc, __fadd_rn(a, b));
  }
};
template <class R>
struct Lifted<MaxPlusH<R>> {
  static __device__ __forceinline__ float lift(float v) { return R::round(v); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    return max_nan(acc, __fadd_rn(a, b));
  }
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
