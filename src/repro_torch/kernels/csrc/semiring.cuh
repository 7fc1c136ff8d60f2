// The f32 semiring steps every kernel of repro_torch builds its chains from.
//
// mul(a, b) = a ⊗ b; relax(acc, a, b) = acc ⊕ (a ⊗ b).  or_and runs on
// MaxMin (max/min on {0,1}).  min and max propagate NaN (min.NaN /
// max.NaN), as torch.minimum and jnp.minimum do; fminf/fmaxf would drop
// it.  plus_mul's relax is one single-rounded __fmaf_rn, as XLA contracts
// c + a*b in the reference.  StrictMinPlus is the successor twins'
// distance step, and relax_succ its form carrying the next hop: a
// candidate is taken only where it is strictly smaller.
#pragma once

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
struct StrictMinPlus {
  static __device__ __forceinline__ float mul(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float relax(float acc, float a, float b) {
    const float cand = __fadd_rn(a, b);
    return cand < acc ? cand : acc;
  }
};

__device__ __forceinline__ void relax_succ(float& t, int& ts, float a, int as, float b) {
  const float cand = __fadd_rn(a, b);
  const bool better = cand < t;
  t = better ? cand : t;
  ts = better ? as : ts;
}

}  // namespace
