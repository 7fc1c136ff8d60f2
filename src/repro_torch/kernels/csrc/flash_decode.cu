// Single-token GQA decode attention for Hopper (sm_90a): two launches.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:flash_decode
// (_decode_kernel): q (B, Hkv, g, hd) attends over k / v (B, S, Hkv, hd)
// rows [0, kv_len) with an online softmax; out (B, Hkv, g, hd) in q's type.
// Masked logits are -1e30, not -inf, as in the reference: with kv_len = 0
// every row is masked and the output is the mean of v (no NaN).
//
// The TPU kernel walks the KV blocks of one (b, h) in order on one core,
// carrying m, l and the accumulator in VMEM.  A card runs 132 SMs at once,
// and B * Hkv is small (32 at the Qwen2-7B decode shape), so the cache is
// split along S (FlashDecoding):
//
//   1. split   — grid (nsplit / 8, B * Hkv), 128 threads.  Each half-warp
//                (16 lanes) owns one split of `chunk` rows and one (b, h):
//                lane j holds hd/16 contiguous columns of every q row (q in
//                registers) and of the accumulator.  It walks its rows in
//                blocks of 16: for each row, a coalesced K row load (16
//                lanes x hd/16 values), g partial dot products, a 4-step
//                shuffle reduction; lane i keeps row i's logits.  Then one
//                online-softmax update a block (block max, expf once per
//                row and per block, f32 m, l, acc), and the V rows folded
//                in with each row's p broadcast by shuffle.  Partial (m, l,
//                acc) go to f32 scratch.
//   2. combine — one CTA per (b, h), a thread per column: the splits merged
//                with weights exp(m_s - M), out = acc / l in q's type.
//
// kv_len is read on the card (a device int32), as the Pallas scalar
// prefetch does: no host sync.  Rows at or past kv_len are skipped when
// kv_len >= 1: their weight exp(-1e30 - m) is exactly 0 once a real logit
// has been seen, which every split merge does.  With kv_len <= 0 every row
// is read with logit -1e30.  expf (not __expf) keeps the f32 error within
// the reference's 2e-5.
//
// Bound on this card: the K and V bytes of kv_len rows at 3.35 TB/s (a
// row's g * hd * 4 FLOP are far below the fp32 rate).  The split keeps
// B * Hkv * nsplit / 2 warps in flight so that enough row loads are
// outstanding; TMA / wgmma stay for later work.
//
// Interface: plain C, pointers and the stream as void*, returns the
// cudaError_t of its launches (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 8 half-warps, 8 splits a CTA
constexpr int kLanes = 16;     // lanes a row

template <int D>
__device__ __forceinline__ void load_cols(const float* p, float (&o)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    o[i] = x.x;
    o[i + 1] = x.y;
    o[i + 2] = x.z;
    o[i + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&o)[D]) {
#pragma unroll
  for (int i = 0; i < D; i += 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    o[i] = a.x;
    o[i + 1] = a.y;
    o[i + 2] = b.x;
    o[i + 3] = b.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// G: q rows a head group (>= g), D: columns a lane (hd / 16).
template <class T, int G, int D>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kv_len, float* __restrict__ pm, float* __restrict__ pl,
             float* __restrict__ pacc, int Hkv, int g, int S, int chunk, int nsplit,
             float scale) {
  constexpr int HD = kLanes * D;
  const int bh = blockIdx.y, b = bh / Hkv, h = bh % Hkv;
  const int lane = threadIdx.x % kLanes;
  const int half = (threadIdx.x % 32) / kLanes;  // which half of the warp
  const int split = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int kvl = *kv_len;
  const int L = kvl >= 1 ? min(kvl, S) : S;  // rows that carry weight
  const int r0 = split * chunk;
  const int r1 = min(r0 + chunk, L);
  const size_t row_stride = (size_t)Hkv * HD;
  const T* kb = k + ((size_t)b * S * Hkv + h) * HD + lane * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * HD + lane * D;

  float qr[G][D], acc[G][D], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      acc[gi][d] = 0.f;
      qr[gi][d] = gi < g ? to_float(q[((size_t)bh * g + gi) * HD + lane * D + d]) : 0.f;
    }
  }

  // Both half-warps run the same trip count (their shuffles span the
  // warp); rows past a half-warp's r1 are skipped and weigh nothing.
  const bool idle = __all_sync(0xffffffffu, r0 >= r1);
  const int blocks = idle ? 0 : (chunk + kLanes - 1) / kLanes;
  for (int blk = 0; blk < blocks; ++blk) {
    const int rb = r0 + blk * kLanes;
    float mine[G];  // this lane's row (rb + lane) logits
#pragma unroll
    for (int gi = 0; gi < G; ++gi) mine[gi] = kNegInf;
#pragma unroll 4
    for (int i = 0; i < kLanes; ++i) {
      const int r = rb + i;
      float kr[D];
      if (r < r1) {
        load_cols(kb + (size_t)r * row_stride, kr);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) kr[d] = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[gi][d], kr[d], s);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == i) mine[gi] = r < kvl ? s * scale : kNegInf;
      }
    }
    const bool valid = rb + lane < r1;
    float p[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float bm = valid ? mine[gi] : kNegInf;  // m >= -1e30: no valid row keeps m
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
      const float m_new = fmaxf(m[gi], bm);
      const float alpha = expf(m[gi] - m_new);
      p[gi] = valid ? expf(mine[gi] - m_new) : 0.f;
      float ps = p[gi];
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[gi] = l[gi] * alpha + ps;
      m[gi] = m_new;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[gi][d] *= alpha;
    }
#pragma unroll 4
    for (int i = 0; i < kLanes; ++i) {
      const int r = rb + i;
      float vr[D];
      if (r < r1) {
        load_cols(vb + (size_t)r * row_stride, vr);
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) vr[d] = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float pi = __shfl_sync(0xffffffffu, p[gi], half * kLanes + i);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[gi][d] = fmaf(pi, vr[d], acc[gi][d]);
      }
    }
  }

  const size_t at = (size_t)bh * nsplit + split;
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi >= g) break;
    if (lane == 0) {
      pm[at * g + gi] = m[gi];
      pl[at * g + gi] = l[gi];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) pacc[(at * g + gi) * HD + lane * D + d] = acc[gi][d];
  }
}

// One CTA per (b, h), thread c owns column c of every q row.
template <class T>
__global__ void combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                               const float* __restrict__ pacc, T* __restrict__ out, int g,
                               int hd, int nsplit) {
  const int bh = blockIdx.x, c = threadIdx.x;
  for (int gi = 0; gi < g; ++gi) {
    float M = kNegInf;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[((size_t)bh * nsplit + s) * g + gi]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = ((size_t)bh * nsplit + s) * g + gi;
      const float wgt = expf(pm[at] - M);
      den = fmaf(pl[at], wgt, den);
      num = fmaf(pacc[at * hd + c], wgt, num);
    }
    store(out + ((size_t)bh * g + gi) * hd + c, num / den);
  }
}

template <class T, int G, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len, float* pm, float* pl,
           float* pacc, void* out, int B, int Hkv, int g, int S, int chunk, int nsplit,
           float scale, cudaStream_t st) {
  const dim3 grid(nsplit / (kThreads / kLanes), B * Hkv);
  split_kernel<T, G, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len, pm,
      pl, pacc, Hkv, g, S, chunk, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<B * Hkv, kLanes * D, 0, st>>>(pm, pl, pacc, static_cast<T*>(out), g,
                                                     kLanes * D, nsplit);
  return (int)cudaGetLastError();
}

template <class T, int D>
int dispatch_g(const void* q, const void* k, const void* v, const int* kv_len, float* pm,
               float* pl, float* pacc, void* out, int B, int Hkv, int g, int S, int chunk,
               int nsplit, float scale, cudaStream_t st) {
  if (g <= 1)
    return launch<T, 1, D>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                           scale, st);
  if (g <= 2)
    return launch<T, 2, D>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                           scale, st);
  if (g <= 4)
    return launch<T, 4, D>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                           scale, st);
  if (g <= 8)
    return launch<T, 8, D>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                           scale, st);
  return (int)cudaErrorInvalidValue;
}

template <class T>
int dispatch_hd(const void* q, const void* k, const void* v, const int* kv_len, float* pm,
                float* pl, float* pacc, void* out, int B, int Hkv, int g, int hd, int S,
                int chunk, int nsplit, float scale, cudaStream_t st) {
  if (hd == 64)
    return dispatch_g<T, 4>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                            scale, st);
  if (hd == 128)
    return dispatch_g<T, 8>(q, k, v, kv_len, pm, pl, pacc, out, B, Hkv, g, S, chunk, nsplit,
                            scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32, 1 bf16 (q, k, v and out).  q (B,Hkv,g,hd), k / v
// (B,S,Hkv,hd), out (B,Hkv,g,hd), contiguous, 16-byte aligned; kv_len one
// device int32; g <= 8, hd in {64, 128}.  Scratch pm / pl (B*Hkv, nsplit,
// g) and pacc (B*Hkv, nsplit, g, hd) f32; nsplit a multiple of 8, nsplit *
// chunk >= S.
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k, const void* v,
                                   const void* kv_len, void* pm, void* pl, void* pacc, void* out,
                                   int B, int Hkv, int g, int hd, int S, int chunk, int nsplit,
                                   float scale, void* stream) {
  const int* kl = static_cast<const int*>(kv_len);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* a = static_cast<float*>(pacc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit % (kThreads / kLanes)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, kl, m, l, a, out, B, Hkv, g, hd, S, chunk, nsplit, scale,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, kl, m, l, a, out, B, Hkv, g, hd, S, chunk, nsplit,
                                      scale, st);
  return (int)cudaErrorInvalidValue;
}
