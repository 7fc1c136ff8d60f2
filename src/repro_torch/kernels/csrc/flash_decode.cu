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
//   1. split   — grid (Hkv, nsplit, B), 4 warps a CTA, one split of
//                `chunk` rows of one (b, h) a CTA; the heads of a split are
//                neighbours in launch order, so the CTAs running together
//                read whole (s, :, :) rows of the cache.  Each warp takes its own 16-row KV
//                tiles (tiles warp, warp + 4, ...) and streams them through
//                a private ring of 3 shared-memory stages with cp.async
//                16-byte copies (rows past the split's end zero-filled, no
//                global read): two tiles in flight while one is consumed.
//                Rows are stored with their 16-byte chunks XOR-swizzled by
//                row % 8, so ldmatrix and the f32 row reads are free of
//                bank conflicts.  The warps merge (m, l, acc) through
//                shared memory and write the split's partial in f32.
//   2. combine — one CTA per (b, h, q row), a thread per column: the
//                splits merged with weights exp(m_s - M), out = acc / l in
//                q's type.
//
// bf16 runs on tensor cores (mma.sync.m16n8k16, bf16 in, f32 out), in the
// FlashAttention-2 register layout: S = q·Kᵀ with the g <= 8 q rows padded
// to 16 (rows >= g are zero and never stored; the MMA's rows 8-15 go to
// dead registers), q in registers once, K by ldmatrix; the online softmax
// in f32 on the accumulator fragments (row max and sum by quad shuffles,
// expf); P rounded to bf16 in registers and reused as the A operand of
// O += P·V, V by ldmatrix.trans.  Rounding P moves each weight by at most
// 2^-9 of itself, far inside the bf16 limit.
//
// f32 keeps f32 FMAs (TF32 would break the reference's 2e-5): lane (r, h)
// of a warp dots tile row r with q over half h of hd (q staged once in
// shared memory, read as broadcasts), one shuffle joins the halves, the
// softmax reduces over the 16 rows (4 shuffles a q row and tile, not 4 a
// KV row), and P goes through shared memory to the V pass, where lane j
// owns columns j·hd/32 ...
//
// kv_len is read on the card (a device int32), as the Pallas scalar
// prefetch does: no host sync.  Rows at or past kv_len are skipped when
// kv_len >= 1: their weight exp(-1e30 - m) is exactly 0 once a real logit
// has been seen, which every split merge does.  With kv_len <= 0 every row
// is read with logit -1e30.  expf (not __expf) keeps the f32 error within
// the reference's 2e-5.
//
// Bound on this card: the K and V bytes of kv_len rows at 3.35 TB/s (a
// row's g * hd * 4 FLOP are far below the fp32 rate, let alone the tensor
// cores').  So the design keeps HBM busy: each warp has two 16-row tiles
// of copies in flight (16 KB in bf16, 32 KB in f32 at hd 128), with 8
// warps an SM in bf16 (96 KB of shared memory a CTA) and 4 in f32.
//
// Interface: plain C, pointers and the stream as void*, returns the
// cudaError_t of its launches (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;  // a CTA: one split
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;   // KV rows a warp tile
constexpr int kStages = 3;  // a warp's ring
constexpr int kG = 8;       // q rows a head group, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of row r, in rows of CPR chunks.
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  return (r * CPR + (c ^ (r & 7))) * 16;
}

// A warp's ring: kStages stages of a K tile then a V tile, kRows rows of
// HD elements each.
template <class T, int HD>
struct Ring {
  static constexpr int kCPR = HD * (int)sizeof(T) / 16;  // chunks a row
  static constexpr int kTileBytes = kRows * HD * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kBytes = kStages * kStageBytes;

  // Copies of the tile at row0 (rows at or past r1 zero-filled) into stage st.
  static __device__ __forceinline__ void load(unsigned char* ring, int st, const T* kb,
                                              const T* vb, size_t row_stride, int row0, int r1,
                                              int lane) {
    const unsigned ks = smem_u32(ring + st * kStageBytes), vs = ks + kTileBytes;
#pragma unroll
    for (int i = 0; i < kRows * kCPR / 32; ++i) {
      const int q = lane + 32 * i, r = q / kCPR, c = q % kCPR;
      const bool live = row0 + r < r1;
      const size_t off = live ? (size_t)(row0 + r) * row_stride + c * (16 / sizeof(T)) : 0;
      const int at = swz<kCPR>(r, c);
      cp_async16(ks + at, kb + off, live ? 16 : 0);
      cp_async16(vs + at, vb + off, live ? 16 : 0);
    }
  }
};

// Each warp has left (m[kG], l[kG], acc[kG][HD]) in f32 at the start of its
// ring; merge the CTA's warps and write the split's partial.
template <int HD>
__device__ __forceinline__ void merge_write(const unsigned char* rings, int ring_bytes, int g,
                                            size_t at, float* pm, float* pl, float* pacc) {
  for (int idx = threadIdx.x; idx < g * HD; idx += kThreads) {
    const int gi = idx / HD, d = idx % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, reinterpret_cast<const float*>(rings + w * ring_bytes)[gi]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* mw = reinterpret_cast<const float*>(rings + w * ring_bytes);
      const float wgt = expf(mw[gi] - M);
      den = fmaf(mw[kG + gi], wgt, den);
      num = fmaf(mw[2 * kG + gi * HD + d], wgt, num);
    }
    pacc[(at * g + gi) * HD + d] = num;
    if (d == 0) {
      pm[at * g + gi] = M;
      pl[at * g + gi] = den;
    }
  }
}

// ------------------------------------------------------------------ bf16
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (rows gid, columns 2tig, 2tig+1) += A·B for an A whose rows 8-15 are
// zero: a0 / a2 hold row gid at k 2tig.. / 8+2tig..; rows 8-15 of the
// result go to dead registers.
__device__ __forceinline__ void mma_top(float (&d)[2], unsigned a0, unsigned a2, unsigned b0,
                                        unsigned b1) {
  float dead0, dead1;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(dead0), "=f"(dead1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(d[0]), "f"(d[1]), "f"(0.f),
        "f"(0.f));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
split_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                  float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc,
                  int Hkv, int g, int S, int chunk, int nsplit, float scale) {
  using R = Ring<__nv_bfloat16, HD>;
  constexpr int KS = HD / 16, NT = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  const int kvl = *kv_len;
  const int L = kvl >= 1 ? min(kvl, S) : S;  // rows that carry weight
  const int r0 = split * chunk, r1 = min(r0 + chunk, L);
  const size_t row_stride = (size_t)Hkv * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + h) * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + h) * HD;
  unsigned char* ring = smem + warp * R::kBytes;
  const int tiles = r1 > r0 ? (r1 - r0 + kRows - 1) / kRows : 0;
  const int mine = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
  const int first = r0 + warp * kRows, step = kWarps * kRows;  // row of this warp's tile i

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) R::load(ring, s, kb, vb, row_stride, first + s * step, r1, lane);
    cp_async_commit();
  }

  unsigned qa[KS][2];  // q rows gid: a0 / a2 of each 16-column step
  const __nv_bfloat16* qrow = q + ((size_t)bh * g + gid) * HD + 2 * tig;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = gid < g ? *reinterpret_cast<const unsigned*>(qrow + ks * 16) : 0u;
    qa[ks][1] = gid < g ? *reinterpret_cast<const unsigned*>(qrow + ks * 16 + 8) : 0u;
  }
  float o[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = 0.f;
  float m = kNegInf, l = 0.f;

  // ldmatrix rows: K (non-trans) matrices [rows 0-7 | 8-15] x [chunk 2ks |
  // 2ks+1] give b0 / b1 of KV n-tiles 0 and 1; V (trans) matrices [rows
  // 0-7 | 8-15] x [chunk 2c | 2c+1] give b0 / b1 of hd n-tiles 2c, 2c+1.
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = lane >> 4;
  for (int i = 0; i < mine; ++i) {
    const int nxt = i + kStages - 1;
    if (nxt < mine) R::load(ring, nxt % kStages, kb, vb, row_stride, first + nxt * step, r1, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned ks_base = smem_u32(ring + (i % kStages) * R::kStageBytes);
    const unsigned vs_base = ks_base + R::kTileBytes;

    // KV n-tile, column 2tig + e; even and odd k-steps in two chains
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, s2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned bb[4];
      ldsm_x4(bb, ks_base + swz<R::kCPR>(k_row, 2 * ks + k_col));
      mma_top(ks % 2 ? s2[0] : s[0], qa[ks][0], qa[ks][1], bb[0], bb[1]);
      mma_top(ks % 2 ? s2[1] : s[1], qa[ks][0], qa[ks][1], bb[2], bb[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] += s2[nt][0];
      s[nt][1] += s2[nt][1];
    }

    const int row0 = first + i * step;
    float x[2][2], bm = kNegInf;
    bool ok[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + nt * 8 + 2 * tig + e;
        ok[nt][e] = r < r1;
        x[nt][e] = r < kvl ? s[nt][e] * scale : kNegInf;
        if (ok[nt][e]) bm = fmaxf(bm, x[nt][e]);
      }
    bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, 1));
    bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, 2));
    const float m_new = fmaxf(m, bm), alpha = expf(m - m_new);
    float p[2][2], ps = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = ok[nt][e] ? expf(x[nt][e] - m_new) : 0.f;
        ps += p[nt][e];
      }
    ps += __shfl_xor_sync(kFull, ps, 1);
    ps += __shfl_xor_sync(kFull, ps, 2);
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= alpha;
      o[nt][1] *= alpha;
    }
    const unsigned pa0 = pack_bf16(p[0][0], p[0][1]), pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      unsigned bb[4];
      ldsm_x4_trans(bb, vs_base + swz<R::kCPR>(v_row, 2 * c + v_col));
      mma_top(o[2 * c], pa0, pa2, bb[0], bb[1]);
      mma_top(o[2 * c + 1], pa0, pa2, bb[2], bb[3]);
    }
    __syncwarp();  // the stage is refilled next iteration
  }
  cp_async_wait<0>();
  __syncwarp();

  float* mw = reinterpret_cast<float*>(ring);
  if (tig == 0) {
    mw[gid] = m;
    mw[kG + gid] = l;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mw[2 * kG + gid * HD + nt * 8 + 2 * tig] = o[nt][0];
    mw[2 * kG + gid * HD + nt * 8 + 2 * tig + 1] = o[nt][1];
  }
  __syncthreads();
  merge_write<HD>(smem, R::kBytes, g, (size_t)bh * nsplit + split, pm, pl, pacc);
}

// ------------------------------------------------------------------- f32
// G: q rows a head group (>= g).  Shared memory: q (kG x HD), each warp's
// P (kRows x kG), then the rings.
template <int HD, int G>
__global__ void __launch_bounds__(kThreads, 1)
split_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ kv_len,
                 float* __restrict__ pm, float* __restrict__ pl, float* __restrict__ pacc, int Hkv,
                 int g, int S, int chunk, int nsplit, float scale) {
  using R = Ring<float, HD>;
  constexpr int HALF = R::kCPR / 2;  // chunks of a half row
  constexpr int DPL = HD / 32;       // V columns a lane
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = qs + kG * HD + (threadIdx.x / 32) * kRows * kG;
  unsigned char* rings = smem + (kG * HD + kWarps * kRows * kG) * sizeof(float);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int h = blockIdx.x, split = blockIdx.y, b = blockIdx.z, bh = b * Hkv + h;
  const int kvl = *kv_len;
  const int L = kvl >= 1 ? min(kvl, S) : S;
  const int r0 = split * chunk, r1 = min(r0 + chunk, L);
  const size_t row_stride = (size_t)Hkv * HD;
  const float* kb = k + ((size_t)b * S * Hkv + h) * HD;
  const float* vb = v + ((size_t)b * S * Hkv + h) * HD;
  unsigned char* ring = rings + warp * R::kBytes;
  const int tiles = r1 > r0 ? (r1 - r0 + kRows - 1) / kRows : 0;
  const int mine = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;
  const int first = r0 + warp * kRows, step = kWarps * kRows;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < mine) R::load(ring, s, kb, vb, row_stride, first + s * step, r1, lane);
    cp_async_commit();
  }
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads)
    qs[idx] = idx / HD < g ? q[(size_t)bh * g * HD + idx] : 0.f;
  __syncthreads();

  const int r = lane & 15, half = lane >> 4;  // the dot-product layout
  float acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[gi][d] = 0.f;
  }
  for (int i = 0; i < mine; ++i) {
    const int nxt = i + kStages - 1;
    if (nxt < mine) R::load(ring, nxt % kStages, kb, vb, row_stride, first + nxt * step, r1, lane);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* ks = ring + (i % kStages) * R::kStageBytes;
    const unsigned char* vs = ks + R::kTileBytes;

    float sc[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) sc[gi] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HALF; ++c) {
      const int ch = half * HALF + c;
      const float4 kv = *reinterpret_cast<const float4*>(ks + swz<R::kCPR>(r, ch));
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + gi * HD + ch * 4);
        sc[gi] = fmaf(qv.x, kv.x, sc[gi]);
        sc[gi] = fmaf(qv.y, kv.y, sc[gi]);
        sc[gi] = fmaf(qv.z, kv.z, sc[gi]);
        sc[gi] = fmaf(qv.w, kv.w, sc[gi]);
      }
    }
    const int row = first + i * step + r;
    const bool ok = row < r1;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      sc[gi] += __shfl_xor_sync(kFull, sc[gi], 16);
      const float x = row < kvl ? sc[gi] * scale : kNegInf;
      float bm = ok ? x : kNegInf;
#pragma unroll
      for (int off = 8; off > 0; off /= 2) bm = fmaxf(bm, __shfl_xor_sync(kFull, bm, off));
      const float m_new = fmaxf(m[gi], bm), alpha = expf(m[gi] - m_new);
      const float p = ok ? expf(x - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int off = 8; off > 0; off /= 2) psum += __shfl_xor_sync(kFull, psum, off);
      l[gi] = l[gi] * alpha + psum;
      m[gi] = m_new;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[gi][d] *= alpha;
      if (half == 0) ps[r * kG + gi] = p;
    }
    __syncwarp();
#pragma unroll 4
    for (int rr = 0; rr < kRows; ++rr) {
      float pv[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) pv[gi] = ps[rr * kG + gi];
      float vv[DPL];
      const float* vrow = reinterpret_cast<const float*>(
          vs + swz<R::kCPR>(rr, lane * DPL / 4) + (lane * DPL % 4) * sizeof(float));
      if constexpr (DPL == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vrow);
        vv[0] = x.x;
        vv[1] = x.y;
        vv[2] = x.z;
        vv[3] = x.w;
      } else {
        const float2 x = *reinterpret_cast<const float2*>(vrow);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[gi][d] = fmaf(pv[gi], vv[d], acc[gi][d]);
    }
    __syncwarp();  // P and the stage are rewritten next iteration
  }
  cp_async_wait<0>();
  __syncwarp();

  float* mw = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      mw[gi] = m[gi];
      mw[kG + gi] = l[gi];
    }
#pragma unroll
    for (int d = 0; d < DPL; ++d) mw[2 * kG + gi * HD + lane * DPL + d] = acc[gi][d];
  }
  __syncthreads();
  merge_write<HD>(rings, R::kBytes, g, (size_t)bh * nsplit + split, pm, pl, pacc);
}

// ---------------------------------------------------------------- combine
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One CTA per (b, h, q row), thread c owns column c: the splits' loads are
// independent, so the loops are unrolled to keep several in flight.
template <class T>
__global__ void combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                               const float* __restrict__ pacc, T* __restrict__ out, int g,
                               int hd, int nsplit) {
  const int row = blockIdx.x, bh = row / g, gi = row % g, c = threadIdx.x;
  const size_t at0 = (size_t)bh * nsplit * g + gi;  // split s at at0 + s * g
  float M = kNegInf;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[at0 + (size_t)s * g]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const size_t at = at0 + (size_t)s * g;
    const float wgt = expf(pm[at] - M);
    den = fmaf(pl[at], wgt, den);
    num = fmaf(pacc[at * hd + c], wgt, num);
  }
  store(out + (size_t)row * hd + c, num / den);
}

struct Args {
  const void *q, *k, *v;
  const int* kv_len;
  float *pm, *pl, *pacc;
  void* out;
  int B, Hkv, g, S, chunk, nsplit;
  float scale;
};

// ready: the kernel's dynamic shared-memory limit is already raised to smem
// (once a process: the first launch of each instantiation sets it).
template <class T, class Kernel>
int launch(Kernel kernel, int smem, bool& ready, int hd, const Args& a, cudaStream_t st) {
  cudaError_t err = cudaSuccess;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(a.Hkv, a.nsplit, a.B);
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                       static_cast<const T*>(a.v), a.kv_len, a.pm, a.pl, a.pacc,
                                       a.Hkv, a.g, a.S, a.chunk, a.nsplit, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<a.B * a.Hkv * a.g, hd, 0, st>>>(a.pm, a.pl, a.pacc,
                                                       static_cast<T*>(a.out), a.g, hd, a.nsplit);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t st) {
  static bool ready = false;
  return launch<__nv_bfloat16>(split_kernel_bf16<HD>, kWarps * Ring<__nv_bfloat16, HD>::kBytes,
                               ready, HD, a, st);
}

template <int HD, int G>
int launch_f32(const Args& a, cudaStream_t st) {
  static bool ready = false;
  const int smem = (kG * HD + kWarps * kRows * kG) * (int)sizeof(float) +
                   kWarps * Ring<float, HD>::kBytes;
  return launch<float>(split_kernel_f32<HD, G>, smem, ready, HD, a, st);
}

template <int HD>
int dispatch_f32(const Args& a, cudaStream_t st) {
  if (a.g <= 1) return launch_f32<HD, 1>(a, st);
  if (a.g <= 2) return launch_f32<HD, 2>(a, st);
  if (a.g <= 4) return launch_f32<HD, 4>(a, st);
  if (a.g <= 8) return launch_f32<HD, 8>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 f32, 1 bf16 (q, k, v and out).  q (B,Hkv,g,hd), k / v
// (B,S,Hkv,hd), out (B,Hkv,g,hd), contiguous, 16-byte aligned; kv_len one
// device int32; 1 <= g <= 8, hd in {64, 128}.  Scratch pm / pl
// (B*Hkv, nsplit, g) and pacc (B*Hkv, nsplit, g, hd) f32; nsplit * chunk
// >= S (flash_decode.py:split_plan).
extern "C" int flash_decode_launch(int dtype, const void* q, const void* k, const void* v,
                                   const void* kv_len, void* pm, void* pl, void* pacc, void* out,
                                   int B, int Hkv, int g, int hd, int S, int chunk, int nsplit,
                                   float scale, void* stream) {
  if (g < 1 || g > kG || chunk < 1 || nsplit < 1 || (long long)nsplit * chunk < S ||
      nsplit > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(kv_len), static_cast<float*>(pm),
               static_cast<float*>(pl), static_cast<float*>(pacc), out, B, Hkv, g, S, chunk,
               nsplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return dispatch_f32<64>(a, st);
  if (dtype == 0 && hd == 128) return dispatch_f32<128>(a, st);
  if (dtype == 1 && hd == 64) return launch_bf16<64>(a, st);
  if (dtype == 1 && hd == 128) return launch_bf16<128>(a, st);
  return (int)cudaErrorInvalidValue;
}
