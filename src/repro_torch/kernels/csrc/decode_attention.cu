// Single-token decode attention over a KV cache for Hopper (sm_90a),
// CUDA-core float32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:61
// (decode_attention_kernel; its body _kernel at :23) and stands in for the
// model function src/repro/models/layers.py:161 decode_attention.  One
// query token per (batch, head) attends over the cache slots that are
// valid at position pos: slot <= pos for a full cache and slot < min(pos
// + 1, L) for a ring cache, which are the same set of slots 0..L-1, so one
// rule serves both.  Masked scores are -1e30, as in the reference.
//
// Which of the two references it follows: the model path.  layers.py:181
// rounds the normalised probabilities to the cache's type before the
// product with V; the Pallas kernel does not.  This kernel rounds them,
// which is a no-op for a float32 cache.  To round the normalised values it
// takes two passes over K: the first finds each head's max and sum
// (online), the second recomputes the scores and accumulates
// round(exp(s - m) / l) * v.
//
// Design.  One thread block per (batch, kv head) serves all n_rep query
// heads of that group, one warp per query head (at least four warps, so
// that a small group still loads its tiles with 128 threads), so the
// group's cache is streamed once per pass rather than once per query head
// (glm4-9b: n_rep 16, 16 warps; zamba2-7b: 1).  The cache is read in the
// model's (B, L, KV, hd) layout through its strides: no transpose copy of
// the cache per layer and step.  32-slot K and V tiles pass through shared
// memory (K rows padded by one float); a lane owns one slot of the tile
// for the scores (four partial sums over head_dim, so the dot is not one
// long dependent chain) and up to four head dims of the output, so max and
// sum are warp shuffles.  pos is read from
// device memory (an int32 the model keeps on the card), so a decode step
// never waits for the host.  L may be any length; q may be float32 or
// bfloat16 over a float32 or bfloat16 cache (float32 q over a bfloat16
// cache is the reference's default decode).  hd <= 128 and n_rep <= 16;
// other shapes are refused.
//
// What bounds it.  Decode attention reads the whole valid cache once per
// token and does two FLOPs per cache element and query head, so it is
// bound by bytes at long caches (the second pass re-reads K, up to 1.5x
// the bound).  At the cache lengths of the card check (40 slots) it is a
// few microseconds of launch latency; split-K over the cache
// (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMinWarps = 4;
constexpr int kRepMax = 16;                    // one warp per query head
constexpr int kMaxThreads = kRepMax * 32;
constexpr int kBK = 32;                        // cache slots per tile
constexpr int kHdMax = 128;
constexpr int kDimsPerLane = kHdMax / 32;
constexpr float kNegBig = -1e30f;              // the reference's mask value

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Strides {  // element strides: q (B, 1, H, hd), k and v (B, L, KV, hd)
  long long qb, qh, kb, kl, kh, vb, vl, vh;
};

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kMaxThreads)
decode_fwd(const TQ* __restrict__ q, const TC* __restrict__ k,
           const TC* __restrict__ v, const int* __restrict__ pos_p,
           TQ* __restrict__ o, int KV, int L, int hd, int n_rep, float scale,
           Strides st) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* qs = smem;                  // n_rep x hd
  float* ks = qs + n_rep * hd;       // kBK x ldk
  float* vs = ks + kBK * ldk;        // kBK x hd

  const int bk = blockIdx.x;
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const TC* kp = k + b * st.kb + kvh * st.kh;
  const TC* vp = v + b * st.vb + kvh * st.vh;
  const int tid = threadIdx.x, lane = tid & 31, g = tid >> 5;  // g: head
  const int nt = blockDim.x;
  const bool head = g < n_rep;       // warp-uniform: this warp owns head g

  const long long pos = *pos_p;
  // valid slots are 0..n_valid-1; with none valid every score is -1e30 and
  // the reference's softmax averages all L slots, so all L are visited
  const int n_valid = pos < 0 ? 0 : (int)min(pos + 1, (long long)L);
  const int k_end = n_valid > 0 ? n_valid : L;

  for (int i = tid; i < n_rep * hd; i += nt) {
    const int r = i / hd, d = i - (i / hd) * hd;
    qs[i] = load_f(q + b * st.qb + (long long)(kvh * n_rep + r) * st.qh + d);
  }

  float m = -INFINITY, l = 0.f;
  float acc[kDimsPerLane];
#pragma unroll
  for (int c = 0; c < kDimsPerLane; ++c) acc[c] = 0.f;

  // slot kt + lane's score for this warp's head: scaled dot where valid,
  // the reference's -1e30 where masked, -inf past the visited slots
  auto score = [&](int kt) {
    const int slot = kt + lane;
    if (slot >= k_end) return -INFINITY;
    if (slot >= n_valid) return kNegBig;
    const float* qr = qs + g * hd;
    const float* kr = ks + lane * ldk;
    float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
    int d = 0;
    for (; d + 4 <= hd; d += 4) {
      d0 = fmaf(qr[d], kr[d], d0);
      d1 = fmaf(qr[d + 1], kr[d + 1], d1);
      d2 = fmaf(qr[d + 2], kr[d + 2], d2);
      d3 = fmaf(qr[d + 3], kr[d + 3], d3);
    }
    for (; d < hd; ++d) d0 = fmaf(qr[d], kr[d], d0);
    return ((d0 + d1) + (d2 + d3)) * scale;
  };
  auto load_tile = [&](float* dst, int ld, const TC* src, long long sl,
                       int kt) {
    for (int i = tid; i < kBK * hd; i += nt) {
      const int j = i / hd, d = i - (i / hd) * hd;
      dst[j * ld + d] = kt + j < k_end ? load_f(src + (kt + j) * sl + d) : 0.f;
    }
  };

  // pass 1: the head's max and softmax denominator over the valid slots
  for (int kt = 0; kt < k_end; kt += kBK) {
    __syncthreads();                 // qs written / previous tile consumed
    load_tile(ks, ldk, kp, st.kl, kt);
    __syncthreads();
    if (head) {
      const float s = score(kt);
      const float m_new = fmaxf(m, warp_max(s));
      l = l * expf(m - m_new) + warp_sum(expf(s - m_new));
      m = m_new;
    }
  }

  // pass 2: normalised probabilities, rounded to the cache's type, times V
  for (int kt = 0; kt < k_end; kt += kBK) {
    __syncthreads();
    load_tile(ks, ldk, kp, st.kl, kt);
    load_tile(vs, hd, vp, st.vl, kt);
    __syncthreads();
    if (head) {
      const float p = round_to(expf(score(kt) - m) / l, k);
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * hd;
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[c] = fmaf(pj, vr[d], acc[c]);
        }
      }
    }
  }

  if (head) {
    TQ* orow = o + ((size_t)b * KV * n_rep + kvh * n_rep + g) * hd;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store_f(orow + d, acc[c]);
    }
  }
}

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, int B, int KV, int L, int hd, int n_rep, float scale,
           const long long* strides, void* stream) {
  if (B < 1 || KV < 1 || L < 1 || hd < 1 || hd > kHdMax || n_rep < 1 ||
      n_rep > kRepMax || (long long)B * KV > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = 32 * (n_rep > kMinWarps ? n_rep : kMinWarps);
  const size_t smem =
      sizeof(float) * ((size_t)n_rep * hd + kBK * (hd + 1) + kBK * hd);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  decode_fwd<TQ, TC><<<B * KV, threads, smem, (cudaStream_t)stream>>>(
      (const TQ*)q, (const TC*)k, (const TC*)v, (const int*)pos, (TQ*)o, KV,
      L, hd, n_rep, scale, st);
  return (int)cudaGetLastError();
}

}  // namespace

#define DECODE_ENTRY(name, TQ, TC)                                          \
  extern "C" int name(const void* q, const void* k, const void* v,         \
                      const void* pos, void* o, int B, int KV, int L,      \
                      int hd, int n_rep, float scale,                      \
                      const long long* strides, void* stream) {            \
    return launch<TQ, TC>(q, k, v, pos, o, B, KV, L, hd, n_rep, scale,     \
                          strides, stream);                                \
  }

DECODE_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
