// Prefill flash attention for Hopper (sm_90a), CUDA-core float32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:83
// (flash_attention; its body _kernel at :27).  Same function: online
// softmax with float32 (acc, m, l) accumulators, the -1e30 mask constant,
// the max(l, 1e-30) guard, causal and sliding-window masking, GQA-native
// kv index bh / n_rep.  Beyond the Pallas kernel, ragged Sq and Sk are
// masked here instead of asserted away.
//
// Design.  One thread block per (batch*head, 16-row query tile), four
// warps of four query rows each.  K/V stream through shared memory in
// 32-key tiles, each tile read once per block from its kv head; a lane
// owns one key of the tile for the scores (q . k over head_dim) and up to
// four head dims of the output accumulator, so the softmax statistics are
// warp shuffles and every accumulator stays in registers.  K rows are
// padded by one float so the 32 lanes reading 32 different rows hit 32
// different banks.  Tiles that lie wholly outside the causal or window
// band of the query tile are skipped.
//
// What bounds it.  At the serving shapes (S = 32, head_dim 128, 32 query
// heads over 2 kv heads) the whole problem is a few MB and a few tens of
// MFLOP, so launch latency and per-block latency dominate, not bytes or
// FLOPs; tensor cores (wgmma) would pay only at long sequences, which is
// later work.  Plain FMAs keep the float32 main path close to the
// reference's float32 math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;            // query rows per block
constexpr int kBK = 32;            // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kHdMax = 128;
constexpr int kDimsPerLane = kHdMax / 32;
constexpr float kNegBig = -1e30f;  // the reference's mask constant

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int hd,
          int n_rep, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = hd + 1;
  float* qs = smem;                 // kBQ x hd, pre-scaled
  float* ks = qs + kBQ * hd;        // kBK x ldk
  float* vs = ks + kBK * ldk;       // kBK x hd

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = bh / n_rep;
  const T* qp = q + (size_t)bh * sq * hd;
  const T* kp = k + (size_t)kvh * sk * hd;
  const T* vp = v + (size_t)kvh * sk * hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i - (i / hd) * hd;
    qs[i] = (q0 + r < sq) ? load_f(qp + (size_t)(q0 + r) * hd + d) * scale : 0.f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_i[r] = kNegBig;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] = 0.f;
  }

  // key range that can be live for some row of this query tile
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();   // previous tile fully consumed (and qs written)
    for (int i = tid; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, d = i - (i / hd) * hd;
      const bool in = kt + j < sk;
      const size_t off = (size_t)(kt + j) * hd + d;
      ks[j * ldk + d] = in ? load_f(kp + off) : 0.f;
      vs[i] = in ? load_f(vp + off) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      const int qpos = q0 + row;
      if (qpos >= sq) continue;       // warp-uniform
      const int kpos = kt + lane;
      float s;
      if (kpos >= sk) {
        s = -INFINITY;                // beyond the sequence: no weight at all
      } else {
        const float* qr = qs + row * hd;
        const float* kr = ks + lane * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        bool live = true;
        if (causal && qpos < kpos) live = false;
        if (window > 0 && qpos - kpos >= window) live = false;
        s = live ? dot : kNegBig;
      }
      const float m_new = fmaxf(m_i[r], warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_i[r] - m_new);
      l_i[r] = l_i[r] * alpha + warp_sum(p);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < kDimsPerLane; ++c) acc[r][c] *= alpha;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = vs + j * hd;
#pragma unroll
        for (int c = 0; c < kDimsPerLane; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) acc[r][c] = fmaf(pj, vr[d], acc[r][c]);
        }
      }
    }
  }

  T* op = o + (size_t)bh * sq * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qpos = q0 + warp * kRowsPerWarp + r;
    if (qpos >= sq) continue;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDimsPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store_f(op + (size_t)qpos * hd + d, acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int hd, int n_rep, int causal, int window,
           float scale, void* stream) {
  if (hd < 1 || hd > kHdMax || bh < 1 || bh > 65535 || sq < 1 || sk < 1 ||
      n_rep < 1 || bh % n_rep != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const size_t smem = sizeof(float) * (kBQ * hd + kBK * (hd + 1) + kBK * hd);
  flash_fwd<T><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, hd, n_rep, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int sq,
                                   int sk, int hd, int n_rep, int causal,
                                   int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, bh, sq, sk, hd, n_rep, causal, window,
                       scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int sk, int hd, int n_rep, int causal,
                                    int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, hd, n_rep, causal,
                               window, scale, stream);
}
