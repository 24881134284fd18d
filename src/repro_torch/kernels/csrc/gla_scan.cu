// Chunked gated-linear-attention scan for Hopper (sm_90a), CUDA-core
// float32 math.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gla_scan.py:64
// (gla_scan; its body _kernel at :22) and stands in for the model function
// it mirrors, src/repro/models/ssm.py:22 gla_chunked:
//
//   S_t = a_t S_{t-1} + k_t v_t^T,   y_t = q_t . S_t,   a_t = exp(ld_t),
//
// computed chunk by chunk.  Inside a chunk of c steps the intra term is a
// (c x c) causal, decay-weighted product, att[t,s] = (q_t . k_s)
// exp(cum_t - cum_s) for s <= t, rounded to v's type before it meets v
// (as gla_chunked does; the Pallas kernel keeps it in float32); the inter
// term is exp(cum_t) q_t . S; then S <- exp(cum_c) S + sum_s exp(cum_c -
// cum_s) k_s v_s^T.  Beyond the Pallas kernel, and as gla_chunked does:
// L need not be a multiple of the chunk (the last chunk is shorter, which
// is exactly gla_chunked's padding with identity steps), the scan starts
// from an optional state (zero when none is given), and Dk may differ
// from Dv.  Dk and Dv are at most 64, which covers Mamba2 (N = P = 64)
// and the reference's test shapes; larger states (mLSTM's 1024 x 1025)
// need another tiling and are refused.
//
// Design.  One thread block of 256 threads per (batch, head) walks the
// chunks itself: the loop replaces the Pallas kernel's sequential chunk
// grid axis, and the (Dk x Dv) float32 state lives in shared memory for
// the whole sequence instead of VMEM scratch.  q, k, v and the log decays
// are read in the model's (B, L, H, D) layout through their strides (16-
// byte loads where the strides allow), so the Mamba2 mixer hands its
// strided views over without a transpose copy; y is written in that
// layout.  Two kernels:
//
//   gla_small, chunks of at most 32 steps (the serving path's 16): the
//   chunk's q, k and v are read from device memory once, into shared
//   memory, and serve the scores, y and the state update alike; the next
//   chunk's loads are started into registers before this chunk is
//   computed.  The cumulative log decay is summed in sequence order by
//   one thread, as the plain version's cumsum is.  Each of the three
//   products is register-blocked over the threads' actual outputs: the
//   causal scores one (t, s) entry a thread over float4 rows (k rows
//   padded by four floats, so the 16 keys a warp reads hit distinct
//   banks); y a thread per (row, four columns), reading four att values
//   and four v rows, or four q values and four state rows, per step: 20
//   floats for 64 multiply-adds; the state update a thread per 4 x 4
//   cells, reading four k values and four v values per key: 9 floats for
//   16 multiply-adds.  Every output still sums over d (and over keys) in
//   order, as before.
//
//   gla_tiled, longer chunks: 32-row query tiles stream the 32-key tiles
//   at or before them through shared memory, and the state update runs
//   over 32-key tiles.
//
// What bounds it.  At the serving shape (b = 4 of zamba2-7b's 6 users:
// 448 (batch, head) rows, L = 32, chunk 16, Dk = Dv = 64, float32) the
// scan moves about 22 MB (the final state a third of it) and does about
// 0.29 GFLOP: the card's bound is about 0.0066 ms by bytes, with the
// float32 FLOPs at 0.0043 ms close behind.  The kernel is bound inside
// the SM: its shared-memory reads (the state, read once per pair of query
// rows, the largest) and instruction rate, with three barriers a chunk; more
// blocks an SM (fewer registers, the next chunk copied by cp.async)
// barely moved it.  Tensor cores would need 3xTF32 to keep float32's
// accuracy and are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                    // gla_tiled: query rows per tile
constexpr int kKeys = 32;                    // gla_tiled: key rows per tile
constexpr int kDMax = 64;                    // largest Dk and Dv
constexpr int kColGroups = kThreads / kRows; // threads per query row
constexpr int kColsPerThread = kDMax / kColGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = kRows / kWarps; // score rows per lane
constexpr int kCellsPerThread = kDMax * kDMax / kThreads;
constexpr int kSmallChunk = 32;              // longest chunk of gla_small
constexpr int kSmemMax = 200 * 1024;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// the value a float takes once stored in T
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 unpack2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
__device__ __forceinline__ unsigned int pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

// four consecutive values as floats, zero at and past lim; one 16-byte
// (8-byte for bf16) load when vec
__device__ __forceinline__ float4 load4(const float* p, int lim, bool vec) {
  if (vec && lim >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(lim > 0 ? p[0] : 0.f, lim > 1 ? p[1] : 0.f,
                     lim > 2 ? p[2] : 0.f, lim > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int lim,
                                        bool vec) {
  if (vec && lim >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = unpack2(u.x), b = unpack2(u.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(lim > 0 ? load_f(p) : 0.f, lim > 1 ? load_f(p + 1) : 0.f,
                     lim > 2 ? load_f(p + 2) : 0.f,
                     lim > 3 ? load_f(p + 3) : 0.f);
}

// the first min(lim, 4) of four values
__device__ __forceinline__ void store4(float* p, float4 x, int lim,
                                       bool vec) {
  if (vec && lim >= 4) {
    *reinterpret_cast<float4*>(p) = x;
    return;
  }
  if (lim > 0) p[0] = x.x;
  if (lim > 1) p[1] = x.y;
  if (lim > 2) p[2] = x.z;
  if (lim > 3) p[3] = x.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x, int lim,
                                       bool vec) {
  if (vec && lim >= 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(x.x, x.y),
                                              pack2(x.z, x.w));
    return;
  }
  if (lim > 0) store_f(p, x.x);
  if (lim > 1) store_f(p + 1, x.y);
  if (lim > 2) store_f(p + 2, x.z);
  if (lim > 3) store_f(p + 3, x.w);
}

// cum[0..n) = the prefix sums of ldc[0..n), summed in sequence order by
// one thread: the plain version's cumsum adds in that order, and exp()
// of these sums magnifies any other rounding (a parallel scan's put the
// 2048-step scan 2.8e-4 off)
__device__ __forceinline__ void chunk_cumsum(const float* ldc, float* cum,
                                             int n, int tid) {
  if (tid == 0) {
    float a = 0.f;
    for (int t = 0; t < n; ++t) {
      a += ldc[t];
      cum[t] = a;
    }
  }
}

struct Strides {          // element strides of the (B, L, H, *) layouts
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

size_t small_smem_bytes(int dk, int dv, int chunk) {
  const size_t dk4 = round4(dk), dv4 = round4(dv), c4 = round4(chunk);
  return sizeof(float) * (dk4 * dv4 + 2 * chunk * (dk4 + 4) + c4 * dv4 +
                          chunk * (c4 + 4) + 3 * (size_t)chunk);
}

size_t tiled_smem_bytes(int dk, int dv, int chunk) {
  return sizeof(float) * ((size_t)dk * dv + 2 * (size_t)chunk +
                          kRows * (dk + 1) + kKeys * (dk + 1) + kKeys * dv +
                          kRows * (kKeys + 1));
}

size_t smem_bytes(int dk, int dv, int chunk) {
  return chunk <= kSmallChunk ? small_smem_bytes(dk, dv, chunk)
                              : tiled_smem_bytes(dk, dv, chunk);
}

// RT: query rows per thread in the y phase (1 for chunks <= 16, else 2)
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
gla_small(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ ld,
          const float* __restrict__ s_in, T* __restrict__ y,
          float* __restrict__ s_out, int H, int L, int dk, int dv, int chunk,
          Strides st, int vec_i) {
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_i != 0;
  const int dk4 = round4(dk), dv4 = round4(dv);
  const int C = chunk, C4 = round4(chunk);
  const int ldq = dk4 + 4, lda = C4 + 4;  // padded: column reads of 8 rows
  float* S = smem;                        // dk4 x dv4 state, pads zero
  float* qs = S + dk4 * dv4;              // C x ldq
  float* ks = qs + C * ldq;               // C x ldq
  float* vs = ks + C * ldq;               // C4 x dv4, rows past the chunk 0
  float* att = vs + C4 * dv4;             // C x lda, zero where s > t
  float* cum = att + C * lda;             // cumulative log decays
  float* gq = cum + C;                    // exp(cum_t)
  float* wk = gq + C;                     // exp(total - cum_s)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* dp = ld + b * st.db + h * st.dh;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nq = dk4 / 4, nv = dv4 / 4;   // float4 groups per row
  // y phase: row r16 (+ 16), columns 4 c16..; state: cells 4 r16.., 4 c16..
  const int r16 = tid >> 4, c16 = tid & 15;

  for (int i = tid; i < dk4 * dv4; i += kThreads) {
    const int d = i / dv4, e = i - (i / dv4) * dv4;
    S[i] = s_in && d < dk && e < dv ? s_in[(size_t)bh * dk * dv + d * dv + e]
                                    : 0.f;
  }

  // one chunk's q, k, v and log decays, in registers until stashed
  float4 pq[RT], pk[RT], pv[RT];
  float pld = 0.f;
  auto fetch = [&](int c1, int n1) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int gi = tid + kThreads * i;
      int row = gi / nq, j = gi - row * nq;
      int lim = row < n1 ? dk - 4 * j : 0;
      pq[i] = load4(qp + (long long)(c1 + row) * st.ql + 4 * j, lim, vec);
      pk[i] = load4(kp + (long long)(c1 + row) * st.kl + 4 * j, lim, vec);
      row = gi / nv;
      j = gi - row * nv;
      lim = row < n1 ? dv - 4 * j : 0;
      pv[i] = load4(vp + (long long)(c1 + row) * st.vl + 4 * j, lim, vec);
    }
    if (tid < 32) pld = tid < n1 ? dp[(long long)(c1 + tid) * st.dl] : 0.f;
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int gi = tid + kThreads * i;
      int row = gi / nq, j = gi - row * nq;
      if (row < C) {
        *reinterpret_cast<float4*>(qs + row * ldq + 4 * j) = pq[i];
        *reinterpret_cast<float4*>(ks + row * ldq + 4 * j) = pk[i];
      }
      row = gi / nv;
      j = gi - row * nv;
      if (row < C4) *reinterpret_cast<float4*>(vs + row * dv4 + 4 * j) = pv[i];
    }
  };

  fetch(0, min(C, L));
  for (int c0 = 0; c0 < L; c0 += C) {
    const int n = min(C, L - c0);        // a short last chunk = identity pad
    stash();
    if (tid < 32) {
      // cumulative log decay, added one step at a time in sequence order
      // as the plain version's cumsum is (see chunk_cumsum); the shuffles
      // do not wait on the sum, only the adds chain
      float a = 0.f, x = 0.f;
#pragma unroll
      for (int t = 0; t < 16 * RT; ++t) {  // the longest chunk RT serves
        const float d = __shfl_sync(0xffffffffu, pld, t);
        if (t < n) a += d;
        if (lane == t) x = a;
      }
      if (lane < n) {
        cum[lane] = x;
        gq[lane] = expf(x);
        wk[lane] = expf(a - x);
      }
    }
    if (c0 + C < L) fetch(c0 + C, min(C, L - c0 - C));
    __syncthreads();                     // chunk staged, S updated

    // ---- causal decay-weighted scores, rounded to v's type
    for (int i = tid; i < n * C4; i += kThreads) {
      const int t = i / C4, s = i - (i / C4) * C4;
      float a = 0.f;
      if (s <= t) {
        const float4* qr = reinterpret_cast<const float4*>(qs + t * ldq);
        const float4* kr = reinterpret_cast<const float4*>(ks + s * ldq);
        float dot = 0.f;
        for (int j = 0; j < nq; ++j) {
          const float4 x = qr[j], z = kr[j];
          dot = fmaf(x.x, z.x, dot);
          dot = fmaf(x.y, z.y, dot);
          dot = fmaf(x.z, z.z, dot);
          dot = fmaf(x.w, z.w, dot);
        }
        a = round_to(dot * expf(cum[t] - cum[s]), v);
      }
      att[t * lda + s] = a;
    }
    __syncthreads();

    // ---- y = att . v (intra) + exp(cum_t) q_t . S (inter)
    const int e0 = 4 * c16;
    if (e0 < dv) {
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int t = r16 + 16 * i;
        if (t >= n) break;
        float in[4] = {0.f, 0.f, 0.f, 0.f}, it[4] = {0.f, 0.f, 0.f, 0.f};
        const float* ar = att + t * lda;
        for (int s = 0; s <= t; s += 4) {  // att is zero past t
          const float4 a4 = *reinterpret_cast<const float4*>(ar + s);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vs + (s + u) * dv4 + e0);
            in[0] = fmaf(av[u], v4.x, in[0]);
            in[1] = fmaf(av[u], v4.y, in[1]);
            in[2] = fmaf(av[u], v4.z, in[2]);
            in[3] = fmaf(av[u], v4.w, in[3]);
          }
        }
        const float g = gq[t];
        const float* qr = qs + t * ldq;
        for (int d = 0; d < dk4; d += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float qd = qv[u] * g;
            const float4 s4 =
                *reinterpret_cast<const float4*>(S + (d + u) * dv4 + e0);
            it[0] = fmaf(qd, s4.x, it[0]);
            it[1] = fmaf(qd, s4.y, it[1]);
            it[2] = fmaf(qd, s4.z, it[2]);
            it[3] = fmaf(qd, s4.w, it[3]);
          }
        }
        store4(y + (((size_t)b * L + c0 + t) * H + h) * dv + e0,
               make_float4(in[0] + it[0], in[1] + it[1], in[2] + it[2],
                           in[3] + it[3]),
               dv - e0, vec);
      }
    }

    // ---- state: S <- exp(total) S + sum_s (k_s exp(total - cum_s)) v_s^T
    const int ds = 4 * r16;
    const bool cells = ds < dk4 && e0 < dv4;
    float upd[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) upd[a][c] = 0.f;
    if (cells) {
      for (int s = 0; s < n; ++s) {
        const float w = wk[s];
        const float4 k4 = *reinterpret_cast<const float4*>(ks + s * ldq + ds);
        const float4 v4 = *reinterpret_cast<const float4*>(vs + s * dv4 + e0);
        const float kw[4] = {k4.x * w, k4.y * w, k4.z * w, k4.w * w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) upd[a][c] = fmaf(kw[a], vv[c], upd[a][c]);
      }
    }
    const float decay = expf(cum[n - 1]);
    __syncthreads();                     // every y row has read S
    if (cells) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* sp = S + (ds + a) * dv4 + e0 + c;
          *sp = *sp * decay + upd[a][c];
        }
    }
  }

  // each thread writes the cells it updated last
  const int ds = 4 * r16, e0 = 4 * c16;
  if (ds < dk && e0 < dv) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (ds + a >= dk) break;
      store4(s_out + (size_t)bh * dk * dv + (size_t)(ds + a) * dv + e0,
             *reinterpret_cast<const float4*>(S + (ds + a) * dv4 + e0),
             dv - e0, vec);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_tiled(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ ld,
          const float* __restrict__ s_in, T* __restrict__ y,
          float* __restrict__ s_out, int H, int L, int dk, int dv, int chunk,
          Strides st, int /* vec: scalar loads only */) {
  extern __shared__ float smem[];
  float* S = smem;                       // dk x dv state
  float* ldc = S + dk * dv;              // chunk log decays
  float* cum = ldc + chunk;              // chunk cumulative log decays
  float* qs = cum + chunk;               // kRows x (dk + 1)
  float* ks = qs + kRows * (dk + 1);     // kKeys x (dk + 1)
  float* vs = ks + kKeys * (dk + 1);     // kKeys x dv
  float* att = vs + kKeys * dv;          // kRows x (kKeys + 1)
  // rows padded by one float: threads reading one column of several rows
  // hit different banks
  const int ldk = dk + 1, lda = kKeys + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + h * st.kh;
  const T* vp = v + b * st.vb + h * st.vh;
  const float* dp = ld + b * st.db + h * st.dh;
  const int tid = threadIdx.x;
  const int tr = tid / kColGroups;       // query row of this thread
  const int tc = tid - tr * kColGroups;  // its first output column
  const int cells = dk * dv;
  // this thread's state cells tid + 256 i as (row d, column e)
  const int d0 = tid / dv, e0 = tid - (tid / dv) * dv;
  const int step_d = kThreads / dv, step_e = kThreads - step_d * dv;

  for (int i = tid; i < cells; i += kThreads)
    S[i] = s_in ? s_in[(size_t)bh * cells + i] : 0.f;

  for (int c0 = 0; c0 < L; c0 += chunk) {
    const int n = min(chunk, L - c0);    // a short last chunk = identity pad
    __syncthreads();                     // previous chunk done with S, cum
    for (int t = tid; t < n; t += kThreads) ldc[t] = dp[(c0 + t) * st.dl];
    __syncthreads();
    chunk_cumsum(ldc, cum, n, tid);

    // ---- y: intra-chunk decay-masked product + inter-chunk state term
    for (int r0 = 0; r0 < n; r0 += kRows) {
      const int rows = min(kRows, n - r0);
      __syncthreads();                   // cum written, previous tile read
      for (int i = tid; i < kRows * dk; i += kThreads) {
        const int r = i / dk, d = i - (i / dk) * dk;
        qs[r * ldk + d] =
            r < rows ? load_f(qp + (c0 + r0 + r) * st.ql + d) : 0.f;
      }
      float acc[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) acc[c] = 0.f;

      for (int s0 = 0; s0 < r0 + rows; s0 += kKeys) {
        const int keys = min(kKeys, n - s0);
        __syncthreads();
        for (int i = tid; i < kKeys * dk; i += kThreads) {
          const int j = i / dk, d = i - (i / dk) * dk;
          ks[j * ldk + d] = j < keys ? load_f(kp + (c0 + s0 + j) * st.kl + d)
                                     : 0.f;
        }
        for (int i = tid; i < kKeys * dv; i += kThreads) {
          const int j = i / dv, e = i - (i / dv) * dv;
          vs[i] = j < keys ? load_f(vp + (c0 + s0 + j) * st.vl + e) : 0.f;
        }
        __syncthreads();
        {
          // scores: lane j's key against rows rw, rw + 8, ...: each k
          // element read once feeds kRowsPerLane multiply-adds
          const int j = tid & 31, rw = tid >> 5, s = s0 + j;
          float dot[kRowsPerLane];
#pragma unroll
          for (int m = 0; m < kRowsPerLane; ++m) dot[m] = 0.f;
          if (j < keys) {
            const float* kr = ks + j * ldk;
            for (int d = 0; d < dk; ++d) {
              const float kd = kr[d];
#pragma unroll
              for (int m = 0; m < kRowsPerLane; ++m)
                if (rw + kWarps * m < rows)
                  dot[m] = fmaf(qs[(rw + kWarps * m) * ldk + d], kd, dot[m]);
            }
          }
#pragma unroll
          for (int m = 0; m < kRowsPerLane; ++m) {
            const int r = rw + kWarps * m, t = r0 + r;
            att[r * lda + j] =
                r < rows && j < keys && s <= t
                    ? round_to(dot[m] * expf(cum[t] - cum[s]), v)
                    : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < keys; ++j) {
          const float p = att[tr * lda + j];
          const float* vr = vs + j * dv;
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const int e = tc + kColGroups * c;
            if (e < dv) acc[c] = fmaf(p, vr[e], acc[c]);
          }
        }
      }

      if (tr < rows) {
        // inter-chunk term: each (q_t exp(cum_t))_d read once feeds this
        // thread's columns; every column still sums d in order
        const int t = r0 + tr;
        const float g = expf(cum[t]);
        const float* qr = qs + tr * ldk;
        float inter[kColsPerThread];
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) inter[c] = 0.f;
        for (int d = 0; d < dk; ++d) {
          const float qd = qr[d] * g;
          const float* Sr = S + d * dv;
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            const int e = tc + kColGroups * c;
            if (e < dv) inter[c] = fmaf(qd, Sr[e], inter[c]);
          }
        }
        T* yr = y + (((size_t)b * L + c0 + t) * H + h) * dv;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int e = tc + kColGroups * c;
          if (e < dv) store_f(yr + e, acc[c] + inter[c]);
        }
      }
    }

    // ---- state: S <- exp(total) S + sum_s (k_s exp(total - cum_s)) v_s^T
    const float total = cum[n - 1];
    float upd[kCellsPerThread];
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) upd[i] = 0.f;
    for (int s0 = 0; s0 < n; s0 += kKeys) {
      const int keys = min(kKeys, n - s0);
      __syncthreads();                   // y phase done with ks, vs, S
      for (int i = tid; i < kKeys * dk; i += kThreads) {
        const int j = i / dk, d = i - (i / dk) * dk;
        ks[j * ldk + d] =
            j < keys ? load_f(kp + (c0 + s0 + j) * st.kl + d) *
                           expf(total - cum[s0 + j])
                     : 0.f;
      }
      for (int i = tid; i < kKeys * dv; i += kThreads) {
        const int j = i / dv, e = i - (i / dv) * dv;
        vs[i] = j < keys ? load_f(vp + (c0 + s0 + j) * st.vl + e) : 0.f;
      }
      __syncthreads();
      // key by key over this thread's 16 cells: 16 independent chains,
      // each cell still summing its keys in order; cell tid + 256 i is
      // (d, e), stepped from (d0, e0) without a division per key
      for (int j = 0; j < keys; ++j) {
        const float* kr = ks + j * ldk;
        const float* vr = vs + j * dv;
        int d = d0, e = e0;
#pragma unroll
        for (int i = 0; i < kCellsPerThread; ++i) {
          if (d < dk) upd[i] = fmaf(kr[d], vr[e], upd[i]);
          d += step_d;
          e += step_e;
          if (e >= dv) {
            e -= dv;
            ++d;
          }
        }
      }
    }
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < kCellsPerThread; ++i) {
      const int cell = tid + kThreads * i;
      if (cell < cells) S[cell] = S[cell] * decay + upd[i];
    }
  }

  __syncthreads();
  for (int i = tid; i < cells; i += kThreads)
    s_out[(size_t)bh * cells + i] = S[i];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ld,
           const void* s_in, void* y, void* s_out, int B, int H, int L,
           int dk, int dv, int chunk, const long long* strides,
           void* stream) {
  if (B < 1 || H < 1 || L < 1 || dk < 1 || dk > kDMax || dv < 1 ||
      dv > kDMax || chunk < 1 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(dk, dv, chunk);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  // 16-byte (bf16: 8-byte) groups of four: row starts and strides on them
  const size_t align = 4 * sizeof(T);
  bool vec = dk % 4 == 0 && dv % 4 == 0 && (size_t)q % align == 0 &&
             (size_t)k % align == 0 && (size_t)v % align == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 4 == 0;
  void (*kern)(const T*, const T*, const T*, const float*, const float*, T*,
               float*, int, int, int, int, int, Strides, int);
  const int which = chunk <= 16 ? 0 : chunk <= kSmallChunk ? 1 : 2;
  if (which == 0)
    kern = gla_small<T, 1>;
  else if (which == 1)
    kern = gla_small<T, 2>;
  else
    kern = gla_tiled<T>;
  static bool attr_set[3] = {false, false, false};  // per kernel, once
  if (!attr_set[which]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return (int)rc;
    attr_set[which] = true;
  }
  kern<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)s_in, (T*)y, (float*)s_out, H, L, dk, dv, chunk, st,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" unsigned long long gla_scan_smem_bytes(int dk, int dv, int chunk) {
  return (unsigned long long)smem_bytes(dk, dv, chunk);
}

extern "C" int gla_scan_f32(const void* q, const void* k, const void* v,
                            const void* ld, const void* s_in, void* y,
                            void* s_out, int B, int H, int L, int dk, int dv,
                            int chunk, const long long* strides,
                            void* stream) {
  return launch<float>(q, k, v, ld, s_in, y, s_out, B, H, L, dk, dv, chunk,
                       strides, stream);
}

extern "C" int gla_scan_bf16(const void* q, const void* k, const void* v,
                             const void* ld, const void* s_in, void* y,
                             void* s_out, int B, int H, int L, int dk, int dv,
                             int chunk, const long long* strides,
                             void* stream) {
  return launch<__nv_bfloat16>(q, k, v, ld, s_in, y, s_out, B, H, L, dk, dv,
                               chunk, strides, stream);
}
