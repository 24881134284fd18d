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
// from Dv.
//
// Design.  One thread block per (batch, head) walks the chunks itself: the
// loop replaces the Pallas kernel's sequential chunk grid axis, and the
// (Dk x Dv) float32 state lives in shared memory for the whole sequence
// instead of VMEM scratch.  q, k, v and the log decays are read in the
// model's (B, L, H, D) layout through their strides, so the Mamba2 mixer
// hands its strided views over without a transpose copy; y is written in
// that layout too.  Per chunk: the cumulative log decay (each thread sums
// its own prefix in sequence order); then 32-row query tiles, each
// streaming the 32-key tiles at or before it through shared memory (a
// lane scores one key against four query rows into a padded 32 x 33
// tile; 8 threads per query row accumulate up to 8 output columns in
// registers, for the intra term and for the state term); then the state
// update, each thread owning up to 16 state cells in registers over the
// chunk's keys.  Every shared-memory value a thread loads feeds several
// independent multiply-adds, because shared-memory bandwidth, not
// arithmetic, is what these small products run out of; each output
// still sums in the order the plain version does.
// Dk and Dv are at most 64, which covers Mamba2 (N = P = 64) and the
// reference's test shapes; larger states (mLSTM's 1024 x 1025) need
// another tiling and are refused.
//
// What bounds it.  At the serving shape (B*H = 6*112 rows, L = 32, chunk
// 16, Dk = Dv = 64, float32) the scan moves about 33 MB and does about
// 0.44 GFLOP: the bound is about 0.01 ms, set by bytes.  With one block per
// (batch, head) and two short chunks the kernel is latency-bound; the
// chunk-internal products are small enough that tensor cores (wgmma)
// would pay only for long chunks, which is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                    // query rows per tile
constexpr int kKeys = 32;                    // key rows per tile
constexpr int kDMax = 64;                    // largest Dk and Dv
constexpr int kColGroups = kThreads / kRows; // threads per query row
constexpr int kColsPerThread = kDMax / kColGroups;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerLane = kRows / kWarps; // score rows per lane
constexpr int kCellsPerThread = kDMax * kDMax / kThreads;
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

struct Strides {          // element strides of the (B, L, H, *) layouts
  long long qb, ql, qh, kb, kl, kh, vb, vl, vh, db, dl, dh;
};

size_t smem_bytes(int dk, int dv, int chunk) {
  return sizeof(float) * ((size_t)dk * dv + 2 * (size_t)chunk +
                          kRows * (dk + 1) + kKeys * (dk + 1) + kKeys * dv +
                          kRows * (kKeys + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_fwd(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ ld,
        const float* __restrict__ s_in, T* __restrict__ y,
        float* __restrict__ s_out, int H, int L, int dk, int dv, int chunk,
        Strides st) {
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
    for (int t = tid; t < n; t += kThreads) {
      float a = 0.f;
      for (int j = 0; j <= t; ++j) a += ldc[j];
      cum[t] = a;
    }

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
  static bool attr_set = false;   // per instantiation, before first launch
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gla_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  gla_fwd<T><<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)ld,
      (const float*)s_in, (T*)y, (float*)s_out, H, L, dk, dv, chunk, st);
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
