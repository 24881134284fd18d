// Single-token decode attention over a KV cache for Hopper (sm_90a),
// CUDA-core float32 math, the cache split across a thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:61
// (decode_attention_kernel; its body _kernel at :23) and stands in for the
// model function src/repro/models/layers.py:161 decode_attention.  One
// query token per (batch, head) attends over the cache slots that are
// valid at position pos: slot <= pos for a full cache and slot < min(pos
// + 1, L) for a ring cache, which are the same set of slots 0..L-1, so one
// rule serves both.  Masked scores are -1e30, as in the reference: with no
// valid slot (pos < 0) every score is -1e30 and the softmax averages all L
// slots.
//
// Which of the two references it follows: the model path.  layers.py:181
// rounds the normalised probabilities to the cache's type before the
// product with V; the Pallas kernel does not.  This kernel rounds them
// (a no-op for a float32 cache), with the max and the sum of the whole
// cache, and it reads each valid K slot from device memory once.
//
// Design.  One cluster of nsplit CTAs (at most 8, the portable size) per
// (batch, kv head), launched with cudaLaunchKernelEx; CTA r takes the
// contiguous slots [r * share, (r + 1) * share).  The wrapper picks nsplit
// and share from L, B * KV and the SM count, never from pos, so a step
// never waits for the host (pos is read from device memory).  Each CTA:
//   1. starts copying its first K and V tiles (up to 64 bf16 or 32 f32
//      slots, 16 KiB, in rings of up to three stages sized to the share)
//      into shared memory with cp.async, and loads the group's n_rep query
//      rows, before pos arrives: none of it depends on pos;
//   2. scores its slots tile by tile: a half warp per two slots, a lane per
//      eight head dims, all n_rep heads at once (each K row is read once
//      for the group, each query float4 feeds two slots), the 16-lane sums
//      of the n_rep heads folded by a reduce-scatter of shuffles, so n_rep
//      = 1 keeps every warp busy as well.  Scores stay in shared memory,
//      or, when the wrapper finds a share's n_rep * share floats too many
//      for it, in a scratch buffer it passes (a separate instantiation);
//   3. forms its share's max m and sum l per head, a half warp a head
//      (m = -inf, l = 0 for a share past the valid slots, which still
//      joins every barrier), and stores them into every CTA of the
//      cluster through distributed shared memory (cluster.map_shared_rank;
//      each CTA arrived on the cluster barrier when it started, so the
//      stores wait on nothing but that arrival);
//   4. after cluster.sync(), merges the ranks' (m, l) in rank order into
//      the cache's max and sum;
//   5. turns its scores into round(exp(s - m) / l) in the cache's type,
//      exactly what the model path rounds, and sums p * v over its share's
//      V tiles, a thread per (up to four heads, four dims) and slot groups
//      folded in a fixed order;
//   6. stores its partial outputs, four at a time, into the shared memory
//      of the CTA that owns each slice of the outputs; after a second
//      cluster.sync() each CTA sums the partials it received in rank order
//      and writes them.
// Unnormalised flash-decoding partials are not used: rescaling them would
// round other values than layers.py:181 does.  The cache is read in the
// model's (B, L, KV, hd) layout through its strides (rows that are not
// 16-byte aligned are copied element by element).  L may be any length;
// q may be float32 or bfloat16 over a float32 or bfloat16 cache.  hd <=
// 128 and n_rep <= 16; other shapes are refused.  The n_rep = 1, <= 4 and
// <= 16 cases are separate instantiations, so a small group does not pay
// for sixteen heads' registers.
//
// What bounds it.  Decode attention reads the valid cache once per token
// and does two FLOPs per cache element and query head each for Q.K and
// P.V: at glm4-9b's groups (n_rep 16, bf16 cache) that is 32 FLOPs per
// byte, so at long caches it sits near the ridge of bytes (3.35 TB/s) and
// float32 CUDA-core FLOPs (67 TFLOP/s).  This kernel is still far from
// both there: the scoring and P.V loops of each CTA over its share take
// most of the time (PERF.md has the phase times).  At 40 slots the work is
// a few microseconds of latency: launch, one trip to device memory and
// two cluster barriers.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kRepMax = 16;
constexpr int kHdMax = 128;
constexpr int kSplitMax = 8;                   // the portable cluster size
constexpr int kStages = 3;                     // tiles in flight per ring
constexpr int kTileBytes = 16 * 1024;          // one tile of 128-dim rows
constexpr float kNegBig = -1e30f;              // the reference's mask value

template <typename T>
__host__ __device__ constexpr int row_bytes() { return kHdMax * sizeof(T); }
template <typename T>
__host__ __device__ constexpr int tile_slots() {
  return kTileBytes / row_bytes<T>();
}

// a share's ring: tile rows and stages, from its length alone
template <typename TC>
__host__ __device__ inline void ring_shape(int share, int* tile,
                                           int* stages) {
  *tile = share < tile_slots<TC>() ? share : tile_slots<TC>();
  const int n = (share + *tile - 1) / *tile;
  *stages = n < kStages ? n : kStages;
}

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

__device__ __forceinline__ float2 unpack2(unsigned int u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// four consecutive values p[0..4) as floats, zero at and past lim; one
// 16-byte (8-byte for bf16) load when vec; p in global or shared memory
__device__ __forceinline__ float4 load4(const float* p, int lim, bool vec) {
  if (vec && lim >= 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(lim > 0 ? p[0] : 0.f, lim > 1 ? p[1] : 0.f,
                     lim > 2 ? p[2] : 0.f, lim > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int lim,
                                        bool vec) {
  if (vec && lim >= 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = unpack2(u.x), b = unpack2(u.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(lim > 0 ? load_f(p) : 0.f, lim > 1 ? load_f(p + 1) : 0.f,
                     lim > 2 ? load_f(p + 2) : 0.f,
                     lim > 3 ? load_f(p + 3) : 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n of this thread's copy groups are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// rows [j0, j0 + rows) of a share (row 0 at src) into a ring stage: 16-byte
// cp.async chunks when the rows allow, else element by element
template <typename TC>
__device__ __forceinline__ void copy_tile(char* dst, const TC* src,
                                          long long stride, int j0, int rows,
                                          int hd, bool vec, int tid) {
  if (vec) {
    const int cpr = hd * (int)sizeof(TC) / 16;   // chunks per row
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = i / cpr, c = i - r * cpr;
      cp_async16(dst + r * row_bytes<TC>() + 16 * c,
                 reinterpret_cast<const char*>(src + (j0 + r) * stride) +
                     16 * c);
    }
  } else {
    for (int i = tid; i < rows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      reinterpret_cast<TC*>(dst + r * row_bytes<TC>())[d] =
          src[(j0 + r) * stride + d];
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One step of a reduce-scatter over the lanes of a half warp: each lane
// keeps the half of its N partial sums that its bit o selects and adds
// the partner's copy of that half; with N = 1 it is a plain fold.
template <int N>
__device__ __forceinline__ void fold(float* p, int o, int hl) {
  if constexpr (N > 1) {
    const bool up = (hl & o) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float keep = up ? p[N / 2 + i] : p[i];
      const float send = up ? p[i] : p[N / 2 + i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  } else {
    p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
  }
}

// REP partial sums per lane -> lane hl of the half warp holds the 16-lane
// sum for head hl / (16 / REP): 15 shuffles for 16 heads, not 16 x 4
template <int REP>
__device__ __forceinline__ float reduce_scatter16(float* p, int hl) {
  fold<REP>(p, 8, hl);
  fold<(REP > 1 ? REP / 2 : 1)>(p, 4, hl);
  fold<(REP > 2 ? REP / 4 : 1)>(p, 2, hl);
  fold<(REP > 4 ? REP / 8 : 1)>(p, 1, hl);
  return p[0];
}

struct Strides {  // element strides: q (B, 1, H, hd), k and v (B, L, KV, hd)
  long long qb, qh, kb, kl, kh, vb, vl, vh;
};

template <int REP>
__host__ __device__ constexpr int heads_per_item() { return REP >= 4 ? 4 : 1; }

// floats of shared memory after the two rings, before the scores
template <int REP>
__host__ __device__ constexpr int fixed_floats() {
  return REP * kHdMax                 // qs
         + 2 * kSplitMax * REP + 4 * REP   // mlr, gml (padded to float4s)
         + REP * kHdMax + 4 * kSplitMax   // recv
         + kThreads * heads_per_item<REP>() * 4;   // part
}

template <typename TQ, typename TC, int REP, bool SPILL>
__global__ void __launch_bounds__(kThreads)
decode_split(const TQ* __restrict__ q, const TC* __restrict__ k,
             const TC* __restrict__ v, const int* __restrict__ pos_p,
             TQ* __restrict__ o, float* __restrict__ scratch, int KV, int L,
             int hd, int n_rep, int share, float scale, Strides st,
             int vec_i, int qvec_i) {
  constexpr int kRh = heads_per_item<REP>();
  extern __shared__ __align__(128) char smem_raw[];
  int tile, S;
  ring_shape<TC>(share, &tile, &S);
  char* kring = smem_raw;                           // S x tile rows of K
  char* vring = kring + S * tile * row_bytes<TC>(); // S x tile rows of V
  float* qs = reinterpret_cast<float*>(vring + S * tile * row_bytes<TC>());
  float* mlr = qs + REP * kHdMax;          // each rank's (m, l) per head
  float* gml = mlr + 2 * kSplitMax * REP;  // per head: the cache's (m, l)
  float* recv = gml + 4 * REP;             // partial outputs received
  float* part = recv + REP * kHdMax + 4 * kSplitMax;   // kThreads x kRh x 4
  // n_rep x share scores: shared memory unless the share is too long
  float* sc = SPILL ? scratch + (size_t)blockIdx.x * n_rep * share
                    : part + kThreads * kRh * 4;

  cg::cluster_group cluster = cg::this_cluster();
  const int nsplit = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bk = blockIdx.x / nsplit;
  const int b = bk / KV, kvh = bk - b * KV;
  const int tid = threadIdx.x;
  const bool vec = vec_i != 0;

  // the first tiles of this share do not depend on pos: start them, and
  // the query rows, before pos arrives
  const int lo = rank * share;
  const int avail = min(share, L - lo);    // this CTA's slots of the cache
  const TC* kp = k + b * st.kb + kvh * st.kh + (long long)lo * st.kl;
  const TC* vp = v + b * st.vb + kvh * st.vh + (long long)lo * st.vl;
  auto start_tile = [&](char* ring, const TC* src, long long stride, int t,
                   int rows) {
    if (rows > 0)
      copy_tile(ring + (t % S) * tile * row_bytes<TC>(), src, stride,
                t * tile, rows, hd, vec, tid);
    cp_async_commit();                     // empty groups keep the count
  };
  for (int t = 0; t < S; ++t)
    start_tile(vring, vp, st.vl, t, min(tile, avail - t * tile));
  for (int t = 0; t < S; ++t)
    start_tile(kring, kp, st.kl, t, min(tile, avail - t * tile));
  // this CTA has started: the others may store into its shared memory
  // once they have waited on this arrival
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  // the group's query rows in float32, zero past hd and n_rep: every load
  // started, and pos's, before the first store waits on one
  constexpr int kQIters = (REP * kHdMax / 4 + kThreads - 1) / kThreads;
  float4 qv[kQIters];
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int i = tid + it * kThreads;
    const int h = i / (kHdMax / 4), d = 4 * (i - h * (kHdMax / 4));
    qv[it] = load4(q + b * st.qb + (long long)(kvh * n_rep + h) * st.qh + d,
                   h < n_rep ? hd - d : 0, qvec_i != 0);
  }
  const int pos = *pos_p;
#pragma unroll
  for (int it = 0; it < kQIters; ++it) {
    const int i = tid + it * kThreads;
    if (i < REP * (kHdMax / 4)) reinterpret_cast<float4*>(qs)[i] = qv[it];
  }
  // valid slots are 0..n_valid-1; with none valid every score is -1e30 and
  // the softmax averages all L slots, so all L are visited
  const int n_valid = pos < 0 ? 0 : (pos >= L ? L : pos + 1);
  const int k_end = n_valid > 0 ? n_valid : L;
  const int cnt = max(0, min(lo + share, k_end) - lo);  // slots it visits
  const int ntile = (cnt + tile - 1) / tile;
  const int ntile_k = n_valid > 0 ? ntile : 0;  // no K when nothing is valid
  // tile t's rows once it is past the first S
  auto rows_of = [&](int t) { return t < ntile ? min(tile, cnt - t * tile)
                                               : 0; };

  // scores: half warp hw takes rows hw and hw + 16 of each 32 of a tile,
  // so each query float4 it reads feeds two rows; lane hl dims 4hl..4hl+3
  // and 64+4hl..64+4hl+3, so both reads of a row are conflict-free, as are
  // the query rows' float4s
  const int hw = tid >> 4, hl = tid & 15;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  for (int t = 0; t < ntile_k; ++t) {
    cp_async_wait(S - 1);
    __syncthreads();                       // tile t (and qs) visible
    const char* stg = kring + (t % S) * tile * row_bytes<TC>();
    const int rows = min(tile, cnt - t * tile);
    for (int r0 = 0; r0 < rows; r0 += 2 * kHalfWarps) {   // block-uniform
      float4 a[2], c[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = r0 + hw + u * kHalfWarps;
        const TC* row =
            reinterpret_cast<const TC*>(stg + r * row_bytes<TC>());
        a[u] = load4(row + 4 * hl, r < rows ? hd - 4 * hl : 0, true);
        c[u] = load4(row + 64 + 4 * hl, r < rows ? hd - 64 - 4 * hl : 0,
                     true);
      }
      float p[2][REP];
#pragma unroll
      for (int h = 0; h < REP; ++h) {
        const float4 x = q4[h * (kHdMax / 4) + hl];
        const float4 z = q4[h * (kHdMax / 4) + 16 + hl];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float s = x.x * a[u].x;
          s = fmaf(x.y, a[u].y, s);
          s = fmaf(x.z, a[u].z, s);
          s = fmaf(x.w, a[u].w, s);
          s = fmaf(z.x, c[u].x, s);
          s = fmaf(z.y, c[u].y, s);
          s = fmaf(z.z, c[u].z, s);
          s = fmaf(z.w, c[u].w, s);
          p[u][h] = s;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (r0 + u * kHalfWarps >= rows) break;      // block-uniform
        const int r = r0 + hw + u * kHalfWarps;
        const float sum = reduce_scatter16<REP>(p[u], hl);
        constexpr int kLanes = 16 / REP;             // lanes per head
        const int h = hl / kLanes;
        if (r < rows && hl % kLanes == 0 && h < n_rep)
          sc[h * share + t * tile + r] = sum * scale;
      }
    }
    __syncthreads();                       // stage t % S consumed
    start_tile(kring, kp, st.kl, t + S,
               t + S < ntile_k ? rows_of(t + S) : 0);
  }
  if (ntile_k == 0) {
    for (int i = tid; i < n_rep * cnt; i += kThreads) {
      const int h = i / cnt;
      sc[h * share + i - h * cnt] = kNegBig;
    }
  }
  __syncthreads();

  // this share's max and sum per head, a half warp a head, stored into
  // every CTA of the cluster (row rank of their mlr)
  asm volatile("barrier.cluster.wait.aligned;\n" ::);
  for (int h0 = 0; h0 < n_rep; h0 += kHalfWarps) {   // block-uniform
    const int h = h0 + hw;
    const float* s = sc + (h < n_rep ? h : 0) * share;
    float m = -INFINITY;
    for (int j = hl; j < cnt; j += 16) m = fmaxf(m, s[j]);
    m = half_warp_max(m);
    float l = 0.f;
    for (int j = hl; j < cnt; j += 16) l += expf(s[j] - m);
    l = half_warp_sum(l);
    if (hl < nsplit && h < n_rep)
      *reinterpret_cast<float2*>(cluster.map_shared_rank(mlr, hl) +
                                 2 * (rank * REP + h)) = make_float2(m, l);
  }
  cluster.sync();

  // the cache's max and sum, merged in rank order; a share with no slot
  // brings (-inf, 0), which adds 0
  if (tid < n_rep) {
    float mr[kSplitMax], lr[kSplitMax];
#pragma unroll
    for (int r = 0; r < kSplitMax; ++r) {
      if (r < nsplit) {
        const float2 x =
            *reinterpret_cast<const float2*>(mlr + 2 * (r * REP + tid));
        mr[r] = x.x;
        lr[r] = x.y;
      } else {
        mr[r] = -INFINITY;
        lr[r] = 0.f;
      }
    }
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kSplitMax; ++r) m = fmaxf(m, mr[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kSplitMax; ++r)
      if (r < nsplit) l += lr[r] * expf(mr[r] - m);
    gml[2 * tid] = m;
    gml[2 * tid + 1] = l;
  }
  __syncthreads();

  // normalised probabilities, rounded to the cache's type
  for (int i = tid; i < n_rep * cnt; i += kThreads) {
    const int h = i / cnt;
    float* s = sc + h * share + i - h * cnt;
    *s = round_to(expf(*s - gml[2 * h]) / gml[2 * h + 1], k);
  }

  // P.V over this share: item (head group hg, dims 4c..4c+3), slot group g
  // of G takes rows g, g + G, ... of each tile, so every output sums its
  // slots in order
  const int nchunk = (hd + 3) / 4;
  const int n_items = ((n_rep + kRh - 1) / kRh) * nchunk;
  const int G = max(1, kThreads / n_items);
  const int g = tid / n_items, item = tid - g * n_items;
  const bool pv = g < G;
  const int hg = item / nchunk, dv0 = 4 * (item - hg * nchunk);
  float acc[kRh][4];
#pragma unroll
  for (int r = 0; r < kRh; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait(S - 1);
    __syncthreads();                       // tile t (and p) visible
    const char* stg = vring + (t % S) * tile * row_bytes<TC>();
    const int rows = min(tile, cnt - t * tile);
    if (pv) {
      for (int r = g; r < rows; r += G) {
        const float4 x = load4(
            reinterpret_cast<const TC*>(stg + r * row_bytes<TC>()) + dv0,
            hd - dv0, true);
#pragma unroll
        for (int rr = 0; rr < kRh; ++rr) {
          const int h = hg * kRh + rr;
          const float pr = h < n_rep ? sc[h * share + t * tile + r] : 0.f;
          acc[rr][0] = fmaf(pr, x.x, acc[rr][0]);
          acc[rr][1] = fmaf(pr, x.y, acc[rr][1]);
          acc[rr][2] = fmaf(pr, x.z, acc[rr][2]);
          acc[rr][3] = fmaf(pr, x.w, acc[rr][3]);
        }
      }
    }
    __syncthreads();                       // stage t % S consumed
    start_tile(vring, vp, st.vl, t + S, rows_of(t + S));
  }
  if (pv) {
#pragma unroll
    for (int r = 0; r < kRh; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[(tid * kRh + r) * 4 + i] = acc[r][i];
  }
  __syncthreads();

  // this share's outputs go to the CTAs owning their slices (multiples of
  // four outputs), into the row of this rank, for a sum in rank order there
  const int total = n_rep * hd;
  const int per = 4 * ((total + 4 * nsplit - 1) / (4 * nsplit));
  const bool vec4 = hd % 4 == 0;           // four dims never cross a slice
  for (int it = tid; it < n_items; it += kThreads) {
    const int hg2 = it / nchunk, c4 = 4 * (it - hg2 * nchunk);
#pragma unroll
    for (int r = 0; r < kRh; ++r) {
      const int h = hg2 * kRh + r;
      if (h >= n_rep) break;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gg = 0; gg < G; ++gg) {
        const float4 x = *reinterpret_cast<const float4*>(
            part + ((gg * n_items + it) * kRh + r) * 4);
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      const int idx = h * hd + c4;
      if (vec4) {
        const int owner = idx / per;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(recv, owner) +
                                   rank * per + idx - owner * per) = s;
      } else {
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (c4 + i >= hd) break;
          const int owner = (idx + i) / per;
          cluster.map_shared_rank(recv, owner)[rank * per + idx + i -
                                               owner * per] = sv[i];
        }
      }
    }
  }
  cluster.sync();

  const int i1 = min(total, (rank + 1) * per) - rank * per;
  for (int j = tid; j < i1; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nsplit; ++r) s += recv[r * per + j];
    store_f(o + (size_t)bk * total + rank * per + j, s);
  }
  cp_async_wait(0);                // tiles past the visited slots
}

template <typename TC, int REP>
size_t smem_bytes(int n_rep, int share, bool spill) {
  int tile, S;
  ring_shape<TC>(share, &tile, &S);
  return 2 * (size_t)S * tile * row_bytes<TC>() +
         sizeof(float) * ((size_t)fixed_floats<REP>() +
                          (spill ? 0 : (size_t)n_rep * share));
}

template <typename TQ, typename TC, int REP, bool SPILL>
int launch_rep(const void* q, const void* k, const void* v, const void* pos,
               void* o, void* scratch, int B, int KV, int L, int hd,
               int n_rep, float scale, const Strides& st, int vec, int qvec,
               int nsplit, int share, void* stream) {
  auto kern = decode_split<TQ, TC, REP, SPILL>;
  static bool attr_set = false;   // per instantiation, before first launch
  if (!attr_set) {
    int dev = 0, optin = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (rc != cudaSuccess) return (int)rc;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nsplit * B * KV), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<TC, REP>(n_rep, share, SPILL);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, kern, (const TQ*)q, (const TC*)k, (const TC*)v, (const int*)pos,
      (TQ*)o, (float*)scratch, KV, L, hd, n_rep, share, scale, st, vec,
      qvec);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename TQ, typename TC>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* o, int B, int KV, int L, int hd, int n_rep, float scale,
           const long long* strides, void* stream, int nsplit, int share,
           void* scratch) {
  if (B < 1 || KV < 1 || L < 1 || hd < 1 || hd > kHdMax || n_rep < 1 ||
      n_rep > kRepMax || nsplit < 1 || nsplit > kSplitMax || share < 1 ||
      (long long)nsplit * share < L ||
      (long long)B * KV * nsplit > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the wrapper passes a scratch buffer for the scores exactly when a
  // share's do not fit in shared memory
  const bool spill = scratch != nullptr;
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5], strides[6], strides[7]};
  // rows copied in 16-byte chunks: every row start and stride on them
  bool vec = hd % 8 == 0 && aligned16(k) && aligned16(v);
  for (int i = 2; i < 8; ++i) vec = vec && strides[i] % 8 == 0;
  // q in groups of four dims (16 bytes of float32, 8 of bf16)
  const bool qvec = hd % 4 == 0 && strides[0] % 4 == 0 &&
                    strides[1] % 4 == 0 &&
                    (size_t)q % (4 * sizeof(TQ)) == 0;
#define DECODE_REP(REP)                                                     \
  return spill ? launch_rep<TQ, TC, REP, true>(                             \
                     q, k, v, pos, o, scratch, B, KV, L, hd, n_rep, scale, \
                     st, vec, qvec, nsplit, share, stream)                 \
               : launch_rep<TQ, TC, REP, false>(                            \
                     q, k, v, pos, o, scratch, B, KV, L, hd, n_rep, scale, \
                     st, vec, qvec, nsplit, share, stream)
  if (n_rep == 1) DECODE_REP(1);
  if (n_rep <= 4) DECODE_REP(4);
  DECODE_REP(16);
#undef DECODE_REP
}

}  // namespace

#define DECODE_ENTRY(name, TQ, TC)                                          \
  extern "C" int name(const void* q, const void* k, const void* v,         \
                      const void* pos, void* o, int B, int KV, int L,      \
                      int hd, int n_rep, float scale,                      \
                      const long long* strides, void* stream, int nsplit,  \
                      int share, void* scratch) {                          \
    return launch<TQ, TC>(q, k, v, pos, o, B, KV, L, hd, n_rep, scale,     \
                          strides, stream, nsplit, share, scratch);        \
  }

DECODE_ENTRY(decode_attention_f32_f32, float, float)
DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
DECODE_ENTRY(decode_attention_bf16_f32, __nv_bfloat16, float)
DECODE_ENTRY(decode_attention_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
