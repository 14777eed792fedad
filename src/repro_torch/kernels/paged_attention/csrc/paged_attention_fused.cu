// paged_attention_fused: K-token decode append+attend over a two-tier
// paged KV store.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py:259
// (`paged_attention_fused`, body `_fused_kernel` l.107, pallas_call l.312).
//
// Inputs: q [B,K,KV,G,hd]; fast pools [F,KV,P,hd]; slow homes
// [B*NP,KV,P,hd] (lane b page j at row b*NP+j, NP = slow rows / B even
// when npages is a bucket); entries [B,npages] int32 with row stride
// `es` (>= 0: fast slot, < 0: the slow home); k_new/v_new [B,K,KV,hd] in
// the pool dtype; pos [B] int32 (< 0 parks the lane).  Output
// [B,K,KV,G,hd] in q's dtype.  Query row r = t*G + g (token t, group g)
// sees columns below (pos >= 0 ? pos+1+t : 0); scores are scaled by
// 1/sqrt(hd) and masked with -1e30, as paged_attention.py:143-146 does.
//
// Bound on the H100: bytes.  Each live page's K and V tile is read once
// ([P,hd] per KV head) and every score is used for one FMA row per
// element, about 4 flops per byte at the main path's K*G = 4 rows, far
// under the ~295 flops per byte where the tensor cores would bind.  The
// least time is (q + live lanes' K/V pages + new rows + out) / 3.35 TB/s.
//
// Design: the TPU kernel walks a lane's pages on a sequential grid axis;
// here the pages of each (lane, kv head) are cut into splits of
// kPagesPerSplit pages, one block per (lane, kv head, split), so a long
// lane is spread over many blocks instead of waiting on its page loads one
// after another.  Inside a block a loop walks the split's pages in order
// and keeps m, l and the accumulator in fp32 shared memory; a second
// kernel merges the splits of each (lane, kv head) in split order and
// writes acc / max(l, 1e-30) in q's dtype.  Per page the block reads
// entries[b,j] first and loads the K and V tiles from that one tier only
// (the Pallas index maps fetch both tiers and select), with 16-byte
// vector loads, then overlays the new rows that fall in the page.  A live
// lane stops at the first page every row masks: such a page, and a split
// holding only such pages (m = -1e30, l = 0, acc = 0), adds exact zeros,
// so stopping changes no bit, a live-page bucket equals the full width
// bit for bit, and only live bytes are read.  A parked lane reads no
// page: its blocks write m = -1e30, l = 0, acc = 0 and its output is
// zeros (the reference's uniform average there is never read: the engine
// drops a parked lane's logits, and no check compares it).  Scores:
// one warp per (row, column) pair, lanes split hd and reduce with
// shuffles; softmax statistics: one warp per row; accumulator: one thread
// per (row, element).  No tensor cores and no TMA yet.  The kernels
// allocate nothing (the wrapper passes the fp32 split scratch) and run on
// the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kPagesPerSplit = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// copy n_bytes (a multiple of 16, both pointers 16-byte aligned)
__device__ __forceinline__ void copy_tile(void* dst, const void* src,
                                          int n_bytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n_bytes / 16; i += blockDim.x) d[i] = s[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_partial_kernel(const T* __restrict__ q,
                               const T* __restrict__ fast_k,
                               const T* __restrict__ fast_v,
                               const T* __restrict__ slow_k,
                               const T* __restrict__ slow_v,
                               const int32_t* __restrict__ entries,
                               int64_t es, const T* __restrict__ k_new,
                               const T* __restrict__ v_new,
                               const int32_t* __restrict__ pos,
                               float* __restrict__ part_m,
                               float* __restrict__ part_l,
                               float* __restrict__ part_acc, int n_split,
                               int KV, int G, int hd, int P, int K,
                               int npages, int NP, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = K * G;
  const int tile = P * hd;
  T* kt = reinterpret_cast<T*>(smem);                 // [P, hd]
  T* vt = kt + tile;                                  // [P, hd]
  float* qs = reinterpret_cast<float*>(vt + tile);    // [R, hd]
  float* acc = qs + R * hd;                           // [R, hd]
  float* sc = acc + R * hd;                           // [R, P]
  float* m = sc + R * P;                              // [R]
  float* l = m + R;                                   // [R]
  float* corr = l + R;                                // [R]

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int split = blockIdx.y;
  const int j_end = min(npages, (split + 1) * kPagesPerSplit);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int p0 = pos[b];

  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd, t = r / G, g = r % G;
    qs[e] = to_f(q[((((int64_t)b * K + t) * KV + h) * G + g) * hd + d]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (int j = split * kPagesPerSplit; j < j_end; ++j) {
    if (p0 < 0 || j * P >= p0 + K) break;  // every later column is masked
    const int32_t ent = entries[(int64_t)b * es + j];
    const int64_t off = ent >= 0 ? ((int64_t)ent * KV + h) * tile
                                 : (((int64_t)b * NP + j) * KV + h) * tile;
    const T* ksrc = (ent >= 0 ? fast_k : slow_k) + off;
    const T* vsrc = (ent >= 0 ? fast_v : slow_v) + off;
    __syncthreads();  // the previous page's readers are done with the tiles
    copy_tile(kt, ksrc, tile * (int)sizeof(T));
    copy_tile(vt, vsrc, tile * (int)sizeof(T));
    __syncthreads();
    if (p0 >= 0) {  // overlay this step's rows that land in page j
      for (int t = 0; t < K; ++t) {
        const int pg = p0 + t;
        if (pg / P != j) continue;
        const int row = pg % P;
        const int64_t src = (((int64_t)b * K + t) * KV + h) * hd;
        for (int d = tid; d < hd; d += blockDim.x) {
          kt[row * hd + d] = k_new[src + d];
          vt[row * hd + d] = v_new[src + d];
        }
      }
      __syncthreads();
    }
    for (int pr = warp; pr < R * P; pr += nwarps) {
      const int r = pr / P, c = pr % P;
      float s = 0.f;
      for (int d = lane; d < hd; d += 32)
        s += qs[r * hd + d] * to_f(kt[c * hd + d]);
      s = warp_sum(s);
      if (lane == 0) {
        const int limit = p0 >= 0 ? p0 + 1 + r / G : 0;
        sc[r * P + c] = (j * P + c < limit) ? s * scale : kNegInf;
      }
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      float mx = -INFINITY;
      for (int c = lane; c < P; c += 32) mx = fmaxf(mx, sc[r * P + c]);
      mx = warp_max(mx);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < P; c += 32) {
        const float p = expf(sc[r * P + c] - m_new);
        sc[r * P + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[r] = cr;
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += blockDim.x) {
      const int r = e / hd, d = e % hd;
      float a = 0.f;
      for (int c = 0; c < P; ++c) a += sc[r * P + c] * to_f(vt[c * hd + d]);
      acc[e] = acc[e] * corr[r] + a;
    }
  }
  __syncthreads();
  const int64_t base = ((int64_t)blockIdx.x * n_split + split) * R;
  for (int e = tid; e < R * hd; e += blockDim.x)
    part_acc[base * hd + e] = acc[e];
  for (int r = tid; r < R; r += blockDim.x) {
    part_m[base + r] = m[r];
    part_l[base + r] = l[r];
  }
}

// Merge the splits of one (lane, kv head) in split order: a split every
// row masked has m = -1e30, l = 0, acc = 0 and adds exact zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int n_split, int KV,
                               int G, int hd, int K) {
  const int R = K * G;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int64_t base = (int64_t)blockIdx.x * n_split * R;
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd, t = r / G, g = r % G;
    float mx = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, part_m[base + s * R + r]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const int64_t i = base + s * R + r;
      const float w = expf(part_m[i] - mx);
      l += part_l[i] * w;
      a += part_acc[i * hd + d] * w;
    }
    out[((((int64_t)b * K + t) * KV + h) * G + g) * hd + d] =
        from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* fk, const void* fv, const void* sk,
           const void* sv, const void* entries, long long es,
           const void* kn, const void* vn, const void* pos, void* out,
           void* scratch, int B, int K, int KV, int G, int hd, int P,
           int npages, int NP, cudaStream_t stream) {
  const int R = K * G;
  const int n_split = (npages + kPagesPerSplit - 1) / kPagesPerSplit;
  const size_t smem = 2 * (size_t)P * hd * sizeof(T)
                    + sizeof(float) * ((size_t)2 * R * hd + (size_t)R * P
                                       + 3 * (size_t)R);
  auto kern = paged_attention_partial_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t parts = (size_t)B * KV * n_split * R;
  float* part_m = static_cast<float*>(scratch);
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  const float scale = 1.0f / sqrtf((float)hd);
  if (n_split > 0)
    kern<<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(fk),
        static_cast<const T*>(fv), static_cast<const T*>(sk),
        static_cast<const T*>(sv), static_cast<const int32_t*>(entries), es,
        static_cast<const T*>(kn), static_cast<const T*>(vn),
        static_cast<const int32_t*>(pos), part_m, part_l, part_acc, n_split,
        KV, G, hd, P, K, npages, NP, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_combine_kernel<T><<<B * KV, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_split, KV, G, hd, K);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch` holds
// paged_attention_fused_scratch_floats(...) floats.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int paged_attention_fused(
    const void* q, const void* fast_k, const void* fast_v,
    const void* slow_k, const void* slow_v, const void* entries,
    long long entries_stride, const void* k_new, const void* v_new,
    const void* pos, void* out, void* scratch, int B, int K, int KV, int G,
    int hd, int P, int npages, int NP, int dtype, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, fast_k, fast_v, slow_k, slow_v, entries,
                         entries_stride, k_new, v_new, pos, out, scratch, B,
                         K, KV, G, hd, P, npages, NP, s);
  return launch<__nv_bfloat16>(q, fast_k, fast_v, slow_k, slow_v, entries,
                               entries_stride, k_new, v_new, pos, out,
                               scratch, B, K, KV, G, hd, P, npages, NP, s);
}

// Floats of fp32 split scratch one call needs: m, l and acc per split.
extern "C" long long paged_attention_fused_scratch_floats(
    int B, int K, int KV, int G, int hd, int npages) {
  const long long n_split = (npages + kPagesPerSplit - 1) / kPagesPerSplit;
  return (long long)B * KV * n_split * K * G * (hd + 2);
}
