// paged_attention_core.cuh: the device code every paged decode-attention
// kernel of the port shares: the per-page fp32 online-softmax step, the
// split-over-pages partial kernel around it, the ordered merge of the
// splits, and the launch that runs the two.  What differs between the
// kernels is only where a page's K/V tiles come from and which columns a
// query row sees; a routing functor (`Route`) supplies that:
//
//   int lane(b)                 per-lane state read once per block
//   int visible(s)              columns [0, visible) may be seen at all; a
//                               lane's walk stops at the first page at or
//                               past it (<= 0: the lane reads no page)
//   int limit(s, r, G)          query row r sees columns below limit
//   void tiles(b, h, j, &k, &v) pointers to page j's [P, hd] K/V tiles
//   void overlay(kt, vt, b, h, j, s)  rewrite rows of the staged tiles in
//                               shared memory (with its own barrier), or
//                               nothing
//
// paged_attention_fused.cu routes by leaf entry and overlays the step's
// new rows; paged_attention.cu routes by page-table slot, over two pools
// or one.  With one body for all, a one-token fused step and a split or
// unified read of the same bytes agree bit for bit.
//
// Layout: q [B,K,KV,G,hd] (K = 1 for the one-token kernels); query row
// r = t*G + g.  Scores are scaled by 1/sqrt(hd) and masked with -1e30, as
// the TPU kernels' `_softmax_step` (paged_attention.py:47) does.
//
// Design: the TPU kernels walk a lane's pages on a sequential grid axis
// with m, l and the accumulator carried in scratch.  Here each (lane, kv
// head) is cut into splits of kPagesPerSplit pages, one block per (lane,
// kv head, split), and a loop inside the block walks its pages in order
// with m, l and the accumulator in fp32 shared memory; a second kernel
// merges the splits of each (lane, kv head) in split order and writes
// acc / max(l, 1e-30) in q's dtype.  Per page the block reads the route
// first and loads K and V from one place only (the Pallas index maps fetch
// both tiers and select), with 16-byte vector loads.  A page every row
// masks, and a split holding only such pages (m = -1e30, l = 0, acc = 0),
// adds exact zeros: so a lane stops at its first such page, a live-page
// bucket equals the full width bit for bit, and only live bytes are read.
// A lane that sees nothing reads no page and its output is zeros (the
// plain versions' uniform average of stale bytes there is never read).
// Scores: one warp per (row, column) pair, lanes split hd and reduce with
// shuffles; softmax statistics: one warp per row; accumulator: one thread
// per (row, element).  No tensor cores and no TMA yet.  The kernels
// allocate nothing (the caller passes the fp32 split scratch) and run on
// the caller's stream.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pa {

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

inline size_t smem_bytes(int R, int hd, int P, size_t item) {
  return 2 * (size_t)P * hd * item
       + sizeof(float) * ((size_t)2 * R * hd + (size_t)R * P + 3 * (size_t)R);
}

inline long long n_splits(int npages) {
  return (npages + kPagesPerSplit - 1) / kPagesPerSplit;
}

inline long long scratch_floats(int B, int K, int KV, int G, int hd,
                                int npages) {
  return (long long)B * KV * n_splits(npages) * K * G * (hd + 2);
}

template <typename T, typename Route>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ q, Route route,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int n_split, int KV, int G,
               int hd, int P, int K, int npages, float scale) {
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
  const int s = route.lane(b);
  const int visible = route.visible(s);

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
    if (j * P >= visible) break;  // every later column is masked
    const T* ksrc;
    const T* vsrc;
    route.tiles(b, h, j, &ksrc, &vsrc);
    __syncthreads();  // the previous page's readers are done with the tiles
    copy_tile(kt, ksrc, tile * (int)sizeof(T));
    copy_tile(vt, vsrc, tile * (int)sizeof(T));
    __syncthreads();
    route.overlay(kt, vt, b, h, j, s);
    for (int pr = warp; pr < R * P; pr += nwarps) {
      const int r = pr / P, c = pr % P;
      float acc_s = 0.f;
      for (int d = lane; d < hd; d += 32)
        acc_s += qs[r * hd + d] * to_f(kt[c * hd + d]);
      acc_s = warp_sum(acc_s);
      if (lane == 0)
        sc[r * P + c] =
            (j * P + c < route.limit(s, r, G)) ? acc_s * scale : kNegInf;
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
combine_kernel(const float* __restrict__ part_m,
               const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out,
               int n_split, int KV, int G, int hd, int K) {
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

// The split pass, then the merge, on `stream`; `scratch` holds
// scratch_floats(B, K, KV, G, hd, npages) floats.  Returns
// cudaGetLastError() after the launches (0 on success).
template <typename T, typename Route>
int launch(const T* q, const Route& route, T* out, float* scratch, int B,
           int K, int KV, int G, int hd, int P, int npages,
           cudaStream_t stream) {
  const int R = K * G;
  const int n_split = (int)n_splits(npages);
  const size_t smem = smem_bytes(R, hd, P, sizeof(T));
  auto kern = partial_kernel<T, Route>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t parts = (size_t)B * KV * n_split * R;
  float* part_m = scratch;
  float* part_l = part_m + parts;
  float* part_acc = part_l + parts;
  const float scale = 1.0f / sqrtf((float)hd);
  if (n_split > 0)
    kern<<<dim3(B * KV, n_split), kThreads, smem, stream>>>(
        q, route, part_m, part_l, part_acc, n_split, KV, G, hd, P, K, npages,
        scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<B * KV, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, out, n_split, KV, G, hd, K);
  return (int)cudaGetLastError();
}

}  // namespace pa
