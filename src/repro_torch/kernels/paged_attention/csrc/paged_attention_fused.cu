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
// sees columns below (pos >= 0 ? pos+1+t : 0), as paged_attention.py:143-146
// masks.
//
// Bound on the H100: bytes.  Each live page's K and V tile is read once
// ([P,hd] per KV head) and every score is used for one FMA row per
// element, about 4 flops per byte at the main path's K*G = 4 rows, far
// under the ~295 flops per byte where the tensor cores would bind.  The
// least time is (q + live lanes' K/V pages + new rows + out) / 3.35 TB/s.
//
// Design: the page walk, cp.async ring and ordered merges of
// paged_attention_core.cuh (one launch, merge folded in), routed by leaf
// entry: per page the warp reads entries[b,j] first and copies the K and
// V tiles from that one tier only; once a tile has landed in shared
// memory, the lanes that copied the chunks of the step's new rows that
// fall in the page overwrite them with k_new/v_new.  A live lane stops at
// its first page past pos+K-1; a parked lane reads no page and its output
// is zeros (the reference's uniform average there is never read: the
// engine drops a parked lane's logits).  At the main path's call (B=8,
// KV=8, G=4, hd=128, page 16, bf16, a 64-page bucket) that is 8 splits of
// 8 pages per (lane, kv head), 4 warps a block, 64 KB of ring.

#include "paged_attention_core.cuh"

namespace {

template <typename T>
struct FusedRoute {
  const T* fast_k;
  const T* fast_v;
  const T* slow_k;
  const T* slow_v;
  const int32_t* entries;
  int64_t es;
  const T* k_new;
  const T* v_new;
  const int32_t* pos;
  int KV, P, hd, K, NP;

  __device__ int lane(int b) const { return pos[b]; }
  __device__ int visible(int p0) const { return p0 >= 0 ? p0 + K : 0; }
  __device__ int limit(int p0, int r, int G) const {
    return p0 >= 0 ? p0 + 1 + r / G : 0;
  }
  __device__ void tiles(int b, int h, int j, const T** k,
                        const T** v) const {
    const int32_t ent = entries[(int64_t)b * es + j];
    const int64_t tile = (int64_t)P * hd;
    const int64_t off = ent >= 0 ? ((int64_t)ent * KV + h) * tile
                                 : (((int64_t)b * NP + j) * KV + h) * tile;
    *k = (ent >= 0 ? fast_k : slow_k) + off;
    *v = (ent >= 0 ? fast_v : slow_v) + off;
  }
  // the step's token whose new row is row `row` of page j, if any: it
  // replaces the staged pool row once the tile has landed
  __device__ int fresh(int j, int p0, int row) const {
    const int t = j * P + row - p0;
    return p0 >= 0 && t >= 0 && t < K ? t : -1;
  }
  __device__ void fresh_rows(int b, int h, int t, const T** k,
                             const T** v) const {
    const int64_t src = (((int64_t)b * K + t) * KV + h) * hd;
    *k = k_new + src;
    *v = v_new + src;
  }
};

template <typename T>
int run(const void* q, const void* fk, const void* fv, const void* sk,
        const void* sv, const void* entries, long long es, const void* kn,
        const void* vn, const void* pos, void* out, void* scratch,
        void* counters, int B, int K, int KV, int G, int hd, int P,
        int npages, int NP, cudaStream_t stream) {
  const FusedRoute<T> route{
      static_cast<const T*>(fk), static_cast<const T*>(fv),
      static_cast<const T*>(sk), static_cast<const T*>(sv),
      static_cast<const int32_t*>(entries), es, static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<const int32_t*>(pos), KV, P, hd,
      K, NP};
  return pa::launch<T>(static_cast<const T*>(q), route, static_cast<T*>(out),
                       static_cast<float*>(scratch),
                       static_cast<unsigned int*>(counters), B, K, KV, G, hd,
                       P, npages, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch` holds
// paged_attention_fused_scratch_floats(...) floats, `counters` B*KV
// unsigned ints, zero before the first call (each call leaves them zero).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_attention_fused(
    const void* q, const void* fast_k, const void* fast_v,
    const void* slow_k, const void* slow_v, const void* entries,
    long long entries_stride, const void* k_new, const void* v_new,
    const void* pos, void* out, void* scratch, void* counters, int B, int K,
    int KV, int G, int hd, int P, int npages, int NP, int dtype,
    void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(q, fast_k, fast_v, slow_k, slow_v, entries,
                      entries_stride, k_new, v_new, pos, out, scratch,
                      counters, B, K, KV, G, hd, P, npages, NP, s);
  return run<__nv_bfloat16>(q, fast_k, fast_v, slow_k, slow_v, entries,
                            entries_stride, k_new, v_new, pos, out, scratch,
                            counters, B, K, KV, G, hd, P, npages, NP, s);
}

// Floats of fp32 split scratch one call needs (m, l and acc per split),
// or -1 if the shape does not fit a block.
extern "C" long long paged_attention_fused_scratch_floats(
    int B, int K, int KV, int G, int hd, int P, int dtype, int npages) {
  return pa::scratch_floats(B, K, KV, G, hd, P, dtype == 0 ? 4 : 2, npages);
}
