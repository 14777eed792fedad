// paged_attention / paged_attention_split: one-token decode attention over
// a paged KV store, read through a translated page table.
//
// Replaces the TPU kernels repro/kernels/paged_attention/paged_attention.py
// :164 (`paged_attention`, body `_kernel` l.83: one unified pool) and :206
// (`paged_attention_split`, body `_split_kernel` l.93: the fast and slow
// pools as separate operands, each page routed by `slot < fast_slots`).
//
// Inputs: q [B,KV,G,hd]; page_table [B,npages] int32 with row stride `es`,
// slots in the unified index space (< fast_slots: fast pool row, else
// slow pool row slot - fast_slots); seq_lens [B] int32.  Split: fast
// pools [fast_slots,KV,P,hd] and slow pools [n_slow,KV,P,hd]; unified: one
// pool [n_slots,KV,P,hd] per K and V.  Output [B,KV,G,hd] in q's dtype:
// each query row sees columns below seq_lens[b].  Slots must lie inside
// their pool; the kernel does not check them (the Pallas kernels do not
// either: the page table comes from the iRT/iRC translation).
//
// Bound on the H100: bytes.  Each live page's K and V tile is read once;
// at G = 4 query rows a page costs about 4 flops per byte, far under the
// ~295 flops per byte where the tensor cores would bind.  The least time
// is (q + live lanes' K/V pages + their page-table entries + out) / 3.35
// TB/s.
//
// Design: the page walk, cp.async ring and ordered merges of
// paged_attention_core.cuh (the fused kernel's body, one launch), with
// K = 1 and no overlay.  The split route picks the tier BEFORE the load:
// one tier's tiles are read per page, where the Pallas index maps fetch
// both and select.  The split and unified entry points share every instruction
// after the tile pointers, so a split read equals a unified read of the
// concatenated pools bit for bit.  A lane stops at page
// ceil(seq_len / P); seq_lens are read on the card.  A lane with
// seq_len <= 0 reads no page and its output is zeros (the reference's
// uniform average of stale bytes there is never read).

#include "paged_attention_core.cuh"

namespace {

// mask by sequence length: row r of lane b sees columns below seq_lens[b]
template <typename T>
struct SeqLenMask {
  const int32_t* seq_lens;

  __device__ int lane(int b) const { return seq_lens[b]; }
  __device__ int visible(int n) const { return n; }
  __device__ int limit(int n, int, int) const { return n; }
  __device__ int fresh(int, int, int) const { return -1; }
  __device__ void fresh_rows(int, int, int, const T** k, const T** v) const {
    *k = *v = nullptr;
  }
};

template <typename T>
struct SplitRoute : SeqLenMask<T> {
  const T* fast_k;
  const T* fast_v;
  const T* slow_k;
  const T* slow_v;
  const int32_t* table;
  int64_t es;
  int fast_slots, KV, P, hd;

  __device__ void tiles(int b, int h, int j, const T** k,
                        const T** v) const {
    const int32_t slot = table[(int64_t)b * es + j];
    const bool fast = slot < fast_slots;
    const int64_t row = fast ? slot : slot - fast_slots;
    const int64_t off = (row * KV + h) * (int64_t)P * hd;
    *k = (fast ? fast_k : slow_k) + off;
    *v = (fast ? fast_v : slow_v) + off;
  }
};

template <typename T>
struct UnifiedRoute : SeqLenMask<T> {
  const T* pool_k;
  const T* pool_v;
  const int32_t* table;
  int64_t es;
  int KV, P, hd;

  __device__ void tiles(int b, int h, int j, const T** k,
                        const T** v) const {
    const int64_t slot = table[(int64_t)b * es + j];
    const int64_t off = (slot * KV + h) * (int64_t)P * hd;
    *k = pool_k + off;
    *v = pool_v + off;
  }
};

template <typename T>
int run_split(const void* q, const void* fk, const void* fv, const void* sk,
              const void* sv, const void* table, long long es,
              const void* seq_lens, void* out, void* scratch,
              void* counters, int B, int KV, int G, int hd, int P, int npages,
              int fast_slots, cudaStream_t stream) {
  const SplitRoute<T> route{
      {static_cast<const int32_t*>(seq_lens)}, static_cast<const T*>(fk),
      static_cast<const T*>(fv), static_cast<const T*>(sk),
      static_cast<const T*>(sv), static_cast<const int32_t*>(table), es,
      fast_slots, KV, P, hd};
  return pa::launch<T>(static_cast<const T*>(q), route, static_cast<T*>(out),
                       static_cast<float*>(scratch),
                       static_cast<unsigned int*>(counters), B, 1, KV, G, hd,
                       P, npages, stream);
}

template <typename T>
int run_unified(const void* q, const void* pk, const void* pv,
                const void* table, long long es, const void* seq_lens,
                void* out, void* scratch, void* counters, int B, int KV,
                int G, int hd, int P, int npages, cudaStream_t stream) {
  const UnifiedRoute<T> route{
      {static_cast<const int32_t*>(seq_lens)}, static_cast<const T*>(pk),
      static_cast<const T*>(pv), static_cast<const int32_t*>(table), es, KV,
      P, hd};
  return pa::launch<T>(static_cast<const T*>(q), route, static_cast<T*>(out),
                       static_cast<float*>(scratch),
                       static_cast<unsigned int*>(counters), B, 1, KV, G, hd,
                       P, npages, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `scratch` holds
// paged_attention_scratch_floats(...) floats, `counters` B*KV unsigned
// ints, zero before the first call (each call leaves them zero).  Each
// returns cudaGetLastError() after its launch (0 on success).
extern "C" int paged_attention_split(
    const void* q, const void* fast_k, const void* fast_v,
    const void* slow_k, const void* slow_v, const void* page_table,
    long long table_stride, const void* seq_lens, void* out, void* scratch,
    void* counters, int B, int KV, int G, int hd, int P, int npages,
    int fast_slots, int dtype, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_split<float>(q, fast_k, fast_v, slow_k, slow_v, page_table,
                            table_stride, seq_lens, out, scratch, counters, B,
                            KV, G, hd, P, npages, fast_slots, s);
  return run_split<__nv_bfloat16>(q, fast_k, fast_v, slow_k, slow_v,
                                  page_table, table_stride, seq_lens, out,
                                  scratch, counters, B, KV, G, hd, P, npages,
                                  fast_slots, s);
}

extern "C" int paged_attention_unified(
    const void* q, const void* pool_k, const void* pool_v,
    const void* page_table, long long table_stride, const void* seq_lens,
    void* out, void* scratch, void* counters, int B, int KV, int G, int hd,
    int P, int npages, int dtype, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_unified<float>(q, pool_k, pool_v, page_table, table_stride,
                              seq_lens, out, scratch, counters, B, KV, G, hd,
                              P, npages, s);
  return run_unified<__nv_bfloat16>(q, pool_k, pool_v, page_table,
                                    table_stride, seq_lens, out, scratch,
                                    counters, B, KV, G, hd, P, npages, s);
}

// Floats of fp32 split scratch one call needs (m, l and acc per split),
// or -1 if the shape does not fit a block.
extern "C" long long paged_attention_scratch_floats(int B, int KV, int G,
                                                    int hd, int P, int dtype,
                                                    int npages) {
  return pa::scratch_floats(B, 1, KV, G, hd, P, dtype == 0 ? 4 : 2, npages);
}
