// remap_gather: the migration engine's copy engine.  Two entries share one
// copy body (`copy_lane`):
//
//   remap_gather  out[i] = pool[idx[i]]: a gather into a fresh output.
//   remap_replay  a maintenance pass's recorded page copies, replayed in
//                 recorded order in ONE launch: for each record
//                 (dir, src, dst, en), on every layer and on K and V alike,
//                 dst_pool[l, dst] = src_pool[l, src] when en is set
//                 (dir 0: fast -> slow, a copy-back; dir 1: slow -> fast,
//                 an install); nothing at all when it is not.
//
// Replaces the TPU kernel repro/kernels/remap_gather/remap_gather.py:24
// (`remap_gather`, body `_kernel` l.20), which scalar-prefetches the
// indices and lets Pallas pipeline one (rows, cols) block per grid step,
// and, in the replay, the plain scatter that follows each gather in the
// reference's maintenance pass (`dst.at[:, di].set(pages, mode="drop")`,
// repro/tiered/kvcache.py:968-980, replayed move by move by
// `_replay_descs`, :983-1024).  A dropped write leaves the destination's
// bytes as they were, so skipping a disabled record is byte-equal to it.
//
// Bound on the H100: bytes.  A copy does no arithmetic: the gather moves
// 2 * n_out * slab bytes; the replay 2 * (enabled records) * 2 pools * L
// * slab bytes, over 3.35 TB/s.  One page copy of the serving engine is
// 32 layers of 32 KiB slabs, 2 MiB a pool, and a maintenance pass makes up
// to 16 of them on K and on V: one launch per copy was bound by the launch
// and by one DRAM round trip, and a pass paid that 32 times.
//
// Design.  Every record copies byte offset o of a slab to byte offset o of
// a slab of the same shape, so the work splits by offset with no
// dependence between blocks: a block owns one (layer, K or V, 256-word
// range of the slab) and applies every record in order to that range, and
// each thread owns one word lane in every record.  A later record that
// reads a page an earlier one wrote (a cb2 reading a slot just installed,
// a copy-back of a page just copied back) reads it in the same thread, so
// program order alone orders the read after the write.  The pools are
// read and written in one launch, so no pointer to them is const
// __restrict__ and nothing is read through the non-coherent path.
//   Records are staged in shared memory 256 at a time, in windows of 4,
// and each window is cut on the device (one thread per window) into runs
// in which no enabled record reads a page an enabled earlier record of the
// same run writes.  A run issues all its loads before its first store, so
// up to 4 slab reads per thread are in flight together; a window with no
// such read is one run, a chain of reads one run per link.  Writes after
// reads of the same page, and two writes of one page, need no cut: loads
// come first and stores keep record order.  A window of 4 keeps a thread
// under 64 registers, so four blocks fit an SM and the main path's 512
// blocks (32 layers x K and V x 8 ranges of a 32 KiB slab) run in one
// wave; a window of 8 needs about 90 registers and two waves, and was
// slower on the main path's pass.
//   An enabled record whose direction, source or destination lies outside
// its pool is never dereferenced: it is dropped and sets the caller's
// flag, which the caller reads once per pass.  A disabled record's
// indices are neither checked nor read.
//   Words are 16 bytes when the slab size and every base pointer allow it,
// else 4 or 1 bytes, so any element type and page shape works.  The
// gather runs the same body with blocks over (slab words, a window of 4
// outputs): an index outside [0, n) zero-fills its output slab and sets
// the flag.  The kernels allocate nothing and run on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 4;           // copies whose loads may fly together
constexpr int kSegment = kThreads;   // records staged in shared memory
constexpr int kFastToSlow = 0;
constexpr int kSlowToFast = 1;

// Word lane e of up to N slab copies: every load is issued before the
// first store.  A null source stores zeros; a null destination stores
// nothing.
template <typename V, int N>
__device__ __forceinline__ void copy_lane(V* const (&dst)[N],
                                          const V* const (&src)[N],
                                          int64_t e) {
  V v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = src[i] ? src[i][e] : V{};
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (dst[i]) dst[i][e] = v[i];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
remap_gather_kernel(const V* pool, const int32_t* __restrict__ idx, V* out,
                    int64_t n, int64_t n_out, int64_t slab,
                    int32_t* __restrict__ err) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t i0 = (int64_t)blockIdx.y * kWindow;
  V* dst[kWindow];
  const V* src[kWindow];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int64_t i = i0 + j;
    const bool live = i < n_out;
    const int32_t s = live ? idx[i] : 0;
    const bool ok = live && s >= 0 && s < n;
    bad |= live && !ok;
    src[j] = ok ? pool + (int64_t)s * slab : nullptr;
    dst[j] = live ? out + i * slab : nullptr;
  }
  if (bad && blockIdx.x == 0 && threadIdx.x == 0) atomicOr(err, 1);
  if (e < slab) copy_lane<V, kWindow>(dst, src, e);
}

// Does record r read the page record q writes?  A copy-back writes the
// slow pool and an install the fast one, so only when their directions
// differ.
__device__ __forceinline__ bool reads_write_of(const int4& r,
                                               const int4& q) {
  return r.w && q.w && q.x != r.x && q.z == r.y;
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
remap_replay_kernel(V* fast_k, V* fast_v, V* slow_k, V* slow_v,
                    const int4* __restrict__ recs, int64_t n_rec,
                    int64_t n_fast, int64_t n_slow, int64_t slab,
                    int32_t* __restrict__ err) {
  __shared__ int4 rec[kSegment];
  __shared__ uint32_t runs[kSegment / kWindow];   // bit j: a run starts
  const int64_t layer = blockIdx.z;
  V* fast = (blockIdx.y == 0 ? fast_k : fast_v) + layer * n_fast * slab;
  V* slow = (blockIdx.y == 0 ? slow_k : slow_v) + layer * n_slow * slab;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool reporter =
      blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  for (int64_t base = 0; base < n_rec; base += kSegment) {
    const int n = (int)((n_rec - base) < kSegment ? n_rec - base
                                                  : kSegment);
    __syncthreads();                 // the previous segment is consumed
    int4 r = make_int4(0, 0, 0, 0);
    if ((int)threadIdx.x < n) {
      r = recs[base + threadIdx.x];
      if (r.w) {
        const bool up = r.x == kSlowToFast;
        const int64_t n_src = up ? n_slow : n_fast;
        const int64_t n_dst = up ? n_fast : n_slow;
        if ((r.x != kFastToSlow && !up) || r.y < 0 || r.y >= n_src ||
            r.z < 0 || r.z >= n_dst) {
          r.w = 0;
          if (reporter) atomicOr(err, 1);
        }
      }
      r.w = r.w != 0;
    }
    rec[threadIdx.x] = r;
    __syncthreads();
    if (threadIdx.x < kSegment / kWindow) {   // cut one window into runs
      const int4* w = rec + threadIdx.x * kWindow;
      uint32_t starts = 1u;
      int run = 0;
      for (int j = 1; j < kWindow; ++j) {
        for (int k = run; k < j; ++k) {
          if (reads_write_of(w[j], w[k])) {
            starts |= 1u << j;
            run = j;
            break;
          }
        }
      }
      runs[threadIdx.x] = starts;
    }
    __syncthreads();
    if (e >= slab) continue;
    for (int w0 = 0; w0 < n; w0 += kWindow) {
      const uint32_t starts = runs[w0 / kWindow];
      int j0 = 0;
      while (j0 < kWindow) {
        int j1 = j0 + 1;
        while (j1 < kWindow && !((starts >> j1) & 1u)) ++j1;
        V* dst[kWindow];
        const V* src[kWindow];
#pragma unroll
        for (int j = 0; j < kWindow; ++j) {
          const int4 q = rec[w0 + j];
          const bool on = q.w && j >= j0 && j < j1;
          const bool up = q.x == kSlowToFast;
          src[j] = on ? (up ? slow : fast) + (int64_t)q.y * slab : nullptr;
          dst[j] = on ? (up ? fast : slow) + (int64_t)q.z * slab : nullptr;
        }
        copy_lane<V, kWindow>(dst, src, e);
        j0 = j1;
      }
    }
  }
}

template <typename V>
int launch_gather(const void* pool, const int32_t* idx, void* out, int64_t n,
                  int64_t n_out, int64_t slab_bytes, int32_t* err,
                  cudaStream_t stream) {
  const int64_t slab = slab_bytes / (int64_t)sizeof(V);
  const int64_t groups = (n_out + kWindow - 1) / kWindow;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((slab + kThreads - 1) / kThreads), (unsigned)groups);
  remap_gather_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(pool), idx, static_cast<V*>(out), n, n_out, slab,
      err);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_replay(void* fast_k, void* fast_v, void* slow_k, void* slow_v,
                  const void* recs, int64_t n_rec, int64_t layers,
                  int64_t n_fast, int64_t n_slow, int64_t slab_bytes,
                  int32_t* err, cudaStream_t stream) {
  const int64_t slab = slab_bytes / (int64_t)sizeof(V);
  if (layers > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((slab + kThreads - 1) / kThreads), 2,
            (unsigned)layers);
  remap_replay_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<V*>(fast_k), static_cast<V*>(fast_v),
      static_cast<V*>(slow_k), static_cast<V*>(slow_v),
      static_cast<const int4*>(recs), n_rec, n_fast, n_slow, slab, err);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success).
extern "C" int remap_gather(const void* pool, const void* idx, void* out,
                            long long n, long long n_out,
                            long long slab_bytes, void* err, void* stream) {
  if (n_out <= 0 || slab_bytes <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool)
                        | reinterpret_cast<uintptr_t>(out);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* e = static_cast<int32_t*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_bytes % 16 == 0 && align % 16 == 0)
    return launch_gather<uint4>(pool, ix, out, n, n_out, slab_bytes, e, s);
  if (slab_bytes % 4 == 0 && align % 4 == 0)
    return launch_gather<uint32_t>(pool, ix, out, n, n_out, slab_bytes, e,
                                   s);
  return launch_gather<uint8_t>(pool, ix, out, n, n_out, slab_bytes, e, s);
}

// recs: n_rec int32 rows (dir, src, dst, en), 16-byte aligned; pools
// [layers, n_fast | n_slow, slab_bytes] as raw bytes.
extern "C" int remap_replay(void* fast_k, void* fast_v, void* slow_k,
                            void* slow_v, const void* recs, long long n_rec,
                            long long layers, long long n_fast,
                            long long n_slow, long long slab_bytes,
                            void* err, void* stream) {
  if (n_rec <= 0 || layers <= 0 || slab_bytes <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(fast_k)
                        | reinterpret_cast<uintptr_t>(fast_v)
                        | reinterpret_cast<uintptr_t>(slow_k)
                        | reinterpret_cast<uintptr_t>(slow_v);
  int32_t* e = static_cast<int32_t*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_bytes % 16 == 0 && align % 16 == 0)
    return launch_replay<uint4>(fast_k, fast_v, slow_k, slow_v, recs, n_rec,
                                layers, n_fast, n_slow, slab_bytes, e, s);
  if (slab_bytes % 4 == 0 && align % 4 == 0)
    return launch_replay<uint32_t>(fast_k, fast_v, slow_k, slow_v, recs,
                                   n_rec, layers, n_fast, n_slow, slab_bytes,
                                   e, s);
  return launch_replay<uint8_t>(fast_k, fast_v, slow_k, slow_v, recs, n_rec,
                                layers, n_fast, n_slow, slab_bytes, e, s);
}
