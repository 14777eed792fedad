// remap_gather: the migration engine's page copy, out[i] = pool[idx[i]].
//
// Replaces the TPU kernel repro/kernels/remap_gather/remap_gather.py:24
// (`remap_gather`, body `_kernel` l.20), which scalar-prefetches the
// indices and lets Pallas pipeline one (rows, cols) block per grid step.
//
// Bound on the H100: bytes.  The copy does no arithmetic; it must read
// n_out slabs and write n_out slabs, 2 * n_out * slab_bytes over 3.35 TB/s.
// The serving engine calls it with one slab per layer (n_out = L = 32,
// slab = KV*page*hd elements = 32 KiB in bf16), i.e. 2 MiB per call,
// which is far below what one launch costs, so a call is launch-bound.
//
// Design: grid (n_out, chunks); each block copies a strided share of one
// slab with 16-byte vector loads and stores when the slab size and both
// base pointers allow it, else 4-byte or 1-byte words, so any element
// size works.  An index outside [0, n) is never dereferenced: the block
// zero-fills its output slab and sets the caller's device-side error flag,
// which the caller reads once after a batch of gathers (the maintenance
// pass: one host read per pass, not per gather).  The kernel allocates
// nothing and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__global__ void remap_gather_kernel(const V* __restrict__ pool,
                                    const int32_t* __restrict__ idx,
                                    V* __restrict__ out, int64_t n,
                                    int64_t slab, int32_t* __restrict__ err) {
  const int64_t i = blockIdx.x;
  const int32_t src = idx[i];
  V* dst = out + i * slab;
  const int64_t step = (int64_t)gridDim.y * blockDim.x;
  int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (src < 0 || src >= n) {
    if (blockIdx.y == 0 && threadIdx.x == 0) atomicOr(err, 1);
    for (; e < slab; e += step) dst[e] = V{};
    return;
  }
  const V* s = pool + (int64_t)src * slab;
  for (; e < slab; e += step) dst[e] = s[e];
}

template <typename V>
static int launch(const void* pool, const int32_t* idx, void* out, int64_t n,
                  int64_t n_out, int64_t slab_bytes, int32_t* err,
                  cudaStream_t stream) {
  const int threads = 256;
  const int64_t slab = slab_bytes / (int64_t)sizeof(V);
  int64_t chunks = (slab + threads * 4 - 1) / (threads * 4);
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  dim3 grid((unsigned)n_out, (unsigned)chunks);
  remap_gather_kernel<V><<<grid, threads, 0, stream>>>(
      static_cast<const V*>(pool), idx, static_cast<V*>(out), n, slab, err);
  return (int)cudaGetLastError();
}

extern "C" int remap_gather(const void* pool, const void* idx, void* out,
                            long long n, long long n_out,
                            long long slab_bytes, void* err, void* stream) {
  if (n_out <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool)
                        | reinterpret_cast<uintptr_t>(out);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int32_t* e = static_cast<int32_t*>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(pool, ix, out, n, n_out, slab_bytes, e, s);
  if (slab_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(pool, ix, out, n, n_out, slab_bytes, e, s);
  return launch<uint8_t>(pool, ix, out, n, n_out, slab_bytes, e, s);
}
