// irt_lookup: the two-level iRT walk of the paper's metadata lookup
// (Section 3.2) for a batch of logical page ids.
//
// Replaces the TPU kernel repro/kernels/irt_lookup/irt_lookup.py:50
// (`irt_lookup`, body `_kernel` l.28), which holds both levels in VMEM and
// gathers one word and one entry per id, 128 ids per vector lane.
//
// out[i] = entry        if bit (leaf % 32) of l1_bits[leaf / 32] is set
//                          and entry != INVALID (-1),
//          home[i]      otherwise,
// with leaf = ids[i] / 64 and entry = leaf_table[ids[i]].
//
// Bound on the H100: bytes.  Each id costs four 4-byte reads (id, home,
// its l1 word, its leaf entry) and one 4-byte write, and a handful of
// integer operations; at the serving store's N = 4096 ids that is 80 KiB,
// some 25 ns of memory time, so one call is launch-bound.
//
// Design: one thread per id, the two probes issued back to back with no
// dependency between them (the paper's parallel lookup: fixed entry
// locations).  The Pallas wrapper pads N to a block multiple; here the
// grid covers any N and the last block masks its tail.  An id outside the
// leaf table (or a leaf outside the bit vector) is never read: the thread
// writes `home`, as for an unallocated leaf.  The kernel allocates nothing
// and runs on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInvalid = -1;
constexpr int32_t kLeafEntries = 64;

__global__ void __launch_bounds__(kThreads)
irt_lookup_kernel(const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ home,
                  const int32_t* __restrict__ l1_bits,
                  const int32_t* __restrict__ leaf_table,
                  int32_t* __restrict__ out, int64_t n, int64_t n_words,
                  int64_t n_entries) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t id = ids[i];
  const int32_t h = home[i];
  if (id < 0 || id >= n_entries) {
    out[i] = h;
    return;
  }
  const int32_t leaf = id / kLeafEntries;
  const int32_t word = leaf / 32;
  const uint32_t bits =
      word < n_words ? static_cast<uint32_t>(__ldg(l1_bits + word)) : 0u;
  const int32_t entry = __ldg(leaf_table + id);
  const bool allocated = ((bits >> (leaf % 32)) & 1u) != 0u;
  out[i] = (allocated && entry != kInvalid) ? entry : h;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int irt_lookup(const void* ids, const void* home,
                          const void* l1_bits, const void* leaf_table,
                          void* out, long long n, long long n_words,
                          long long n_entries, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  irt_lookup_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(home),
      static_cast<const int32_t*>(l1_bits),
      static_cast<const int32_t*>(leaf_table), static_cast<int32_t*>(out), n,
      n_words, n_entries);
  return (int)cudaGetLastError();
}
