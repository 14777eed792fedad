// irt_lookup: the two-level iRT walk of the paper's metadata lookup
// (Section 3.2) for a batch of logical page ids.  Two entries share one
// device body (`walk_one`):
//
//   irt_lookup  out[i] = the walk of ids[i], defaulting to home[i];
//   irt_walk2   both homes in one pass, as the tiered store's translation
//               needs them: walked[i] = the walk defaulting to INVALID (what
//               the iRC fill records) and dev[i] = the walk defaulting to
//               base + ids[i] (the identity slow home in the unified slot
//               space); given the iRC probe's (hit, val, id_hit), dev[i] is
//               the whole translation instead: a hit takes the cached value
//               (the home on an identity hit), a miss the walk.
//
// Replaces the TPU kernel repro/kernels/irt_lookup/irt_lookup.py:50
// (`irt_lookup`, body `_kernel` l.31), which holds both levels in VMEM and
// gathers one word and one entry per id, 128 ids per vector lane.  The
// reference's translation calls it with home = INVALID and rebuilds the
// other home with `where`s around it (repro/tiered/kvcache.py:300-306);
// irt_walk2 folds that chain into the walk.
//
// walk(id, h) = entry  if bit (leaf % 32) of l1_bits[leaf / 32] is set
//                       and entry != INVALID (-1),
//               h      otherwise,
// with leaf = id / 64 and entry = leaf_table[id].
//
// Bound on the H100: bytes.  Each id costs its id, its l1 word and its
// leaf entry (plus home, or the probe's 6 bytes) read, one or two 4-byte
// words written, and a handful of integer operations; at the serving
// store's N = 4096 ids that is under 100 KiB, some 30 ns of memory time,
// so one call is bound by the launch and two dependent DRAM round trips
// (the id, then its word and entry).  That is why the translation's
// chain around the walk, five more launches of the same latency, is
// folded into one pass rather than the walk tuned.
//
// Design: one thread per id, the two probes issued back to back with no
// dependency between them (the paper's parallel lookup: fixed entry
// locations), the probe's inputs loaded beside the id.  The grid covers any
// N and the last block masks its tail.  An id outside the leaf table (or a
// leaf outside the bit vector) is never read: it walks to its default, as
// for an unallocated leaf.  The kernels allocate nothing and run on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInvalid = -1;
constexpr int32_t kLeafEntries = 64;

// The walk of one id: its leaf entry where the leaf is allocated and the
// entry valid, else `dflt`.  The tables are read-only for the launch.
__device__ __forceinline__ int32_t walk_one(
    int32_t id, int32_t dflt, const int32_t* __restrict__ l1_bits,
    const int32_t* __restrict__ leaf_table, int64_t n_words,
    int64_t n_entries) {
  if (id < 0 || id >= n_entries) return dflt;
  const int32_t leaf = id / kLeafEntries;
  const int32_t word = leaf / 32;
  const uint32_t bits =
      word < n_words ? static_cast<uint32_t>(__ldg(l1_bits + word)) : 0u;
  const int32_t entry = __ldg(leaf_table + id);
  const bool allocated = ((bits >> (leaf % 32)) & 1u) != 0u;
  return (allocated && entry != kInvalid) ? entry : dflt;
}

__global__ void __launch_bounds__(kThreads)
irt_lookup_kernel(const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ home,
                  const int32_t* __restrict__ l1_bits,
                  const int32_t* __restrict__ leaf_table,
                  int32_t* __restrict__ out, int64_t n, int64_t n_words,
                  int64_t n_entries) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = walk_one(ids[i], home[i], l1_bits, leaf_table, n_words,
                    n_entries);
}

// hit, id_hit: bool bytes (nullptr: no probe, every id a miss).
__global__ void __launch_bounds__(kThreads)
irt_walk2_kernel(const int32_t* __restrict__ ids, int32_t base,
                 const int32_t* __restrict__ l1_bits,
                 const int32_t* __restrict__ leaf_table,
                 const uint8_t* __restrict__ hit,
                 const int32_t* __restrict__ val,
                 const uint8_t* __restrict__ id_hit,
                 int32_t* __restrict__ walked, int32_t* __restrict__ dev,
                 int64_t n, int64_t n_words, int64_t n_entries) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t id = ids[i];
  const bool h = hit != nullptr && hit[i] != 0;
  const int32_t v = h ? val[i] : 0;
  const bool ih = h && id_hit[i] != 0;
  const int32_t w =
      walk_one(id, kInvalid, l1_bits, leaf_table, n_words, n_entries);
  const int32_t home = base + id;
  walked[i] = w;
  dev[i] = h ? (ih ? home : v) : (w == kInvalid ? home : w);
}

}  // namespace

// Both entries return cudaGetLastError() after the launch (0 on success).
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

extern "C" int irt_walk2(const void* ids, int base, const void* l1_bits,
                         const void* leaf_table, const void* hit,
                         const void* val, const void* id_hit, void* walked,
                         void* dev, long long n, long long n_words,
                         long long n_entries, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  irt_walk2_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), base,
      static_cast<const int32_t*>(l1_bits),
      static_cast<const int32_t*>(leaf_table),
      static_cast<const uint8_t*>(hit), static_cast<const int32_t*>(val),
      static_cast<const uint8_t*>(id_hit), static_cast<int32_t*>(walked),
      static_cast<int32_t*>(dev), n, n_words, n_entries);
  return (int)cudaGetLastError();
}
