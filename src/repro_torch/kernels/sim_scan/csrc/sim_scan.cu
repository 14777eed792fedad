// sim_scan: the trace-driven hybrid-memory simulator's whole access loop in
// one launch, one thread block per trace.  Two entries:
//
//   sim_scan_remap     the remap-table step (repro/core/simulator.py:117-351,
//                      `make_step`): irt / linear / ideal tables, cache or
//                      flat mode, irc / conventional / none / ideal remap
//                      caches, every tracker and decider of the policy gate
//                      (repro/core/policy/access.py:98-150), dealloc hints;
//   sim_scan_tagmatch  the tag-matching step (simulator.py:358-419,
//                      `make_step_tagmatch`): Alloy, Loh-Hill, `tag_ways`.
//
// It replaces no Pallas kernel: it replaces the reference's
// `jax.lax.scan` over the step (simulator.py:442 in `run`, :455 inside the
// `vmap` of `run_many`), which XLA compiles into one device loop.  Eager
// PyTorch has no such loop: the plain version (ref.py) launches several
// hundred small ops per access.
//
// Bound on the H100: neither bytes nor operations.  A 49,152-access trace
// reads 0.3 MB of trace and touches well under 1 MB of state, and each
// access does a few hundred integer operations; at the card's rates that
// is microseconds.  What bounds it is the chain of dependent round trips
// inside one access, and across accesses (each access reads what the
// previous one wrote): remap[b], then the remap cache's set, then the
// victim's owner and its leaf counters, then the install's writes, each
// waiting on the last.  So the design keeps that chain short, not wide:
//
//   * shared memory holds the small per-trace state for the whole launch:
//     slot_owner and slot_dirty (2,044 slots at the paper geometry),
//     leaf_cnt (1,056 leaves), fifo_ptr, the remap cache (256x8, or the
//     iRC's 256x6 plus 32x16) and the counters.  They are loaded once at
//     the start and stored back at the end, so a dependent read costs a
//     shared-memory round trip, not an L2 one.  The static tables of the
//     geometry (slot_is_meta, leaf_hosted, slot_of_leaf) are closed forms
//     of the slot or leaf id, computed inline.
//   * device memory holds the n_phys-long arrays: remap and the trackers
//     (touch, pol_ema, pol_last), 256 KB each at the paper geometry; a
//     sweep's traces together stay inside the 50 MB L2.
//   * warp 0 runs the access, all 32 lanes alike on the same values; a
//     store is made by lane 0 and followed by __syncwarp, so every lane
//     reads it after.  The lanes split what is parallel within an access:
//     the ways of each remap-cache probe, fill and invalidation (ballots),
//     the IdCache fill's 32-entry sector vector (one ballot), and
//     pick_victim's k candidates (k = 511 at the paper geometry), 32 at a
//     time in FIFO order, the first admissible one by ballot.
//   * the whole block takes the epoch edge, on the access where it falls:
//     the decay of touch / mea's ema / recency's staleness over n_phys,
//     and topk's k-th highest score over n_phys (a block-wide binary
//     search on counts).  Every trace is at the same step, so the tick of
//     an access is known from its index and the other warps wait only at
//     the ticks.  The reference ranks on every access and reads the rank
//     at the tick alone.
//   * counters stay int32 (wrapping, as the reference's), in COUNTERS
//     order.
//
// Index semantics follow the reference: `//` and `%` floor, `>>` of a
// negative value stays negative, and every clip and guard sits where the
// reference has it.  A lane the reference masks off writes nothing here.
//
// The launch allocates nothing and runs on the caller's stream; the state
// is updated in place, so [start, end) ranges continue one another.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLeafEntries = 64;
constexpr int32_t kIdentity = -1;
constexpr int32_t kStale = -(1 << 20);
constexpr uint32_t kHashMult = 2654435761u;

// counters, in repro/obs/registry.SIM_COUNTERS order
enum Counter {
  N_ACC, RC_HIT, RC_ID_HIT, RC_NID_HIT, RC_INCONS, SERVE_FAST, INSTALLS,
  SWAPS, FORCED_EVICT, WRITEBACKS, WALKS, DEALLOCS, CYC_SRAM, CYC_META,
  CYC_FAST, CYC_SLOW, BY_FAST, BY_SLOW_RD, BY_SLOW_WR, kCounters
};

// the int64 argument vector, in ops.py's _ARGS order
enum Arg {
  A_T, A_L, A_START, A_END,
  A_N_PHYS, A_SLOTS, A_K, A_K_DATA, A_K_META, A_N_SETS, A_LOG_SETS, A_LF,
  A_LI, A_N_LEAF, A_LEAF_ALLOC, A_FAST_HOME, A_TRACK, A_FLAT, A_DEALLOC,
  A_RC_KIND, A_VC_SETS, A_VC_WAYS, A_ID_SETS, A_ID_WAYS,
  A_T_SRAM, A_T_FAST, A_T_FAST_META, A_T_SLOW_RD, A_BLK, A_ACC,
  A_N_META_ACC,
  A_TRACKS, A_TRACKER, A_TOPK_DECIDER, A_THR, A_TOPK, A_DECAY_SHIFT,
  A_HISTORY, A_WRITE_WEIGHT,
  A_TM_WAYS, A_TM_SETS, A_TM_BURSTS, A_TM_TAG_READ,
  A_BLOCKS, A_WRITES, A_DEALLOCS, A_REMAP, A_SLOT_OWNER, A_SLOT_DIRTY,
  A_LEAF_CNT, A_FIFO, A_STEP, A_TOUCH, A_EMA, A_LAST, A_CUT, A_BUDGET,
  A_VC_TAG, A_VC_VAL, A_VC_FIFO, A_ID_TAG, A_ID_BITS, A_ID_FIFO,
  A_COUNTERS, kArgs
};

enum RcKind { RC_IRC = 0, RC_CONVENTIONAL = 1, RC_NONE = 2, RC_IDEAL = 3 };
enum Tracker { TR_TOUCH = 0, TR_MEA = 1, TR_RECENCY = 2 };

struct Params {
  int T, L, start, end;
  int n_phys, slots, k, k_data, k_meta, n_sets, log_sets, lf, li, n_leaf,
      leaf_alloc, fast_home, track, flat, dealloc;
  int rc_kind, vc_sets, vc_ways, id_sets, id_ways;
  int t_sram, t_fast, t_fast_meta, t_slow_rd, blk, acc, n_meta_acc;
  int tracks, tracker, topk_decider, thr, topk, decay_shift, history,
      write_weight;
  int tm_ways, tm_sets, tm_bursts, tm_tag_read;
  const int32_t* blocks;
  const uint8_t* writes;
  const uint8_t* deallocs;
  int32_t* remap;
  int32_t* slot_owner;
  uint8_t* slot_dirty;
  int32_t* leaf_cnt;
  int32_t* fifo;
  int32_t* step;
  int32_t* touch;
  int32_t* ema;
  int32_t* last;
  int32_t* cut;
  int32_t* budget;
  int32_t* vc_tag;
  int32_t* vc_val;
  int32_t* vc_fifo;
  int32_t* id_tag;
  int64_t* id_bits;
  int32_t* id_fifo;
  int32_t* counters;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int floormod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int id_index(int sb, int id_sets) {
  const uint32_t h = ((uint32_t)sb * kHashMult) >> 16;
  return (int)(h % (uint32_t)id_sets);
}

// Shared-memory words of one trace's small state (all int32; slot_dirty
// as 0/1 words, id_bits as uint32 words).
__host__ __device__ inline int64_t remap_smem_words(const Params& p) {
  return 2LL * p.slots + p.leaf_alloc + p.n_sets +
         2LL * p.vc_sets * p.vc_ways + p.vc_sets +
         2LL * p.id_sets * p.id_ways + p.id_sets + kCounters;
}

__host__ __device__ inline int64_t tagmatch_smem_words(const Params& p) {
  return 2LL * p.tm_sets * p.tm_ways + 1 + kCounters;
}

// ---------------------------------------------------------------------------
// block-wide reductions (every thread gets the result)
// ---------------------------------------------------------------------------

__device__ int64_t block_reduce(int64_t v, int op, int64_t* scratch) {
  // op: 0 sum, 1 max, 2 min
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t u = __shfl_xor_sync(kFull, v, o);
    v = op == 0 ? v + u : (op == 1 ? (u > v ? u : v) : (u < v ? u : v));
  }
  __syncthreads();                 // the scratch of the last call is read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int64_t id = op == 0 ? 0 : (op == 1 ? LLONG_MIN : LLONG_MAX);
  v = lane < nw ? scratch[lane] : id;
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t u = __shfl_xor_sync(kFull, v, o);
    v = op == 0 ? v + u : (op == 1 ? (u > v ? u : v) : (u < v ? u : v));
  }
  return v;
}

// ---------------------------------------------------------------------------
// one trace of the remap-table scheme
// ---------------------------------------------------------------------------

struct Sim {
  const Params& p;
  int lane;
  // shared
  int32_t* owner;
  int32_t* dirty;
  int32_t* leaf;
  int32_t* fifo;
  int32_t* vtag;
  int32_t* vval;
  int32_t* vfifo;
  int32_t* itag;
  uint32_t* ibits;
  int32_t* ififo;
  int32_t* cnt;
  // this trace's rows in device memory
  int32_t* remap;
  int32_t* touch;
  int32_t* ema;
  int32_t* last;

  // a store seen by every lane of warp 0 after it
  __device__ __forceinline__ void put(int32_t* a, int32_t v) const {
    if (lane == 0) *a = v;
    __syncwarp();
  }
  __device__ __forceinline__ void put_u(uint32_t* a, uint32_t v) const {
    if (lane == 0) *a = v;
    __syncwarp();
  }
  __device__ __forceinline__ void add(int32_t* a, int32_t d) const {
    put(a, wrap_add(*a, d));
  }
  // counters are read only at the end
  __device__ __forceinline__ void bump(int c, int32_t d) const {
    if (lane == 0) cnt[c] = wrap_add(cnt[c], d);
  }

  // --- geometry (core/remap/geometry.py; closed forms of static_tables)
  __device__ __forceinline__ int lps() const { return p.lf + p.li; }
  __device__ int lf_of(int x) const {
    if (!p.track) return 0;
    const int s = x & (p.n_sets - 1);
    const int w = x >> p.log_sets;
    return clampi(s * lps() + floordiv(w, kLeafEntries), 0, p.n_leaf - 1);
  }
  __device__ int li_of(int v) const {
    if (!p.track) return 0;
    const int s = floordiv(v, p.k), u = floormod(v, p.k);
    return clampi(s * lps() + p.lf + floordiv(u, kLeafEntries), 0,
                  p.n_leaf - 1);
  }
  __device__ __forceinline__ bool is_meta(int v) const {
    return floormod(v, p.k) >= p.k_data;
  }
  __device__ int leaf_hosted(int v) const {
    const int j = floormod(v, p.k) - p.k_data;
    return (j >= 0 && j < lps()) ? floordiv(v, p.k) * lps() + j : -1;
  }
  __device__ int slot_of_leaf(int leaf_id) const {
    if (p.n_leaf == 0) return -1;
    const int j = leaf_id % lps();
    return j < p.k_meta ? (leaf_id / lps()) * p.k + p.k_data + j : -1;
  }
  __device__ int home_block(int v) const {
    const int s = floordiv(v, p.k), u = floormod(v, p.k);
    return (u << p.log_sets) | s;
  }

  // --- remap cache (core/remap/rcache.py) ------------------------------
  // value cache: the conventional cache, or the iRC's NonIdCache
  __device__ void vc_probe(int id, bool* hit, int32_t* val) const {
    const int s = floormod(id, p.vc_sets);
    bool any = false;
    uint32_t sum = 0;
    for (int w0 = 0; w0 < p.vc_ways; w0 += 32) {
      const int w = w0 + lane;
      const bool m = w < p.vc_ways && vtag[s * p.vc_ways + w] == id;
      any |= __ballot_sync(kFull, m) != 0u;
      uint32_t part = m ? (uint32_t)vval[s * p.vc_ways + w] : 0u;
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      sum += part;
    }
    *hit = any;
    *val = (int32_t)sum;
  }
  __device__ void vc_fill(int id, int32_t dev) const {
    const int s = floormod(id, p.vc_sets);
    const int w = floormod(vfifo[s], p.vc_ways);
    put(&vtag[s * p.vc_ways + w], id);
    put(&vval[s * p.vc_ways + w], dev);
    add(&vfifo[s], 1);
  }
  __device__ void vc_kill(int id) const {
    const int s = floormod(id, p.vc_sets);
    for (int w0 = 0; w0 < p.vc_ways; w0 += 32) {
      const int w = w0 + lane;
      if (w < p.vc_ways && vtag[s * p.vc_ways + w] == id)
        vtag[s * p.vc_ways + w] = -1;        // each lane its own cell
    }
    __syncwarp();
  }
  __device__ bool id_probe(int id) const {
    const int sb = floordiv(id, 32), bit = floormod(id, 32);
    const int si = id_index(sb, p.id_sets);
    bool any = false;
    uint32_t line = 0;
    for (int w0 = 0; w0 < p.id_ways; w0 += 32) {
      const int w = w0 + lane;
      const bool m = w < p.id_ways && itag[si * p.id_ways + w] == sb;
      any |= __ballot_sync(kFull, m) != 0u;
      uint32_t part = m ? ibits[si * p.id_ways + w] : 0u;
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(kFull, part, o);
      line += part;
    }
    return any && ((line >> bit) & 1u);
  }
  // the sector vector of sb: bit j set where block sb*32+j is identity
  __device__ uint32_t sector_vec(int sb) const {
    const int off = sb * 32 + lane;
    const bool bitv = off >= 0 && off < p.n_phys && remap[off] == kIdentity;
    return __ballot_sync(kFull, bitv);
  }
  __device__ void id_fill(int id) const {
    const int sb = floordiv(id, 32);
    const uint32_t vec = sector_vec(sb);
    const int si = id_index(sb, p.id_sets);
    int first = -1;
    for (int w0 = 0; w0 < p.id_ways && first < 0; w0 += 32) {
      const int w = w0 + lane;
      const unsigned bal = __ballot_sync(
          kFull, w < p.id_ways && itag[si * p.id_ways + w] == sb);
      if (bal) first = w0 + __ffs(bal) - 1;
    }
    const bool have = first >= 0;
    const int wi = have ? first : floormod(ififo[si], p.id_ways);
    put(&itag[si * p.id_ways + wi], sb);
    put_u(&ibits[si * p.id_ways + wi], vec);
    if (!have) add(&ififo[si], 1);
  }
  __device__ void id_update(int id, bool becomes_identity) const {
    const int sb = floordiv(id, 32), bit = floormod(id, 32);
    const int si = id_index(sb, p.id_sets);
    for (int w0 = 0; w0 < p.id_ways; w0 += 32) {
      const int w = w0 + lane;
      if (w < p.id_ways && itag[si * p.id_ways + w] == sb) {
        const uint32_t line = ibits[si * p.id_ways + w];
        ibits[si * p.id_ways + w] =
            (line & ~(1u << bit)) | ((uint32_t)becomes_identity << bit);
      }
    }
    __syncwarp();
  }
  __device__ void rc_invalidate(int id, bool becomes_identity) const {
    if (p.rc_kind == RC_NONE || p.rc_kind == RC_IDEAL) return;
    vc_kill(id);
    if (p.rc_kind == RC_IRC) id_update(id, becomes_identity);
  }
  __device__ void rc_fill(int id, int32_t dev) const {
    if (p.rc_kind == RC_CONVENTIONAL) {
      vc_fill(id, dev);
    } else if (p.rc_kind == RC_IRC) {
      if (dev != kIdentity) vc_fill(id, dev);
      else id_fill(id);
    }
  }

  // --- the migration engine (simulator.py:125-257) ---------------------
  __device__ bool copy_evict(int v) const {
    const int o = owner[v];
    const bool has = o >= 0;
    const bool dirty_ = has && dirty[v] != 0;
    if (has) {
      put(&remap[o], kIdentity);
      if (p.track) {
        add(&leaf[lf_of(o)], -1);
        if (is_meta(v)) add(&leaf[li_of(v)], -1);
      }
    }
    put(&owner[v], -1);
    put(&dirty[v], 0);
    if (dirty_) {
      bump(BY_FAST, p.blk);
      bump(BY_SLOW_WR, p.blk);
      bump(WRITEBACKS, 1);
    }
    if (has) rc_invalidate(o, true);
    return has;
  }
  __device__ void force_evict_hosted(int leaf_id) const {
    if (!p.track) return;
    const int lc = clampi(leaf_id, 0, p.n_leaf - 1);
    const int h = slot_of_leaf(lc);
    if (h < 0 || leaf[lc] <= 0 || owner[h] < 0) return;
    if (copy_evict(h)) bump(FORCED_EVICT, 1);
  }
  // FIFO victim of set s for block b: (slot, position); the first
  // admissible candidate, else position 0
  __device__ void pick_victim(int b, int s, int* v, int* pos) const {
    const int base = s * p.k, f = fifo[s];
    const int own_leaf_slot = p.track ? slot_of_leaf(lf_of(b)) : -1;
    int found = -1;
    for (int j0 = 0; j0 < p.k && found < 0; j0 += 32) {
      const int j = j0 + lane;
      bool ok = false;
      if (j < p.k) {
        const int cand = base + floormod(f + j, p.k);
        const bool meta = is_meta(cand);
        ok = true;
        if (meta) {
          const int h = leaf_hosted(cand);
          ok = h >= 0 && leaf[clampi(h, 0, p.n_leaf - 1)] == 0;
        }
        if (p.track) {
          ok = ok && cand != own_leaf_slot;
          ok = ok && !(meta && slot_of_leaf(li_of(cand)) == cand);
        }
      }
      const unsigned bal = __ballot_sync(kFull, ok);
      if (bal) found = j0 + __ffs(bal) - 1;
    }
    *pos = found < 0 ? 0 : found;
    *v = base + floormod(f + *pos, p.k);
  }
  __device__ void install_copy(int b, int v, bool w) const {
    copy_evict(v);
    const bool meta = is_meta(v);
    put(&owner[v], b);
    put(&dirty[v], w ? 1 : 0);
    put(&remap[b], v);
    if (p.track) {
      add(&leaf[lf_of(b)], 1);
      if (meta) add(&leaf[li_of(v)], 1);
      force_evict_hosted(lf_of(b));
      if (meta) force_evict_hosted(li_of(v));
    }
    rc_invalidate(b, false);
    bump(BY_SLOW_RD, p.blk);
    bump(BY_FAST, p.blk);
    bump(INSTALLS, 1);
  }
  __device__ void install_swap(int b, int v) const {
    const int fb = home_block(v);
    const int o = owner[v];
    if (o >= 0 && o != fb) {          // a resident migrant goes home
      put(&remap[o], kIdentity);
      if (p.track) add(&leaf[lf_of(o)], -1);
      rc_invalidate(o, true);
      bump(BY_FAST, p.blk);
      bump(BY_SLOW_WR, p.blk);
    }
    // the displaced home block fb takes over b's slow home
    const int hb = b - p.fast_home;
    const bool fb_was_home = remap[fb] == kIdentity;
    put(&remap[fb], -(hb + 2));
    if (p.track && fb_was_home) add(&leaf[lf_of(fb)], 1);
    rc_invalidate(fb, false);
    bump(BY_SLOW_WR, p.blk);
    bump(fb_was_home ? BY_FAST : BY_SLOW_RD, p.blk);
    // b moves into v
    put(&remap[b], v);
    put(&owner[v], b);
    put(&dirty[v], 0);
    if (p.track) {
      add(&leaf[lf_of(b)], 1);
      force_evict_hosted(lf_of(b));
      force_evict_hosted(lf_of(fb));
    }
    rc_invalidate(b, false);
    bump(BY_SLOW_RD, p.blk);
    bump(BY_FAST, p.blk);
    bump(SWAPS, 1);
  }
};

__device__ __forceinline__ int32_t score_at(const Params& p,
                                            const int32_t* touch,
                                            const int32_t* ema, int j) {
  return p.tracker == TR_MEA ? wrap_add(touch[j], ema[j] >> 1) : touch[j];
}

// ---------------------------------------------------------------------------
// the remap-table kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
sim_scan_remap_kernel(const __grid_constant__ Params p) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t scratch[32];
  __shared__ int32_t kth_sh;
  const int t = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5;

  int32_t* owner = smem;
  int32_t* dirty = owner + p.slots;
  int32_t* leaf = dirty + p.slots;
  int32_t* fifo = leaf + p.leaf_alloc;
  int32_t* vtag = fifo + p.n_sets;
  int32_t* vval = vtag + p.vc_sets * p.vc_ways;
  int32_t* vfifo = vval + p.vc_sets * p.vc_ways;
  int32_t* itag = vfifo + p.vc_sets;
  uint32_t* ibits = reinterpret_cast<uint32_t*>(itag + p.id_sets * p.id_ways);
  int32_t* ififo = reinterpret_cast<int32_t*>(ibits + p.id_sets * p.id_ways);
  int32_t* cnt = ififo + p.id_sets;

  const int64_t vcn = (int64_t)p.vc_sets * p.vc_ways;
  const int64_t idn = (int64_t)p.id_sets * p.id_ways;
  for (int j = tid; j < p.slots; j += nt) {
    owner[j] = p.slot_owner[(int64_t)t * p.slots + j];
    dirty[j] = p.slot_dirty[(int64_t)t * p.slots + j] ? 1 : 0;
  }
  for (int j = tid; j < p.leaf_alloc; j += nt)
    leaf[j] = p.leaf_cnt[(int64_t)t * p.leaf_alloc + j];
  for (int j = tid; j < p.n_sets; j += nt)
    fifo[j] = p.fifo[(int64_t)t * p.n_sets + j];
  for (int j = tid; j < vcn; j += nt) {
    vtag[j] = p.vc_tag[t * vcn + j];
    vval[j] = p.vc_val[t * vcn + j];
  }
  for (int j = tid; j < p.vc_sets; j += nt)
    vfifo[j] = p.vc_fifo[(int64_t)t * p.vc_sets + j];
  for (int j = tid; j < idn; j += nt) {
    itag[j] = p.id_tag[t * idn + j];
    ibits[j] = (uint32_t)p.id_bits[t * idn + j];
  }
  for (int j = tid; j < p.id_sets; j += nt)
    ififo[j] = p.id_fifo[(int64_t)t * p.id_sets + j];
  for (int j = tid; j < kCounters; j += nt)
    cnt[j] = p.counters[(int64_t)t * kCounters + j];
  __syncthreads();

  const int64_t row = (int64_t)t * p.n_phys;
  const Sim sim{p, tid & 31, owner, dirty, leaf, fifo, vtag, vval, vfifo,
                itag, ibits, ififo, cnt, p.remap + row,
                p.touch ? p.touch + row : nullptr,
                p.ema ? p.ema + row : nullptr,
                p.last ? p.last + row : nullptr};
  const bool mea = p.tracker == TR_MEA, recency = p.tracker == TR_RECENCY;
  const int32_t step0 = p.step[t];
  const int32_t mask =
      p.tracks ? (int32_t)((1u << p.decay_shift) - 1u) : 0;
  int32_t step = step0;
  int32_t cut = p.topk_decider && p.tracks ? p.cut[t] : 0;
  int32_t budget = p.topk_decider && p.tracks ? p.budget[t] : 0;

  for (int i = p.start; i < p.end; ++i) {
    const int32_t step_after = step0 + (i - p.start) + 1;
    const bool tick = p.tracks && (step_after & mask) == 0;
    // warp 0's values of this access, carried across the tick barriers
    int b = 0, s = 0, sc = 0;
    bool w = false, elig = false;
    if (warp == 0) {
      const int64_t x = (int64_t)t * p.L + i;
      b = p.blocks[x];
      w = p.writes[x] != 0;
      const bool d = p.deallocs[x] != 0;
      s = b & (p.n_sets - 1);
      bool skip = false;
      if (p.dealloc) {
        // Section 3.5: the block is dead -> recycle its entry, free its
        // slot, skip the writeback
        const int32_t m0 = sim.remap[b];
        const bool freed = d && m0 >= 0;
        const bool clearable = d && m0 >= kIdentity;
        const int slot0 = m0 > 0 ? m0 : 0;
        if (clearable) sim.put(&sim.remap[b], kIdentity);
        if (freed) {
          sim.put(&owner[slot0], -1);
          sim.put(&dirty[slot0], 0);
          if (p.track) {
            sim.add(&leaf[sim.lf_of(b)], -1);
            if (sim.is_meta(slot0)) sim.add(&leaf[sim.li_of(slot0)], -1);
          }
        }
        if (clearable) sim.rc_invalidate(b, true);
        if (d && p.tracks) {
          sim.put(&sim.touch[b], 0);
          if (mea) sim.put(&sim.ema[b], 0);
          if (recency) sim.put(&sim.last[b], kStale);
        }
        sim.bump(DEALLOCS, d ? 1 : 0);
        w = w && !d;
        skip = d;
      }
      sim.bump(N_ACC, skip ? 0 : 1);
      step = step_after;

      // 1. metadata lookup: remap cache probe, then table walk on a miss
      const int32_t m = sim.remap[b];
      if (p.rc_kind != RC_IDEAL) {
        bool hit = false, id_hit = false;
        int32_t val = kIdentity;
        if (p.rc_kind != RC_NONE) {
          bool vhit;
          int32_t vval_;
          sim.vc_probe(b, &vhit, &vval_);
          if (p.rc_kind == RC_IRC) {
            id_hit = sim.id_probe(b);
            hit = vhit || id_hit;
            val = vhit ? vval_ : kIdentity;
          } else {
            hit = vhit;
            val = vhit ? vval_ : kIdentity;
          }
        }
        hit = hit || skip;
        const bool walk = !hit;
        sim.bump(RC_INCONS, hit && val != m ? 1 : 0);
        sim.bump(RC_HIT, hit ? 1 : 0);
        sim.bump(RC_ID_HIT, id_hit ? 1 : 0);
        sim.bump(RC_NID_HIT, hit && !id_hit ? 1 : 0);
        sim.bump(WALKS, walk ? 1 : 0);
        sim.bump(CYC_SRAM, p.t_sram);
        if (walk) {
          sim.bump(CYC_META, p.t_fast_meta);
          sim.bump(BY_FAST, p.acc * p.n_meta_acc);
          sim.rc_fill(b, m);
        }
      }

      // 2. data access
      const bool at_fast_home =
          p.flat && m == kIdentity && b < p.fast_home;
      const bool in_fast = (m >= 0 || at_fast_home) && !skip;
      const bool slow = !in_fast && !skip;
      if (in_fast) {
        sim.bump(SERVE_FAST, 1);
        sim.bump(CYC_FAST, p.t_fast);
        sim.bump(BY_FAST, p.acc);
      }
      if (slow) {
        sim.bump(CYC_SLOW, p.t_slow_rd);
        sim.bump(w ? BY_SLOW_WR : BY_SLOW_RD, p.acc);
      }
      if (w && m >= 0) sim.put(&dirty[m], 1);

      // 3. the policy gate, first half: record the touch
      elig = p.flat ? (slow && b >= p.fast_home) : slow;
      if (p.tracks) {
        if (elig) {
          const int32_t inc = p.write_weight <= 1 ? 1
                              : (w ? p.write_weight : 1);
          sim.add(&sim.touch[b], inc);
          if (recency) sim.put(&sim.last[b], step >> p.decay_shift);
        }
        sc = score_at(p, sim.touch, sim.ema, b);
      }
    }

    if (tick && p.topk_decider) {
      // the epoch's cut: the k-th highest score over every block (after
      // this access's touch), by binary search on counts
      __syncthreads();
      int64_t mx = LLONG_MIN, mn = LLONG_MAX;
      for (int j = tid; j < p.n_phys; j += nt) {
        const int64_t v = score_at(p, sim.touch, sim.ema, j);
        mx = v > mx ? v : mx;
        mn = v < mn ? v : mn;
      }
      mx = block_reduce(mx, 1, scratch);
      mn = block_reduce(mn, 2, scratch);
      const int64_t k = p.topk < p.n_phys ? p.topk : p.n_phys;
      int64_t lo = mn, hi = mx + 1;            // count(>= lo) >= k > count(>= hi)
      while (hi - lo > 1) {
        const int64_t mid = lo + (hi - lo) / 2;
        int64_t c = 0;
        for (int j = tid; j < p.n_phys; j += nt)
          c += score_at(p, sim.touch, sim.ema, j) >= mid;
        if (block_reduce(c, 0, scratch) >= k) lo = mid;
        else hi = mid;
      }
      if (tid == 0) kth_sh = (int32_t)lo;
      __syncthreads();
    }

    if (warp == 0 && p.tracks) {
      // the gate, second half: decide, reset on a move
      bool go;
      if (p.topk_decider) {
        if (tick) {
          cut = kth_sh > 1 ? kth_sh : 1;
          budget = p.topk;
        }
        go = elig && sc >= 1 && sc >= cut && budget > 0;
        budget -= go ? 1 : 0;
      } else {
        go = elig && sc >= p.thr;
      }
      if (go) {
        sim.put(&sim.touch[b], 0);
        if (mea) sim.put(&sim.ema[b], 0);
      }
      elig = go;
    }

    if (tick) {
      // the epoch edge: decay every block's tracker state
      __syncthreads();
      const int32_t now = step_after >> p.decay_shift;
      for (int j = tid; j < p.n_phys; j += nt) {
        if (mea) {
          sim.ema[j] = wrap_add(sim.touch[j], sim.ema[j] >> 1);
          sim.touch[j] = 0;
        } else if (recency) {
          if (now - sim.last[j] > p.history) sim.touch[j] = 0;
        } else {
          sim.touch[j] = sim.touch[j] >> 1;
        }
      }
      __syncthreads();
    }

    if (warp == 0 && elig) {
      // 4. install / migrate (elig now holds the gate's answer)
      int v, pos;
      sim.pick_victim(b, s, &v, &pos);
      sim.put(&fifo[s], floormod(fifo[s] + pos + 1, p.k));
      if (!p.flat) {
        sim.install_copy(b, v, w);
      } else if (sim.is_meta(v)) {
        sim.install_copy(b, v, w);
      } else {
        sim.install_swap(b, v);
      }
    }
  }

  __syncthreads();
  for (int j = tid; j < p.slots; j += nt) {
    p.slot_owner[(int64_t)t * p.slots + j] = owner[j];
    p.slot_dirty[(int64_t)t * p.slots + j] = dirty[j] ? 1 : 0;
  }
  for (int j = tid; j < p.leaf_alloc; j += nt)
    p.leaf_cnt[(int64_t)t * p.leaf_alloc + j] = leaf[j];
  for (int j = tid; j < p.n_sets; j += nt)
    p.fifo[(int64_t)t * p.n_sets + j] = fifo[j];
  for (int j = tid; j < vcn; j += nt) {
    p.vc_tag[t * vcn + j] = vtag[j];
    p.vc_val[t * vcn + j] = vval[j];
  }
  for (int j = tid; j < p.vc_sets; j += nt)
    p.vc_fifo[(int64_t)t * p.vc_sets + j] = vfifo[j];
  for (int j = tid; j < idn; j += nt) {
    p.id_tag[t * idn + j] = itag[j];
    p.id_bits[t * idn + j] = (int64_t)ibits[j];
  }
  for (int j = tid; j < p.id_sets; j += nt)
    p.id_fifo[(int64_t)t * p.id_sets + j] = ififo[j];
  for (int j = tid; j < kCounters; j += nt)
    p.counters[(int64_t)t * kCounters + j] = cnt[j];
  if (tid == 0) {
    p.step[t] = step;
    if (p.topk_decider && p.tracks) {
      p.cut[t] = cut;
      p.budget[t] = budget;
    }
  }
}

// ---------------------------------------------------------------------------
// the tag-matching kernel: one warp per trace
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
sim_scan_tagmatch_kernel(const __grid_constant__ Params p) {
  extern __shared__ int32_t smem[];
  const int t = blockIdx.x, lane = threadIdx.x;
  const int n = p.tm_sets * p.tm_ways;
  int32_t* owner = smem;
  int32_t* dirty = owner + n;
  int32_t* fifo = dirty + n;
  int32_t* cnt = fifo + 1;
  for (int j = lane; j < n; j += 32) {
    owner[j] = p.slot_owner[(int64_t)t * n + j];
    dirty[j] = p.slot_dirty[(int64_t)t * n + j] ? 1 : 0;
  }
  if (lane == 0) fifo[0] = p.fifo[t];
  for (int j = lane; j < kCounters; j += 32)
    cnt[j] = p.counters[(int64_t)t * kCounters + j];
  __syncwarp();

  auto bump = [&](int c, int32_t d) {
    if (lane == 0) cnt[c] = wrap_add(cnt[c], d);
  };
  const int ways = p.tm_ways;
  for (int i = p.start; i < p.end; ++i) {
    const int64_t x = (int64_t)t * p.L + i;
    const int b = p.blocks[x];
    const bool w = p.writes[x] != 0;
    bump(N_ACC, 1);
    const int slot0 = floormod(b, p.tm_sets) * ways;
    int way = -1;
    for (int w0 = 0; w0 < ways && way < 0; w0 += 32) {
      const unsigned bal = __ballot_sync(
          kFull, w0 + lane < ways && owner[slot0 + w0 + lane] == b);
      if (bal) way = w0 + __ffs(bal) - 1;
    }
    const bool hit = way >= 0;
    const int slot = slot0 + (hit ? way : floormod(fifo[0], ways));
    if (hit) {
      if (p.tm_tag_read) {
        // the tags are read from the same DRAM row before the data
        bump(CYC_META, p.t_fast_meta * p.tm_bursts);
        bump(BY_FAST, p.tm_bursts * p.acc);
      }
      bump(SERVE_FAST, 1);
      bump(CYC_FAST, p.t_fast);
      bump(BY_FAST, p.acc);
      if (w && lane == 0) dirty[slot] = 1;
    } else {
      bump(CYC_SLOW, p.t_slow_rd);
      bump(BY_SLOW_RD, p.acc);
      if (owner[slot] >= 0 && dirty[slot]) {
        bump(BY_FAST, p.blk);
        bump(BY_SLOW_WR, p.blk);
        bump(WRITEBACKS, 1);
      }
      __syncwarp();
      if (lane == 0) {
        owner[slot] = b;
        dirty[slot] = w ? 1 : 0;
        fifo[0] = wrap_add(fifo[0], 1);
      }
      bump(BY_SLOW_RD, p.blk);
      bump(BY_FAST, p.blk);
      bump(INSTALLS, 1);
    }
    __syncwarp();
  }

  for (int j = lane; j < n; j += 32) {
    p.slot_owner[(int64_t)t * n + j] = owner[j];
    p.slot_dirty[(int64_t)t * n + j] = dirty[j] ? 1 : 0;
  }
  if (lane == 0) p.fifo[t] = fifo[0];
  for (int j = lane; j < kCounters; j += 32)
    p.counters[(int64_t)t * kCounters + j] = cnt[j];
}

Params unpack(const int64_t* a) {
  Params p;
  p.T = (int)a[A_T]; p.L = (int)a[A_L];
  p.start = (int)a[A_START]; p.end = (int)a[A_END];
  p.n_phys = (int)a[A_N_PHYS]; p.slots = (int)a[A_SLOTS];
  p.k = (int)a[A_K]; p.k_data = (int)a[A_K_DATA];
  p.k_meta = (int)a[A_K_META]; p.n_sets = (int)a[A_N_SETS];
  p.log_sets = (int)a[A_LOG_SETS]; p.lf = (int)a[A_LF];
  p.li = (int)a[A_LI]; p.n_leaf = (int)a[A_N_LEAF];
  p.leaf_alloc = (int)a[A_LEAF_ALLOC]; p.fast_home = (int)a[A_FAST_HOME];
  p.track = (int)a[A_TRACK]; p.flat = (int)a[A_FLAT];
  p.dealloc = (int)a[A_DEALLOC];
  p.rc_kind = (int)a[A_RC_KIND]; p.vc_sets = (int)a[A_VC_SETS];
  p.vc_ways = (int)a[A_VC_WAYS]; p.id_sets = (int)a[A_ID_SETS];
  p.id_ways = (int)a[A_ID_WAYS];
  p.t_sram = (int)a[A_T_SRAM]; p.t_fast = (int)a[A_T_FAST];
  p.t_fast_meta = (int)a[A_T_FAST_META]; p.t_slow_rd = (int)a[A_T_SLOW_RD];
  p.blk = (int)a[A_BLK]; p.acc = (int)a[A_ACC];
  p.n_meta_acc = (int)a[A_N_META_ACC];
  p.tracks = (int)a[A_TRACKS]; p.tracker = (int)a[A_TRACKER];
  p.topk_decider = (int)a[A_TOPK_DECIDER]; p.thr = (int)a[A_THR];
  p.topk = (int)a[A_TOPK]; p.decay_shift = (int)a[A_DECAY_SHIFT];
  p.history = (int)a[A_HISTORY]; p.write_weight = (int)a[A_WRITE_WEIGHT];
  p.tm_ways = (int)a[A_TM_WAYS]; p.tm_sets = (int)a[A_TM_SETS];
  p.tm_bursts = (int)a[A_TM_BURSTS]; p.tm_tag_read = (int)a[A_TM_TAG_READ];
  p.blocks = reinterpret_cast<const int32_t*>(a[A_BLOCKS]);
  p.writes = reinterpret_cast<const uint8_t*>(a[A_WRITES]);
  p.deallocs = reinterpret_cast<const uint8_t*>(a[A_DEALLOCS]);
  p.remap = reinterpret_cast<int32_t*>(a[A_REMAP]);
  p.slot_owner = reinterpret_cast<int32_t*>(a[A_SLOT_OWNER]);
  p.slot_dirty = reinterpret_cast<uint8_t*>(a[A_SLOT_DIRTY]);
  p.leaf_cnt = reinterpret_cast<int32_t*>(a[A_LEAF_CNT]);
  p.fifo = reinterpret_cast<int32_t*>(a[A_FIFO]);
  p.step = reinterpret_cast<int32_t*>(a[A_STEP]);
  p.touch = reinterpret_cast<int32_t*>(a[A_TOUCH]);
  p.ema = reinterpret_cast<int32_t*>(a[A_EMA]);
  p.last = reinterpret_cast<int32_t*>(a[A_LAST]);
  p.cut = reinterpret_cast<int32_t*>(a[A_CUT]);
  p.budget = reinterpret_cast<int32_t*>(a[A_BUDGET]);
  p.vc_tag = reinterpret_cast<int32_t*>(a[A_VC_TAG]);
  p.vc_val = reinterpret_cast<int32_t*>(a[A_VC_VAL]);
  p.vc_fifo = reinterpret_cast<int32_t*>(a[A_VC_FIFO]);
  p.id_tag = reinterpret_cast<int32_t*>(a[A_ID_TAG]);
  p.id_bits = reinterpret_cast<int64_t*>(a[A_ID_BITS]);
  p.id_fifo = reinterpret_cast<int32_t*>(a[A_ID_FIFO]);
  p.counters = reinterpret_cast<int32_t*>(a[A_COUNTERS]);
  return p;
}

constexpr int64_t kMaxSmem = 232448;     // a block's shared-memory limit

template <typename K>
int launch(K kernel, const Params& p, int threads, int64_t words,
           void* stream) {
  const int64_t bytes = words * 4;
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<p.T, threads, (size_t)bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The argument vector's length, checked by the wrapper against its own.
int sim_scan_n_args() { return kArgs; }

int sim_scan_remap(const int64_t* args, void* stream) {
  const Params p = unpack(args);
  if (p.T == 0 || p.start >= p.end) return 0;
  return launch(sim_scan_remap_kernel, p, kThreads, remap_smem_words(p),
                stream);
}

int sim_scan_tagmatch(const int64_t* args, void* stream) {
  const Params p = unpack(args);
  if (p.T == 0 || p.start >= p.end) return 0;
  return launch(sim_scan_tagmatch_kernel, p, 32, tagmatch_smem_words(p),
                stream);
}

}  // extern "C"
