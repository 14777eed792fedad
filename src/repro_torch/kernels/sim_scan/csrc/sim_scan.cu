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
// is microseconds.  What bounds it is the chain: each access reads what
// the one before it wrote, and one warp issues its instructions in order,
// so every load an access waits on, every shuffle, ballot and branch,
// and every dependent step adds its whole latency.  The yardstick
// (`sim_scan_chase`, below) measures one dependent shared-memory load
// (~14.5 ns, ~29 cycles, on an H100) and one through L2 (~145 ns); the
// least a trace can take is its accesses times the first.  So the design
// takes device memory off each access's chain and cuts the round trips
// and branches left in it:
//
//   * shared memory holds the small per-trace state for the whole launch:
//     slot_owner and slot_dirty (2,044 slots at the paper geometry),
//     leaf_cnt (1,056 leaves), fifo_ptr and the remap cache (256x8, or the
//     iRC's 256x6 plus 32x16), loaded once and stored back at the end.
//     The static tables of the geometry (slot_is_meta, leaf_hosted,
//     slot_of_leaf) are closed forms of the slot or leaf id, computed
//     inline, and every division by a runtime size (k, the sets, the
//     ways) is a multiply and a shift (Div).
//   * device memory holds the n_phys-long rows: remap and the trackers
//     (touch, pol_ema, pol_last), 256 KB each at the paper geometry.  They
//     stay the authority (written on every store, read by the epoch edge
//     and the next launch), but no access waits on them.  The batch: warp
//     0 keeps the next 32 accesses in registers, lane j holding access
//     i0 + j's block and flags (loaded one batch ahead), its remap-cache
//     sets, its remap entry, its tracker words and, for the iRC, the
//     identity bits of its 32-block sector (eight 16 B loads).  One round
//     trip loads a batch; access i takes its words from lane i - i0 by
//     shuffle, all at once.
//   * the patch rule: warp 0 is the only writer of a trace's rows between
//     epoch edges, so every store to remap[x], touch[x] or ema[x] also
//     patches each batch lane whose block is x, and a store to remap[x]
//     sets bit x & 31 of each lane whose sector is x >> 5.  A block back
//     within the batch, an evicted owner or a displaced home block
//     accessed next: each finds its lane already current.  The one read
//     left on the chain is remap[fb] in a flat swap (fb is in no batch in
//     general), issued first.
//   * the tick rule: the whole block takes the epoch edge on the access
//     where it falls (the decay of touch / mea's ema / recency's
//     staleness over n_phys, and topk's k-th highest score by a
//     block-wide binary search on counts); then the batch lanes reload
//     their tracker words, one round trip.  Every trace is at the same
//     step, so the other warps know the edges from the indices: they loop
//     over the edges alone and meet warp 0 at non-.aligned barriers.
//   * warp 0's 32 lanes run one access alike, with no branch on the
//     configuration: the remap-cache kind, the mode and the policy kind
//     (none, touch + threshold, any) are template parameters (24
//     variants).  A warp-uniform store is made by every lane, so each lane
//     reads its own store back with no __syncwarp; every lane holds every
//     counter in a register.  The probe's loads of both caches' cells go
//     out first and the data access and the policy gate (which read no
//     cache) run while they are in flight; the match is a ballot and an
//     OR-reduction per cache (a set holds a tag at most once), side by
//     side.  The lanes also split the invalidations' ways and
//     pick_victim's k candidates (k = 512 at the paper geometry), 32 at a
//     time in FIFO order, the first admissible by ballot.
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
constexpr int kLeafShift = 6;        // 64 entries a leaf; >> floors
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
// the policy gate's kernel variants: no tracker state; the touch tracker
// with a threshold decider (the paper's default, and every Figure 7
// scheme); any tracker and decider (mea, recency, topk), read at run time
enum PolicyKind { POL_NONE = 0, POL_TOUCH = 1, POL_ANY = 2 };

// Floor division of a non-negative int by a divisor d >= 1 fixed for the
// launch, as a multiply and a shift: m = ceil(2^s / d), s = 31 +
// ceil(log2 d), exact for every n in [0, 2^31) (Granlund and Montgomery,
// 1994, Theorem 4.2); a negative n goes through ~n, with no branch.
struct Div {
  int d, s;
  uint32_t m;
};

struct Params {
  int T, L, start, end;
  int n_phys, slots, k, k_data, k_meta, n_sets, log_sets, lf, li, n_leaf,
      leaf_alloc, fast_home, track, flat, dealloc;
  int rc_kind, vc_sets, vc_ways, id_sets, id_ways;
  int t_sram, t_fast, t_fast_meta, t_slow_rd, blk, acc, n_meta_acc;
  int tracks, tracker, topk_decider, thr, topk, decay_shift, history,
      write_weight;
  int tm_ways, tm_sets, tm_bursts, tm_tag_read;
  // the divisors of the hot path: k, leaves a set, the remap cache's sets
  // and ways, the IdCache's sets and ways, the tag-matching sets and ways
  Div dk, dlps, dvs, dvw, dis, diw, dts, dtw;
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

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int fdiv(int a, const Div& v) {
  // a < 0: floor(a / d) = -floor((-a - 1) / d) - 1, and -x - 1 == ~x
  const int neg = a >> 31;
  const uint32_t x = (uint32_t)(a ^ neg);
  return (int)(((uint64_t)x * v.m) >> v.s) ^ neg;
}

__device__ __forceinline__ int fmodp(int a, const Div& v) {
  return a - fdiv(a, v) * v.d;
}

Div make_div(int d) {
  Div v;
  v.d = d < 1 ? 1 : d;
  int l = 0;
  while ((1LL << l) < v.d) ++l;
  v.s = 31 + l;
  v.m = (uint32_t)(((1ULL << v.s) + v.d - 1) / v.d);
  return v;
}

// Shared-memory words of one trace's small state (all int32; slot_dirty
// as 0/1 words, id_bits as uint32 words).  The counters live in warp 0's
// registers.
__host__ __device__ inline int64_t remap_smem_words(const Params& p) {
  return 2LL * p.slots + p.leaf_alloc + p.n_sets +
         2LL * p.vc_sets * p.vc_ways + p.vc_sets +
         2LL * p.id_sets * p.id_ways + p.id_sets;
}

__host__ __device__ inline int64_t tagmatch_smem_words(const Params& p) {
  return 2LL * p.tm_sets * p.tm_ways;
}

// ---------------------------------------------------------------------------
// block-wide reductions (every thread gets the result)
// ---------------------------------------------------------------------------

// A barrier of every thread of the block that may be reached from different
// places in the code (warp 0 and the other warps take the epoch edges from
// different loops): the form of __syncthreads without .aligned.
__device__ __forceinline__ void block_sync() {
  asm volatile("barrier.sync 0;" ::: "memory");
}

__device__ __forceinline__ int64_t block_reduce(int64_t v, int op,
                                                int64_t* scratch) {
  // op: 0 sum, 1 max, 2 min
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t u = __shfl_xor_sync(kFull, v, o);
    v = op == 0 ? v + u : (op == 1 ? (u > v ? u : v) : (u < v ? u : v));
  }
  block_sync();                    // the scratch of the last call is read
  if (lane == 0) scratch[warp] = v;
  block_sync();
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

// A slot id with its set s and its position u in the set (v = s*k + u).
struct Slot {
  int v, s, u;
};

// What one probe of the remap cache found.
struct Probe {
  bool hit, id_hit;
  int32_t val;
  int id_way;             // the IdCache's matching way, or -1
};

// One trace's access loop, run by warp 0, all 32 lanes alike.  RC (the
// remap cache's kind), FLAT and POL (the policy gate's PolicyKind) are
// compile-time, so the per-access path holds no branch on them.
template <int RC, bool FLAT, int POL>
struct Sim {
  static constexpr bool kIrc = RC == RC_IRC;
  const Params p;            // a copy: fields read as constants, not loads
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
  // this trace's rows in device memory
  int32_t* remap;
  int32_t* touch;
  int32_t* ema;
  int32_t* last;
  // the batch: lane j holds access i0 + j's block, flags (bit 0 write,
  // bit 1 dealloc), its remap-cache sets (value cache, IdCache), and the
  // current remap[b], sector vector of b >> 5 (iRC), touch[b] and ema[b]
  int bb, bwd, bvs, bsi;
  int32_t bm, bto, bem;
  uint32_t bsv;
  // every lane holds every counter (indexed by constants only)
  int32_t cnt[kCounters];

  // --- registers -------------------------------------------------------
  __device__ __forceinline__ void bump(int c, int32_t d) {
    cnt[c] = wrap_add(cnt[c], d);
  }
  // every store to an n_phys row goes through these: the row is written
  // (every lane the same value) and each batch lane on that entry is
  // patched, so no later access reads the row
  __device__ __forceinline__ void set_remap(int x, int32_t v) {
    remap[x] = v;
    bm = bb == x ? v : bm;
    if (kIrc) {
      const uint32_t bit = 1u << (x & 31);
      const uint32_t nv = v == kIdentity ? (bsv | bit) : (bsv & ~bit);
      bsv = (bb >> 5) == (x >> 5) ? nv : bsv;
    }
  }
  __device__ __forceinline__ void set_touch(int x, int32_t v, bool en) {
    if (en) touch[x] = v;
    bto = en && bb == x ? v : bto;
  }
  __device__ __forceinline__ void set_ema(int x, int32_t v, bool en) {
    if (en) ema[x] = v;
    bem = en && bb == x ? v : bem;
  }
  // a warp-uniform shared cell: every lane stores the same value and reads
  // its own store back, so no __syncwarp
  __device__ __forceinline__ void add(int32_t* a, int32_t d) {
    *a = wrap_add(*a, d);
  }

  // the batch of accesses [i0, i0 + 32): the trace words are already in
  // bb / bwd (loaded one batch ahead); one round trip for the state, each
  // lane its own access's words
  __device__ __forceinline__ void load_state() {
    bm = remap[bb];
    if (RC == RC_IRC || RC == RC_CONVENTIONAL) bvs = fmodp(bb, p.dvs);
    if (kIrc) bsi = id_index(bb >> 5);
    if (p.tracks) {
      bto = touch[bb];
      if (p.tracker == TR_MEA) bem = ema[bb];
    }
    if (kIrc) {
      // the sector vector of bb >> 5: its 128 B line, eight 16 B loads
      // issued together, one bit a word
      const int base = (bb >> 5) * 32;
      const int32_t* sec = remap + base;
      bsv = 0u;
      if (base + 32 <= p.n_phys &&
          (reinterpret_cast<uintptr_t>(sec) & 15) == 0) {
        int4 q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = reinterpret_cast<const int4*>(sec)[k];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          bsv |= (uint32_t)(q[k].x == kIdentity) << (4 * k) |
                 (uint32_t)(q[k].y == kIdentity) << (4 * k + 1) |
                 (uint32_t)(q[k].z == kIdentity) << (4 * k + 2) |
                 (uint32_t)(q[k].w == kIdentity) << (4 * k + 3);
      } else {
        for (int k = 0; k < 32 && base + k < p.n_phys; ++k)
          bsv |= (uint32_t)(sec[k] == kIdentity) << k;
      }
    }
  }
  // after the epoch edge rewrote the trackers
  __device__ __forceinline__ void reload_trackers() {
    bto = touch[bb];
    if (p.tracker == TR_MEA) bem = ema[bb];
  }

  // --- geometry (core/remap/geometry.py; closed forms of static_tables)
  __device__ __forceinline__ int lps() const { return p.lf + p.li; }
  __device__ __forceinline__ Slot slot_at(int v) const {
    const int s = fdiv(v, p.dk);
    return Slot{v, s, v - s * p.k};
  }
  __device__ __forceinline__ int lf_of(int x) const {
    if (!p.track) return 0;
    const int s = x & (p.n_sets - 1);
    const int w = x >> p.log_sets;
    return clampi(s * lps() + (w >> kLeafShift), 0, p.n_leaf - 1);
  }
  __device__ __forceinline__ int li_of(const Slot& v) const {
    if (!p.track) return 0;
    return clampi(v.s * lps() + p.lf + (v.u >> kLeafShift), 0,
                  p.n_leaf - 1);
  }
  __device__ __forceinline__ bool is_meta(const Slot& v) const {
    return v.u >= p.k_data;
  }
  __device__ __forceinline__ Slot slot_of_leaf(int leaf_id) const {
    if (p.n_leaf == 0) return Slot{-1, 0, 0};
    const int q = fdiv(leaf_id, p.dlps);
    const int j = leaf_id - q * lps();
    return j < p.k_meta ? Slot{q * p.k + p.k_data + j, q, p.k_data + j}
                        : Slot{-1, 0, 0};
  }
  __device__ __forceinline__ int home_block(const Slot& v) const {
    return (v.u << p.log_sets) | v.s;
  }
  __device__ __forceinline__ int id_index(int sb) const {
    const uint32_t h = ((uint32_t)sb * kHashMult) >> 16;
    return fmodp((int)h, p.dis);
  }

  // --- remap cache (core/remap/rcache.py) ------------------------------
  // The probe: the value cache (the conventional cache, or the iRC's
  // NonIdCache) and the IdCache, their cells loaded together.  A set holds
  // a tag at most once (a fill follows a miss; the IdCache refills a
  // present line in place), so the match is a ballot and the matching
  // way's word an OR across the warp, all four reductions side by side.
  // The probe in two halves: `look` loads b's cells of both caches (vs and
  // si: b's sets, from its batch lane), `match` reduces them.  The loop
  // puts work that does not need the match between the two, so the loads
  // are in flight meanwhile.
  struct Look {
    int32_t vt, vv, vfifo, it, ififo;
    uint32_t ibt;
    int vs, si;
  };
  __device__ __forceinline__ Look look(int b, int vs, int si) const {
    Look l{};
    if (RC != RC_IRC && RC != RC_CONVENTIONAL) return l;
    l.vs = vs;
    const int vb = vs * p.vc_ways;
    if (lane < p.vc_ways) {
      l.vt = vtag[vb + lane];
      l.vv = vval[vb + lane];
    }
    l.vfifo = vfifo[vs];
    if (kIrc) {
      l.si = si;
      const int ib = si * p.id_ways;
      if (lane < p.id_ways) {
        l.it = itag[ib + lane];
        l.ibt = ibits[ib + lane];
      }
      l.ififo = ififo[si];
    }
    return l;
  }
  // The match: the value cache (the conventional cache, or the iRC's
  // NonIdCache) and the IdCache.  A set holds a tag at most once (a fill
  // follows a miss; the IdCache refills a present line in place), so the
  // match is a ballot and the matching way's word an OR across the warp,
  // the four reductions side by side.
  __device__ __forceinline__ Probe match(int b, const Look& l) const {
    Probe r{};
    r.val = kIdentity;
    r.id_way = -1;
    if (RC != RC_IRC && RC != RC_CONVENTIONAL) return r;
    const int vw = p.vc_ways, sb = b >> 5;
    const bool vm = lane < vw && l.vt == b;
    unsigned vbal = __ballot_sync(kFull, vm);
    uint32_t val = __reduce_or_sync(kFull, vm ? (uint32_t)l.vv : 0u);
    unsigned ibal = 0;
    uint32_t line = 0;
    if (kIrc) {
      const bool im = lane < p.id_ways && l.it == sb;
      ibal = __ballot_sync(kFull, im);
      line = __reduce_or_sync(kFull, im ? l.ibt : 0u);
    }
    int way = ibal ? __ffs(ibal) - 1 : -1;
    if (vw > 32 || (kIrc && p.id_ways > 32)) {     // sets wider than a warp
      const int vb = l.vs * vw, ib = l.si * p.id_ways;
      for (int w0 = 32; w0 < vw || (kIrc && w0 < p.id_ways); w0 += 32) {
        const int w = w0 + lane;
        const bool vm2 = w < vw && vtag[vb + w] == b;
        vbal |= __ballot_sync(kFull, vm2);
        val |= __reduce_or_sync(kFull, vm2 ? (uint32_t)vval[vb + w] : 0u);
        if (kIrc) {
          const bool im2 = w < p.id_ways && itag[ib + w] == sb;
          const unsigned bal = __ballot_sync(kFull, im2);
          const uint32_t l2 = __reduce_or_sync(kFull,
                                               im2 ? ibits[ib + w] : 0u);
          if (bal && way < 0) {
            way = w0 + __ffs(bal) - 1;
            line = l2;
          }
        }
      }
    }
    r.hit = vbal != 0u;
    r.val = r.hit ? (int32_t)val : kIdentity;
    if (kIrc) {
      r.id_way = way;
      r.id_hit = way >= 0 && ((line >> (b & 31)) & 1u);
      r.hit = r.hit || r.id_hit;
    }
    return r;
  }
  // a walked entry into the cache, after a probe of the same id missed
  // (l: its look, the sets and FIFO pointers, unchanged since); vec is the
  // sector vector of id >> 5, from this access's batch lane
  __device__ __forceinline__ void fill(int id, int32_t dev, uint32_t vec,
                                       const Look& l, int id_way) const {
    if (RC == RC_CONVENTIONAL || (kIrc && dev != kIdentity)) {
      const int w = fmodp(l.vfifo, p.dvw);
      vtag[l.vs * p.vc_ways + w] = id;
      vval[l.vs * p.vc_ways + w] = dev;
      vfifo[l.vs] = wrap_add(l.vfifo, 1);
    } else if (kIrc) {
      const bool have = id_way >= 0;
      const int wi = have ? id_way : fmodp(l.ififo, p.diw);
      itag[l.si * p.id_ways + wi] = id >> 5;
      ibits[l.si * p.id_ways + wi] = vec;
      if (!have) ififo[l.si] = wrap_add(l.ififo, 1);
    }
  }
  // keep the cache consistent with a table update of id: value entries
  // die, IdCache bits change in place; each lane its own cells
  __device__ __forceinline__ void invalidate(int id,
                                             bool becomes_identity) const {
    if (RC != RC_IRC && RC != RC_CONVENTIONAL) return;
    const int vb = fmodp(id, p.dvs) * p.vc_ways;
    int ib = 0, sb = 0;
    if (kIrc) {
      sb = id >> 5;
      ib = id_index(sb) * p.id_ways;
    }
    for (int w0 = 0; w0 < p.vc_ways || (kIrc && w0 < p.id_ways); w0 += 32) {
      const int w = w0 + lane;
      if (w < p.vc_ways && vtag[vb + w] == id) vtag[vb + w] = -1;
      if (kIrc && w < p.id_ways && itag[ib + w] == sb) {
        const uint32_t bit = (uint32_t)(id & 31);
        ibits[ib + w] = (ibits[ib + w] & ~(1u << bit)) |
                        ((uint32_t)becomes_identity << bit);
      }
    }
    __syncwarp();
  }

  // --- the migration engine (simulator.py:125-257) ---------------------
  __device__ __forceinline__ bool copy_evict(const Slot& v) {
    const int o = owner[v.v];
    const bool has = o >= 0;
    const bool dirty_ = has && dirty[v.v] != 0;
    if (has) {
      set_remap(o, kIdentity);
      if (p.track) {
        add(&leaf[lf_of(o)], -1);
        if (is_meta(v)) add(&leaf[li_of(v)], -1);
      }
    }
    owner[v.v] = -1;
    dirty[v.v] = 0;
    bump(BY_FAST, dirty_ ? p.blk : 0);
    bump(BY_SLOW_WR, dirty_ ? p.blk : 0);
    bump(WRITEBACKS, dirty_ ? 1 : 0);
    if (has) invalidate(o, true);
    return has;
  }
  __device__ __forceinline__ void force_evict_hosted(int leaf_id) {
    if (!p.track) return;
    const int lc = clampi(leaf_id, 0, p.n_leaf - 1);
    const Slot h = slot_of_leaf(lc);
    if (h.v < 0) return;
    const int32_t n = leaf[lc], o = owner[h.v];
    if (n <= 0 || o < 0) return;
    if (copy_evict(h)) bump(FORCED_EVICT, 1);
  }
  // FIFO victim of set s for block b: the first admissible candidate,
  // else the one at the pointer; the pointer moves past it
  __device__ __forceinline__ Slot pick_victim(int b, int s) const {
    const int base = s * p.k, f = fifo[s];
    const int own_leaf_slot = p.track ? slot_of_leaf(lf_of(b)).v : -1;
    int found = -1;
    for (int j0 = 0; j0 < p.k && found < 0; j0 += 32) {
      const int j = j0 + lane;
      bool ok = false;
      if (j < p.k) {
        const Slot c{0, s, fmodp(f + j, p.dk)};
        const int cand = base + c.u;
        const bool meta = is_meta(c);
        ok = true;
        if (meta) {
          const int hj = c.u - p.k_data;
          const int h = hj < lps() ? s * lps() + hj : -1;
          ok = h >= 0 && leaf[clampi(h, 0, p.n_leaf - 1)] == 0;
        }
        if (p.track) {
          ok = ok && cand != own_leaf_slot;
          ok = ok && !(meta && slot_of_leaf(li_of(c)).v == cand);
        }
      }
      const unsigned bal = __ballot_sync(kFull, ok);
      if (bal) found = j0 + __ffs(bal) - 1;
    }
    const int pos = found < 0 ? 0 : found;
    const int u = fmodp(f + pos, p.dk);
    fifo[s] = fmodp(f + pos + 1, p.dk);
    return Slot{base + u, s, u};
  }
  __device__ __forceinline__ void install_copy(int b, const Slot& v, bool w) {
    copy_evict(v);
    const bool meta = is_meta(v);
    owner[v.v] = b;
    dirty[v.v] = w ? 1 : 0;
    set_remap(b, v.v);
    if (p.track) {
      add(&leaf[lf_of(b)], 1);
      if (meta) add(&leaf[li_of(v)], 1);
      force_evict_hosted(lf_of(b));
      if (meta) force_evict_hosted(li_of(v));
    }
    invalidate(b, false);
    bump(BY_SLOW_RD, p.blk);
    bump(BY_FAST, p.blk);
    bump(INSTALLS, 1);
  }
  __device__ __forceinline__ void install_swap(int b, const Slot& v) {
    const int fb = home_block(v);
    // the one device-memory read left on the chain, issued first: fb is
    // not in the batch in general (a swap, not every access)
    const bool fb_was_home = remap[fb] == kIdentity;
    const int o = owner[v.v];
    if (o >= 0 && o != fb) {          // a resident migrant goes home
      set_remap(o, kIdentity);
      if (p.track) add(&leaf[lf_of(o)], -1);
      invalidate(o, true);
      bump(BY_FAST, p.blk);
      bump(BY_SLOW_WR, p.blk);
    }
    // the displaced home block fb takes over b's slow home
    const int hb = b - p.fast_home;
    set_remap(fb, -(hb + 2));
    if (p.track && fb_was_home) add(&leaf[lf_of(fb)], 1);
    invalidate(fb, false);
    bump(BY_SLOW_WR, p.blk);
    bump(BY_FAST, fb_was_home ? p.blk : 0);
    bump(BY_SLOW_RD, fb_was_home ? 0 : p.blk);
    // b moves into v
    set_remap(b, v.v);
    owner[v.v] = b;
    dirty[v.v] = 0;
    if (p.track) {
      add(&leaf[lf_of(b)], 1);
      force_evict_hosted(lf_of(b));
      force_evict_hosted(lf_of(fb));
    }
    invalidate(b, false);
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
// the epoch edge, taken by the whole block (warp 0 from its access loop,
// the other warps from a loop over the edges alone)
// ---------------------------------------------------------------------------

// topk's cut: the k-th highest score over every block (after this
// access's touch), by binary search on counts; every thread gets it
__device__ __forceinline__ int32_t topk_cut(const Params& p,
                                            const int32_t* touch,
                                            const int32_t* ema,
                                            int64_t* scratch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  block_sync();                    // warp 0's touch of this access is in
  int64_t mx = LLONG_MIN, mn = LLONG_MAX;
  for (int j = tid; j < p.n_phys; j += nt) {
    const int64_t v = score_at(p, touch, ema, j);
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
      c += score_at(p, touch, ema, j) >= mid;
    if (block_reduce(c, 0, scratch) >= k) lo = mid;
    else hi = mid;
  }
  return (int32_t)lo;
}

// the decay of every block's tracker state, between two barriers
__device__ __forceinline__ void decay(const Params& p, int32_t* touch,
                                      int32_t* ema, const int32_t* last,
                                      int32_t step_after) {
  const int tid = threadIdx.x, nt = blockDim.x;
  block_sync();                    // warp 0's gate of this access is in
  const int32_t now = step_after >> p.decay_shift;
  for (int j = tid; j < p.n_phys; j += nt) {
    if (p.tracker == TR_MEA) {
      ema[j] = wrap_add(touch[j], ema[j] >> 1);
      touch[j] = 0;
    } else if (p.tracker == TR_RECENCY) {
      if (now - last[j] > p.history) touch[j] = 0;
    } else {
      touch[j] = touch[j] >> 1;
    }
  }
  block_sync();
}

// ---------------------------------------------------------------------------
// the remap-table kernel
// ---------------------------------------------------------------------------

template <int RC, bool FLAT, int POL>
__global__ void __launch_bounds__(kThreads, 1)
sim_scan_remap_kernel(const __grid_constant__ Params p) {
  extern __shared__ int32_t smem[];
  __shared__ int64_t scratch[32];
  const int t = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;

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
  __syncthreads();

  const int64_t row = (int64_t)t * p.n_phys;
  int32_t* touch = p.touch ? p.touch + row : nullptr;
  int32_t* ema = p.ema ? p.ema + row : nullptr;
  int32_t* last = p.last ? p.last + row : nullptr;
  const int32_t step0 = p.step[t];
  const int32_t mask =
      p.tracks ? (int32_t)((1u << p.decay_shift) - 1u) : 0;

  if (warp != 0) {
    // the other warps: the epoch edges alone, in order (the tick of an
    // access is known from its index: every trace is at the same step)
    if (p.tracks) {
      const int first =
          p.start + (int)((0u - (uint32_t)(step0 + 1)) & (uint32_t)mask);
      for (int i = first; i < p.end; i += mask + 1) {
        const int32_t step_after = step0 + (i - p.start) + 1;
        if (p.topk_decider) topk_cut(p, touch, ema, scratch);
        decay(p, touch, ema, last, step_after);
      }
    }
  } else {
    Sim<RC, FLAT, POL> sim{p, lane, owner, dirty, leaf, fifo, vtag, vval, vfifo,
                      itag, ibits, ififo, p.remap + row, touch, ema, last,
                      0, 0, 0, 0, 0, 0, 0, 0u, {}};
#pragma unroll
    for (int c = 0; c < kCounters; ++c)
      sim.cnt[c] = p.counters[(int64_t)t * kCounters + c];
    const bool mea = p.tracker == TR_MEA, recency = p.tracker == TR_RECENCY;
    int32_t step = step0;
    int32_t cut = p.topk_decider && p.tracks ? p.cut[t] : 0;
    int32_t budget = p.topk_decider && p.tracks ? p.budget[t] : 0;
    const int64_t trace = (int64_t)t * p.L;
    // the trace one batch ahead: access start + 32 + lane's words
    int nb = 0, nwd = 0;
    if (p.start + lane < p.end) {
      const int64_t x = trace + p.start + lane;
      nb = p.blocks[x];
      nwd = (p.writes[x] != 0) | ((p.deallocs[x] != 0) << 1);
    }

    for (int i = p.start; i < p.end; ++i) {
      const int32_t step_after = step0 + (i - p.start) + 1;
      const bool tick = p.tracks && (step_after & mask) == 0;
      const int j = (i - p.start) & 31;
      if (j == 0) {
        // a new batch: take the prefetched trace words, fetch the next
        // batch's, and load this batch's state in one round trip
        sim.bb = nb;
        sim.bwd = nwd;
        nb = 0;
        nwd = 0;
        if (i + 32 + lane < p.end) {
          const int64_t x = trace + i + 32 + lane;
          nb = p.blocks[x];
          nwd = (p.writes[x] != 0) | ((p.deallocs[x] != 0) << 1);
        }
        sim.load_state();
      }
      // this access's words, from lane j (one shuffle each, side by side)
      const int b = __shfl_sync(kFull, sim.bb, j);
      const int wd = __shfl_sync(kFull, sim.bwd, j);
      int32_t m = __shfl_sync(kFull, sim.bm, j);
      uint32_t sv = __shfl_sync(kFull, sim.bsv, j);
      int32_t to = __shfl_sync(kFull, sim.bto, j);
      int32_t em = __shfl_sync(kFull, sim.bem, j);
      const int vs = __shfl_sync(kFull, sim.bvs, j);
      const int si = __shfl_sync(kFull, sim.bsi, j);
      const bool d = p.dealloc && (wd & 2) != 0;
      const bool w = (wd & 1) != 0 && !d;
      const int s = b & (p.n_sets - 1);
      if (d) {
        // Section 3.5: the block is dead -> recycle its entry, free its
        // slot, skip the writeback
        const bool freed = m >= 0;
        const bool clearable = m >= kIdentity;
        const int slot0 = m > 0 ? m : 0;
        if (clearable) sim.set_remap(b, kIdentity);
        if (freed) {
          owner[slot0] = -1;
          dirty[slot0] = 0;
          if (p.track) {
            const Slot v0 = sim.slot_at(slot0);
            sim.add(&leaf[sim.lf_of(b)], -1);
            if (sim.is_meta(v0)) sim.add(&leaf[sim.li_of(v0)], -1);
          }
        }
        if (clearable) {
          sim.invalidate(b, true);
          m = kIdentity;
          sv |= 1u << (b & 31);
        }
        if (p.tracks) {
          sim.set_touch(b, 0, true);
          to = 0;
          if (mea) {
            sim.set_ema(b, 0, true);
            em = 0;
          }
          if (recency) last[b] = kStale;
        }
      }
      const bool skip = d;
      sim.bump(DEALLOCS, d ? 1 : 0);
      sim.bump(N_ACC, skip ? 0 : 1);
      step = step_after;

      // 1. metadata lookup, first half: b's remap-cache cells, in flight
      // through sections 2 and 3 (which do not read the cache)
      const auto look = sim.look(b, vs, si);

      // 2. data access
      const bool at_fast_home = FLAT && m == kIdentity && b < p.fast_home;
      const bool in_fast = (m >= 0 || at_fast_home) && !skip;
      const bool slow = !in_fast && !skip;
      sim.bump(SERVE_FAST, in_fast ? 1 : 0);
      sim.bump(CYC_FAST, in_fast ? p.t_fast : 0);
      sim.bump(BY_FAST, in_fast ? p.acc : 0);
      sim.bump(CYC_SLOW, slow ? p.t_slow_rd : 0);
      sim.bump(BY_SLOW_WR, slow && w ? p.acc : 0);
      sim.bump(BY_SLOW_RD, slow && !w ? p.acc : 0);
      if (w && m >= 0) dirty[m] = 1;

      // 3. the policy gate: record the touch, decide, reset on a move;
      // at the epoch edge the block ranks (topk) before the decision and
      // decays after it
      const bool elig = FLAT ? (slow && b >= p.fast_home) : slow;
      bool go = elig;                  // untracked: every eligible miss
      const int32_t inc = p.write_weight <= 1 ? 1
                          : (w ? p.write_weight : 1);
      if (POL == POL_TOUCH) {
        // touch[b] ends as the touch, or 0 after a move: one store
        const int32_t sc = wrap_add(to, inc);
        go = elig && sc >= p.thr;
        sim.set_touch(b, go ? 0 : sc, elig);
      } else if (POL == POL_ANY) {
        to = elig ? wrap_add(to, inc) : to;
        sim.set_touch(b, to, elig);
        if (recency && elig) last[b] = step >> p.decay_shift;
        const int32_t sc = mea ? wrap_add(to, em >> 1) : to;
        if (p.topk_decider) {
          if (tick) {
            const int32_t kth = topk_cut(p, touch, ema, scratch);
            cut = kth > 1 ? kth : 1;
            budget = p.topk;
          }
          go = elig && sc >= 1 && sc >= cut && budget > 0;
          budget -= go ? 1 : 0;
        } else {
          go = elig && sc >= p.thr;
        }
        sim.set_touch(b, 0, go);
        if (mea) sim.set_ema(b, 0, go);
      }
      if (POL != POL_NONE && tick) {
        decay(p, touch, ema, last, step_after);
        sim.reload_trackers();         // one round trip
      }

      // 1. metadata lookup, second half: the match, then the table walk
      // on a miss (its fill before this access's install, as in the
      // reference)
      if (RC != RC_IDEAL) {
        const Probe r = sim.match(b, look);
        const bool hit = r.hit || skip;
        const bool walk = !hit;
        sim.bump(RC_INCONS, hit && r.val != m ? 1 : 0);
        sim.bump(RC_HIT, hit ? 1 : 0);
        sim.bump(RC_ID_HIT, r.id_hit ? 1 : 0);
        sim.bump(RC_NID_HIT, hit && !r.id_hit ? 1 : 0);
        sim.bump(WALKS, walk ? 1 : 0);
        sim.bump(CYC_SRAM, p.t_sram);
        sim.bump(CYC_META, walk ? p.t_fast_meta : 0);
        sim.bump(BY_FAST, walk ? p.acc * p.n_meta_acc : 0);
        if (walk) sim.fill(b, m, sv, look, r.id_way);
      }

      // 4. install / migrate
      if (go) {
        const Slot v = sim.pick_victim(b, s);
        if (!FLAT || sim.is_meta(v)) {
          sim.install_copy(b, v, w);
        } else if (FLAT) {
          sim.install_swap(b, v);
        }
      }
    }

    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCounters; ++c)
        p.counters[(int64_t)t * kCounters + c] = sim.cnt[c];
      p.step[t] = step;
      if (p.topk_decider && p.tracks) {
        p.cut[t] = cut;
        p.budget[t] = budget;
      }
    }
  }

  block_sync();
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
  for (int j = lane; j < n; j += 32) {
    owner[j] = p.slot_owner[(int64_t)t * n + j];
    dirty[j] = p.slot_dirty[(int64_t)t * n + j] ? 1 : 0;
  }
  // every lane holds every counter and the FIFO pointer (warp-uniform)
  int32_t cnt[kCounters];
#pragma unroll
  for (int c = 0; c < kCounters; ++c)
    cnt[c] = p.counters[(int64_t)t * kCounters + c];
  int32_t fifo = p.fifo[t];
  __syncwarp();

  const int ways = p.tm_ways;
  const bool tag_read = p.tm_tag_read != 0;
  const int64_t trace = (int64_t)t * p.L;
  // the batch: lane j holds access i0 + j's block, write flag and set's
  // first slot; the next batch's block and flag are loaded one batch
  // ahead.  fw is the FIFO pointer's way, computed as soon as it moves.
  int bb = 0, bw = 0, bs = 0, nb = 0, nw = 0;
  int fw = fmodp(fifo, p.dtw);
  if (p.start + lane < p.end) {
    nb = p.blocks[trace + p.start + lane];
    nw = p.writes[trace + p.start + lane] != 0;
  }
  for (int i = p.start; i < p.end; ++i) {
    const int j = (i - p.start) & 31;
    if (j == 0) {
      bb = nb;
      bw = nw;
      nb = 0;
      nw = 0;
      if (i + 32 + lane < p.end) {
        nb = p.blocks[trace + i + 32 + lane];
        nw = p.writes[trace + i + 32 + lane] != 0;
      }
      bs = fmodp(bb, p.dts) * ways;
    }
    const int b = __shfl_sync(kFull, bb, j);
    const bool w = __shfl_sync(kFull, bw, j) != 0;
    const int slot0 = __shfl_sync(kFull, bs, j);
    int way = -1;
    for (int w0 = 0; w0 < ways && way < 0; w0 += 32) {
      const unsigned bal = __ballot_sync(
          kFull, w0 + lane < ways && owner[slot0 + w0 + lane] == b);
      if (bal) way = w0 + __ffs(bal) - 1;
    }
    const bool hit = way >= 0, miss = !hit;
    const int slot = slot0 + (hit ? way : fw);
    // on a miss the occupant is evicted (written back if dirty) and b
    // installed; on a hit b is already the owner
    const int32_t o = owner[slot], dt = dirty[slot];
    const bool wb = miss && o >= 0 && dt != 0;
    const int32_t hf = hit ? 1 : 0, mf = miss ? 1 : 0;
    cnt[N_ACC] = wrap_add(cnt[N_ACC], 1);
    // the tags are read from the same DRAM row before the data
    cnt[CYC_META] = wrap_add(cnt[CYC_META],
                             hit && tag_read ? p.t_fast_meta * p.tm_bursts : 0);
    cnt[SERVE_FAST] = wrap_add(cnt[SERVE_FAST], hf);
    cnt[CYC_FAST] = wrap_add(cnt[CYC_FAST], hit ? p.t_fast : 0);
    cnt[CYC_SLOW] = wrap_add(cnt[CYC_SLOW], miss ? p.t_slow_rd : 0);
    cnt[BY_FAST] = wrap_add(
        cnt[BY_FAST], (hit ? p.acc + (tag_read ? p.tm_bursts * p.acc : 0) : 0)
                          + (wb ? p.blk : 0) + (miss ? p.blk : 0));
    cnt[BY_SLOW_RD] = wrap_add(cnt[BY_SLOW_RD], miss ? p.acc + p.blk : 0);
    cnt[BY_SLOW_WR] = wrap_add(cnt[BY_SLOW_WR], wb ? p.blk : 0);
    cnt[WRITEBACKS] = wrap_add(cnt[WRITEBACKS], wb ? 1 : 0);
    cnt[INSTALLS] = wrap_add(cnt[INSTALLS], mf);
    owner[slot] = b;
    dirty[slot] = w ? 1 : (hit ? dt : 0);
    fifo = wrap_add(fifo, mf);
    fw = fmodp(fifo, p.dtw);
  }

  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    p.slot_owner[(int64_t)t * n + j] = owner[j];
    p.slot_dirty[(int64_t)t * n + j] = dirty[j] ? 1 : 0;
  }
  if (lane == 0) {
    p.fifo[t] = fifo;
#pragma unroll
    for (int c = 0; c < kCounters; ++c)
      p.counters[(int64_t)t * kCounters + c] = cnt[c];
  }
}

// ---------------------------------------------------------------------------
// the chain's yardstick: the latency of one dependent load on this card
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One thread follows next[] around a cycle of n words: kind 0 in shared
// memory (the cycle copied in first), kind 1 in device memory through L2
// (ld.global.cg, past L1).  `warm` hops untimed, then `steps` hops between
// two stamps.  out: [SM cycles, ns, the index reached].
__global__ void sim_scan_chase_kernel(const int32_t* next, int n, int kind,
                                      int warm, int steps, int64_t* out) {
  extern __shared__ int32_t ring[];
  if (kind == 0) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) ring[j] = next[j];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  int j = 0;
  long long c0 = 0, c1 = 0;
  uint64_t g0 = 0, g1 = 0;
  if (kind == 0) {
    for (int s = 0; s < warm; ++s) j = ring[j];
    c0 = clock64();
    g0 = global_ns();
#pragma unroll 8
    for (int s = 0; s < steps; ++s) j = ring[j];
    ring[n] = j;                    // the last hop lands before the stamp
    c1 = clock64();
    g1 = global_ns();
  } else {
    for (int s = 0; s < warm; ++s) j = __ldcg(next + j);
    c0 = clock64();
    g0 = global_ns();
#pragma unroll 8
    for (int s = 0; s < steps; ++s) j = __ldcg(next + j);
    out[2] = j;
    c1 = clock64();
    g1 = global_ns();
  }
  out[0] = c1 - c0;
  out[1] = (int64_t)(g1 - g0);
  out[2] = j;
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
  p.dk = make_div(p.k);
  p.dlps = make_div(p.lf + p.li);
  p.dvs = make_div(p.vc_sets);
  p.dvw = make_div(p.vc_ways);
  p.dis = make_div(p.id_sets);
  p.diw = make_div(p.id_ways);
  p.dts = make_div(p.tm_sets);
  p.dtw = make_div(p.tm_ways);
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

// one instantiation per remap-cache kind, mode and policy kind
template <int RC, bool FLAT>
int launch_remap_mode(const Params& p, void* stream) {
  const int64_t words = remap_smem_words(p);
  if (!p.tracks)
    return launch(sim_scan_remap_kernel<RC, FLAT, POL_NONE>, p, kThreads,
                  words, stream);
  if (p.tracker == TR_TOUCH && !p.topk_decider)
    return launch(sim_scan_remap_kernel<RC, FLAT, POL_TOUCH>, p, kThreads,
                  words, stream);
  return launch(sim_scan_remap_kernel<RC, FLAT, POL_ANY>, p, kThreads, words,
                stream);
}

template <int RC>
int launch_remap(const Params& p, void* stream) {
  return p.flat ? launch_remap_mode<RC, true>(p, stream)
                : launch_remap_mode<RC, false>(p, stream);
}

}  // namespace

extern "C" {

// The argument vector's length, checked by the wrapper against its own.
int sim_scan_n_args() { return kArgs; }

int sim_scan_remap(const int64_t* args, void* stream) {
  const Params p = unpack(args);
  if (p.T == 0 || p.start >= p.end) return 0;
  switch (p.rc_kind) {
    case RC_IRC: return launch_remap<RC_IRC>(p, stream);
    case RC_CONVENTIONAL: return launch_remap<RC_CONVENTIONAL>(p, stream);
    case RC_NONE: return launch_remap<RC_NONE>(p, stream);
    case RC_IDEAL: return launch_remap<RC_IDEAL>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int sim_scan_tagmatch(const int64_t* args, void* stream) {
  const Params p = unpack(args);
  if (p.T == 0 || p.start >= p.end) return 0;
  return launch(sim_scan_tagmatch_kernel, p, 32, tagmatch_smem_words(p),
                stream);
}

// The chase (kind 0 shared memory, 1 device memory through L2) over the
// n-word cycle next[]; out gets [cycles, ns, index] of the timed hops.
int sim_scan_chase(const int32_t* next, int n, int kind, int warm,
                   int steps, int64_t* out, void* stream) {
  const int64_t bytes = kind == 0 ? 4LL * (n + 1) : 0;
  if (n <= 0 || bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sim_scan_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  sim_scan_chase_kernel<<<1, 256, (size_t)bytes, (cudaStream_t)stream>>>(
      next, n, kind, warm, steps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
