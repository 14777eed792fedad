// paged_attention_core.cuh: the device code every paged decode-attention
// kernel of the port shares: the page walk with its fp32 online softmax,
// the ordered merges, and the launch.  What differs between the kernels is
// only where a page's K/V tiles come from and which columns a query row
// sees; a routing functor (`Route`) supplies that:
//
//   int lane(b)                 per-lane state read once per block
//   int visible(s)              columns [0, visible) may be seen at all; a
//                               lane's walk stops at the first page at or
//                               past it (<= 0: the lane reads no page)
//   int limit(s, r, G)          query row r sees columns below limit
//   void tiles(b, h, j, &k, &v) pointers to page j's [P, hd] K/V tiles
//   int fresh(j, s, row)        the step's token t whose new row replaces
//                               row `row` of page j once the tile has
//                               landed, or -1
//   void fresh_rows(b, h, t, &k, &v)  pointers to token t's new K/V rows
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
// Bound on the H100: bytes.  At R = K*G = 4 query rows a page's K and V
// tile costs about 4 flops per byte, far under the ~295 where the tensor
// cores bind, so the design keeps device memory busy and spends no
// tensor cores:
//  * each (lane, kv head) is cut into splits of a fixed width by absolute
//    page index, one block of W warps (4 at the main path's pages) per
//    (lane, kv head, split); warp w walks pages split*2W + w and
//    split*2W + W + w;
//  * per page the warp reads the route first (the tier is chosen before
//    the load: each page reads one tier) and copies the K and V tiles
//    with cp.async, 16 bytes a lane, into its own ring of two stages in
//    shared memory, so both of its pages are in flight before the first
//    is scored and a block keeps 2W pages in flight;
//  * no block barrier per page: a warp waits for its own copies, and the
//    lane that copied a 16-byte chunk of a new row overwrites it once
//    landed (the fused route's overlay), then __syncwarp;
//  * scores: groups of up to 8 lanes own one column each (8 consecutive
//    16-byte chunks of a K row: no bank conflicts) for all R rows at once
//    (q in registers up to 4 rows), a 3-step xor reduction per (row, 4
//    columns); the row max and sum over
//    a page are one group of min(P, 32) lanes per row; P V: each lane owns
//    hd/32 output dims of every row in registers, one fmaf chain over the
//    page's columns;
//  * the warps' states merge in warp order in shared memory, the block
//    writes its split's (m, l, acc) to scratch, and the last block of a
//    (lane, kv head) to arrive (an integer counter, reset by that block)
//    merges the live splits in split order and writes the output: one
//    launch, and nothing depends on which block arrives last.
// A page every row masks, and a split holding only such pages, adds
// exact zeros (p = 0, or a state with m = -1e30 weighted exp(-1e30 - m)
// = 0 in a merge), so a lane stops at its first such page, splits past
// its last live page neither run nor merge, a live-page bucket equals the
// full width bit for bit, and only live bytes are read.  A lane that sees
// nothing reads no page and its output is zeros (the plain versions'
// uniform average of stale bytes there is never read).  The kernels
// allocate nothing (the caller passes the fp32 split scratch and the
// B*KV counters, zero before the first call) and run on the caller's
// stream.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pa {

constexpr float kNegInf = -1e30f;
constexpr int kPagesPerWarp = 2;        // = ring stages when they fit
constexpr size_t kSmemLimit = 227 * 1024;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n (1, 2 or 4) consecutive elements at p, aligned to n elements
__device__ __forceinline__ void load_n(const float* p, int n, float* o) {
  if (n == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) o[i] = p[i];
  }
}
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, int n,
                                       float* o) {
  if (n == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    o[0] = lo_bf16(x.x); o[1] = hi_bf16(x.x);
    o[2] = lo_bf16(x.y); o[3] = hi_bf16(x.y);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) o[i] = __bfloat162float(p[i]);
  }
}
// one 16-byte chunk (4 floats or 8 bf16) unpacked to fp32; the last
// argument names the element type
__device__ __forceinline__ void unpack_chunk(const uint4& x, float* o,
                                             float) {
  o[0] = __uint_as_float(x.x); o[1] = __uint_as_float(x.y);
  o[2] = __uint_as_float(x.z); o[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack_chunk(const uint4& x, float* o,
                                             __nv_bfloat16) {
  o[0] = lo_bf16(x.x); o[1] = hi_bf16(x.x);
  o[2] = lo_bf16(x.y); o[3] = hi_bf16(x.y);
  o[4] = lo_bf16(x.z); o[5] = hi_bf16(x.z);
  o[6] = lo_bf16(x.w); o[7] = hi_bf16(x.w);
}
template <typename T>
__device__ __forceinline__ void load_chunk(const T* p, float* o) {
  unpack_chunk(*reinterpret_cast<const uint4*>(p), o, T());
}

// Warps per block and ring stages per warp, from what shared memory
// holds; a function of (R, hd, P, dtype) only, never of B or npages, so
// a bucket and the full width split alike.  warps == 0: does not fit.
struct Plan {
  int warps, stages, rows_max;
  size_t smem;
};

inline Plan plan(int R, int hd, int P, size_t item) {
  Plan p{0, 0, 0, 0};
  p.rows_max = R <= 4 ? 4 : R <= 8 ? 8 : R <= 16 ? 16 : R <= 32 ? 32 : 0;
  if (!p.rows_max) return p;
  const int cand[4][2] = {{4, 2}, {4, 1}, {2, 1}, {1, 1}};
  for (const auto& c : cand) {
    const size_t ring = (size_t)c[0] * c[1] * 2 * P * hd * item;
    const size_t merge = (size_t)c[0] * R * hd * sizeof(float);
    const size_t s = (ring > merge ? ring : merge) +
                     (size_t)c[0] * R * hd * item +
                     sizeof(float) * (size_t)c[0] * R * (P + 3) + 16;
    if (s <= kSmemLimit) {
      p.warps = c[0];
      p.stages = c[1];
      p.smem = s;
      return p;
    }
  }
  return p;
}

inline int split_pages(const Plan& p) { return p.warps * kPagesPerWarp; }

inline long long n_splits(const Plan& p, int npages) {
  return (npages + split_pages(p) - 1) / split_pages(p);
}

// fp32 floats of split scratch one call needs (m, l and acc per split),
// or -1 if the shape does not fit a block
inline long long scratch_floats(int B, int K, int KV, int G, int hd, int P,
                                size_t item, int npages) {
  const Plan p = plan(K * G, hd, P, item);
  if (!p.warps) return -1;
  return (long long)B * KV * n_splits(p, npages) * K * G * (hd + 2);
}

template <typename T, typename Route, int RM>
__global__ void __launch_bounds__(128)
paged_kernel(const T* __restrict__ q, Route route, T* __restrict__ out,
             float* __restrict__ part_m, float* __restrict__ part_l,
             float* __restrict__ part_acc, unsigned int* __restrict__ counters,
             int n_split, int KV, int G, int hd, int P, int K, int npages,
             int NS, float scale) {
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int MAXU = 16 / EPC;        // chunks per score lane, hd <= 128
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = blockDim.x >> 5;
  const int R = K * G;
  const int SW = NW * kPagesPerWarp;
  const int tile = P * hd;              // elements of one K or V tile
  const int ring_b = NW * NS * 2 * tile * (int)sizeof(T);
  const int merge_b = NW * R * hd * (int)sizeof(float);
  T* ring = reinterpret_cast<T*>(smem);                  // [NW][NS][2][P,hd]
  float* wacc = reinterpret_cast<float*>(smem);          // later [NW][R][hd]
  T* qs = reinterpret_cast<T*>(
      smem + (ring_b > merge_b ? ring_b : merge_b));     // [NW][R][hd]
  float* sc = reinterpret_cast<float*>(qs + NW * R * hd);  // [NW][R][P]
  float* wm = sc + NW * R * P;                           // [NW][R]
  float* wl = wm + NW * R;                               // [NW][R]
  float* wc = wl + NW * R;                               // [NW][R]
  int* last = reinterpret_cast<int*>(wc + NW * R);

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int CH = hd / EPC;              // chunks per row
  constexpr bool kQRegs = RM <= 4;      // q in registers: 16 floats a row

  // this warp's pages are j0 + NW*i; their routes are read alongside
  // the lane's position
  const int j0 = split * SW + warp;
  const T* src_k[kPagesPerWarp];
  const T* src_v[kPagesPerWarp];
#pragma unroll
  for (int i = 0; i < kPagesPerWarp; ++i)
    if (j0 + NW * i < npages)
      route.tiles(b, h, j0 + NW * i, &src_k[i], &src_v[i]);

  // the query rows (rows t*G..t*G+G-1 are contiguous): a score lane's
  // chunks in registers when they fit, else each warp's copy in shared
  // memory, in flight with the first page
  const int LPC = CH < 8 ? CH : 8;      // lanes per score column
  const int sub = lane % LPC;
  T* my_q = qs + warp * R * hd;
  uint4 qreg[kQRegs ? RM : 1][kQRegs ? MAXU : 1];
  if (kQRegs) {
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int u = 0; u < MAXU; ++u)
        if (r < R && sub + LPC * u < CH)
          qreg[kQRegs ? r : 0][kQRegs ? u : 0] =
              __ldg(reinterpret_cast<const uint4*>(
                  q + ((((int64_t)b * K + r / G) * KV + h) * G + r % G) * hd +
                  (sub + LPC * u) * EPC));
  } else {
    for (int c = lane; c < R * CH; c += 32) {
      const int r = c / CH;
      cp_async16(my_q + c * EPC,
                 q + ((((int64_t)b * K + r / G) * KV + h) * G + r % G) * hd +
                     (c % CH) * EPC);
    }
  }
  const int s = route.lane(b);
  const int visible = route.visible(s);
  const int live_pages = visible > 0 ? min(npages, (visible + P - 1) / P) : 0;
  const int n_live = (live_pages + SW - 1) / SW;
  if (split >= n_live) {
    cp_commit();
    cp_wait<0>();
    if (split == 0)                     // the lane sees nothing: zeros
      for (int e = tid; e < R * hd; e += blockDim.x) {
        const int r = e / hd, d = e % hd, t = r / G, g = r % G;
        out[((((int64_t)b * K + t) * KV + h) * G + g) * hd + d] =
            from_f<T>(0.f);
      }
    return;
  }
  int n_mine = 0;                       // this warp's live pages
  while (n_mine < kPagesPerWarp && j0 + NW * n_mine < live_pages) ++n_mine;
  T* my_ring = ring + warp * NS * 2 * tile;
  auto issue = [&](int i) {
    const T* ks = src_k[0];
    const T* vs = src_v[0];
#pragma unroll
    for (int k = 1; k < kPagesPerWarp; ++k)
      if (i == k) {
        ks = src_k[k];
        vs = src_v[k];
      }
    T* kt = my_ring + (i % NS) * 2 * tile;
    T* vt = kt + tile;
#pragma unroll 2
    for (int c = lane; c < P * CH; c += 32) {
      cp_async16(kt + c * EPC, ks + c * EPC);
      cp_async16(vt + c * EPC, vs + c * EPC);
    }
  };
#pragma unroll
  for (int i = 0; i < kPagesPerWarp; ++i)
    if (i < NS) {
      if (i < n_mine) issue(i);
      cp_commit();                      // group 0 holds the query rows too
    }

  float qf[kQRegs ? RM : 1][kQRegs ? MAXU * EPC : 1];
  if (kQRegs)
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int u = 0; u < MAXU; ++u)
        unpack_chunk(qreg[kQRegs ? r : 0][kQRegs ? u : 0],
                     &qf[kQRegs ? r : 0][kQRegs ? u * EPC : 0], T());
  float* my_sc = sc + warp * R * P;
  float* my_m = wm + warp * R;
  float* my_l = wl + warp * R;
  float* my_c = wc + warp * R;
  for (int r = lane; r < R; r += 32) {
    my_m[r] = kNegInf;
    my_l[r] = 0.f;
  }
  const int CPP = 32 / LPC;             // columns per pass
  const int cs = lane / LPC;
  const int GL = P < 32 ? P : 32;       // lanes per softmax row
  const int RPP = 32 / GL;
  const int DPL = hd >= 32 ? hd / 32 : 1;  // output dims per lane
  const int d0 = lane * DPL;
  const bool pv = d0 < hd;
  float acc[RM][4];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

#pragma unroll 1                        // the body is large: keep one copy
  for (int i = 0; i < n_mine; ++i) {
    if (NS > 1 && i + 1 < n_mine) cp_wait<1>(); else cp_wait<0>();
    const int j = j0 + NW * i;
    T* kt = my_ring + (i % NS) * 2 * tile;
    T* vt = kt + tile;
    // overlay: the lane that copied a chunk of a new row rewrites it
    for (int c = lane; c < P * CH; c += 32) {
      const int t = route.fresh(j, s, c / CH);
      if (t >= 0) {
        const T* kn;
        const T* vn;
        route.fresh_rows(b, h, t, &kn, &vn);
        const int off = (c % CH) * EPC;
        *reinterpret_cast<uint4*>(kt + c * EPC) =
            *reinterpret_cast<const uint4*>(kn + off);
        *reinterpret_cast<uint4*>(vt + c * EPC) =
            *reinterpret_cast<const uint4*>(vn + off);
      }
    }
    __syncwarp();

    // scores: lane group cs owns column c0 + cs, its lanes split hd; row
    // r sees the page's columns below lim[r]
    int lim[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) lim[r] = route.limit(s, r, G) - j * P;
#pragma unroll 1
    for (int c0 = 0; c0 < P; c0 += CPP) {
      const int c = c0 + cs;
      const T* krow = kt + (c < P ? c : P - 1) * hd;
      float part[RM];                   // all rows at once: RM chains
#pragma unroll
      for (int r = 0; r < RM; ++r) part[r] = 0.f;
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        const int ch = sub + LPC * u;   // chunks sub, sub + LPC, ...
        if (ch < CH) {
          float kv[EPC];
          load_chunk(krow + ch * EPC, kv);
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < R) {
              float qv[EPC];
              if (!kQRegs) load_chunk(my_q + r * hd + ch * EPC, qv);
#pragma unroll
              for (int e = 0; e < EPC; ++e)
                part[r] = fmaf(kQRegs ? qf[kQRegs ? r : 0][u * EPC + e]
                                      : qv[e],
                               kv[e], part[r]);
            }
        }
      }
      for (int off = LPC / 2; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < RM; ++r)
          part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      if (sub == 0 && c < P)
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < R)
            my_sc[r * P + c] = c < lim[r] ? part[r] * scale : kNegInf;
    }
    __syncwarp();

    // online softmax over this page, GL lanes per row
    for (int r0 = 0; r0 < R; r0 += RPP) {
      const int r = r0 + lane / GL, cl = lane % GL;
      const bool ok = r < R;
      float mx = -INFINITY;
      if (ok)
        for (int c = cl; c < P; c += GL) mx = fmaxf(mx, my_sc[r * P + c]);
      for (int off = GL / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ok ? my_m[r] : 0.f;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (ok)
        for (int c = cl; c < P; c += GL) {
          const float p = expf(my_sc[r * P + c] - m_new);
          my_sc[r * P + c] = p;
          sum += p;
        }
      for (int off = GL / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (ok && cl == 0) {
        const float cr = expf(m_prev - m_new);
        my_c[r] = cr;
        my_l[r] = my_l[r] * cr + sum;
        my_m[r] = m_new;
      }
    }
    __syncwarp();

    // acc = acc * corr + P V, each lane its DPL dims of every row
    if (pv) {
#pragma unroll
      for (int r = 0; r < RM; ++r)
        if (r < R) {
          const float cr = my_c[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] *= cr;
        }
      for (int c4 = 0; c4 < P; c4 += 4) {  // 4 columns: one p load a row
        float4 p4[RM];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          if (r < R)
            p4[r] = *reinterpret_cast<const float4*>(my_sc + r * P + c4);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float vv[4] = {0.f, 0.f, 0.f, 0.f};
          load_n(vt + (c4 + cc) * hd + d0, DPL, vv);
#pragma unroll
          for (int r = 0; r < RM; ++r)
            if (r < R) {
              const float p = cc == 0 ? p4[r].x : cc == 1 ? p4[r].y
                            : cc == 2 ? p4[r].z : p4[r].w;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[r][e] = fmaf(p, vv[e], acc[r][e]);
            }
        }
      }
    }
    __syncwarp();                       // the stage may be refilled
    if (i + NS < n_mine) {
      issue(i + NS);
      cp_commit();
    }
  }
  cp_wait<0>();
  __syncthreads();                      // every warp is off the ring
  if (pv)
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (r < R)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < DPL) wacc[(warp * R + r) * hd + d0 + e] = acc[r][e];
  __syncthreads();

  // the split's state: the warps' states merged in warp order
  const int64_t base = ((int64_t)blockIdx.x * n_split + split) * R;
  for (int e = tid; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e % hd;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float l = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float x = expf(wm[w * R + r] - mx);
      l += wl[w * R + r] * x;
      a += wacc[(w * R + r) * hd + d] * x;
    }
    part_acc[(base + r) * hd + d] = a;
    if (d == 0) {
      part_m[base + r] = mx;
      part_l[base + r] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *last = atomicAdd(counters + blockIdx.x, 1u) == (unsigned)(n_live - 1);
  __syncthreads();
  if (!*last) return;

  // the last block of this (lane, kv head) merges the live splits (a
  // split every row masks has m = -1e30, l = 0, acc = 0 and adds exact
  // zeros, so the dead ones are left out): one warp per query row, lane
  // k holding splits k, k+32, ... in order, then a fixed xor butterfly;
  // each lane's output dims sum the splits in split order
  __threadfence();
  const int64_t base0 = (int64_t)blockIdx.x * n_split * R;
  for (int r = warp; r < R; r += NW) {
    float mx = -INFINITY;
    for (int sp = lane; sp < n_live; sp += 32)
      mx = fmaxf(mx, __ldcg(part_m + base0 + sp * R + r));
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f, w0 = 0.f;            // w0: split `lane`'s weight
    for (int sp = lane; sp < n_live; sp += 32) {
      const int64_t i = base0 + sp * R + r;
      const float w = expf(__ldcg(part_m + i) - mx);
      if (sp == lane) w0 = w;
      l += __ldcg(part_l + i) * w;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int sp = 0; sp < n_live; ++sp) {
      const int64_t i = base0 + sp * R + r;
      const float w = sp < 32 ? __shfl_sync(0xffffffffu, w0, sp)
                              : expf(__ldcg(part_m + i) - mx);
      if (pv) {
        const float* src = part_acc + i * hd + d0;
        float v[4];
        if (DPL == 4) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(src));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = e < DPL ? __ldcg(src + e) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] += v[e] * w;
      }
    }
    const int t = r / G, g = r % G;
    T* o = out + ((((int64_t)b * K + t) * KV + h) * G + g) * hd + d0;
    const float den = fmaxf(l, 1e-30f);
    if (pv)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < DPL) o[e] = from_f<T>(a[e] / den);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;   // ready for the next call
}

template <typename T, typename Route, int RM>
int launch_rm(const T* q, const Route& route, T* out, float* scratch,
              unsigned int* counters, const Plan& p, int B, int K, int KV,
              int G, int hd, int P, int npages, cudaStream_t stream) {
  auto kern = paged_kernel<T, Route, RM>;
  static bool opted_in = false;         // once: the call is not free
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int n_split = (int)n_splits(p, npages);
  const size_t parts = (size_t)B * KV * n_split * K * G;
  float* part_acc = scratch;            // first: 16-byte aligned rows
  float* part_m = part_acc + parts * hd;
  float* part_l = part_m + parts;
  kern<<<dim3(B * KV, n_split > 0 ? n_split : 1), 32 * p.warps, p.smem,
         stream>>>(q, route, out, part_m, part_l, part_acc, counters,
                   n_split, KV, G, hd, P, K, npages, p.stages,
                   1.0f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

// One launch on `stream`; `scratch` holds scratch_floats(...) floats and
// `counters` B*KV unsigned ints, zero (the kernel leaves them zero).
// Returns cudaGetLastError() after the launch (0 on success).
template <typename T, typename Route>
int launch(const T* q, const Route& route, T* out, float* scratch,
           unsigned int* counters, int B, int K, int KV, int G, int hd,
           int P, int npages, cudaStream_t stream) {
  const Plan p = plan(K * G, hd, P, sizeof(T));
  switch (p.warps ? p.rows_max : 0) {
    case 4: return launch_rm<T, Route, 4>(q, route, out, scratch, counters,
                                          p, B, K, KV, G, hd, P, npages,
                                          stream);
    case 8: return launch_rm<T, Route, 8>(q, route, out, scratch, counters,
                                          p, B, K, KV, G, hd, P, npages,
                                          stream);
    case 16: return launch_rm<T, Route, 16>(q, route, out, scratch,
                                            counters, p, B, K, KV, G, hd, P,
                                            npages, stream);
    case 32: return launch_rm<T, Route, 32>(q, route, out, scratch,
                                            counters, p, B, K, KV, G, hd, P,
                                            npages, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace pa
