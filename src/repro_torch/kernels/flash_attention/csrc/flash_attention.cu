// flash_attention: GQA prefill attention (causal, sliding-window or full)
// over the model's layouts, with an online softmax over key blocks.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// :70 (`flash_attention`, body `_kernel` l.28), whose grid (b, h, q block,
// k block) walks the key blocks as a sequential ("arbitrary") axis and
// carries the softmax state in VMEM scratch from one grid step to the
// next.  Here a thread block loops over the key blocks itself; nothing
// carries over between blocks.
//
// Inputs: q [B,S,H,hd], k and v [B,T,KV,hd], contiguous, fp32 or bf16;
// q head h reads kv head h / (H/KV), so grouped heads are never
// materialised.  Query row i sits at absolute position q_offset + i and
// key j at j: row i sees key j when j < T, (causal) j <= q_offset + i and
// (window > 0) j > q_offset + i - window.  Scores are fp32 dot products
// times 1/sqrt(hd), masked to -1e30 as the TPU kernel does; out [B,S,H,hd]
// in q's dtype.  Where the caller passes `lse` ([B,H,S] fp32, for the
// backward in flash_attention_bwd.cu), each row's log-sum-exp of its
// scaled, masked scores is stored there too, by one thread after the
// row's output: nothing in the output's arithmetic changes with it.
//
// Bound on the H100: operations at the model's shapes.  A causal
// 2048-token prefill does about 34 GFLOP per layer (QK and PV over the
// unmasked pairs, 32 heads, hd 128) against about 12 MB of Q, K, V and O,
// some 2,800 flops per byte: far above the ~295 where the tensor cores
// bind.  So the bf16 path runs on the tensor cores:
//  * each warp owns one 16-row MMA tile of one query head and computes
//    S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in, fp32
//    accumulators), Q held in registers, K and V fragments read from
//    shared memory with ldmatrix (rows padded by 16 bytes: no bank
//    conflicts);
//  * the block's warps are up to 4 query heads of one GQA group (times
//    16-row tiles when the group is smaller), so one K/V tile in shared
//    memory feeds the whole group;
//  * K and V blocks arrive by cp.async (16-byte copies, rows past T
//    zero-filled) into a two-stage ring: the next key block is in flight
//    while the current one is scored, two barriers per block;
//  * P enters the P V product as two bf16 terms, hi = bf16(p) and
//    lo = bf16(p - hi).  One rounding of P costs up to ~1e-3 absolute on
//    rows that see few keys, far over the two-ulp gate near zero; two
//    terms leave ~2^-18 relative, under the output's own rounding.  The
//    P V product is thus issued twice (1.5x the tensor-core work of one
//    pass).
//  * the row tiles with the most keys are scheduled first (causal).
// The fp32 path keeps the CUDA-core body (fmaf chains, 64x64 tiles):
// TF32 keeps ~3 decimal digits and would break its 1e-4 gate.
//
// Design, both paths: every query row's result is a function of that row
// and of the keys alone, bit for bit, whatever S, q_offset, T or the call
// around it (chunked prefill must equal one-shot prefill, DESIGN.md §9):
//  * key blocks are a fixed 64 keys, aligned to absolute key 0 in every
//    call, and the ragged tail past T is masked (the TPU kernel's
//    bk = min(block_k, T) would make the reduction depend on T);
//  * bf16: a row's place in its MMA tile is fixed by its absolute
//    position (tiles cover positions [16a, 16a + 16), rows outside the
//    call are zeros and never stored), so no sum leans on the tile the
//    row lands in; its max and sum over a block are the thread's 16
//    values in order, then the quad's two xor shuffles;
//  * fp32: each score is one fmaf chain over d = 0..hd-1; each row's max
//    and sum over a block are a fixed butterfly over the same 16 lanes,
//    whichever of the 16 row groups the row sits in; each output element
//    is one fmaf chain over the block's keys in order;
//  * a tile skips only blocks that are fully masked for all its rows.  A
//    block that is fully masked for one row but visited for another adds
//    exact zeros to that row once its running max is finite (p = 0, both
//    bf16 terms 0, correction 1), and before that its sums are wiped by
//    the correction exp(-1e30 - m) = 0 at the row's first visible block,
//    exactly as a skipped block would leave them.  Masked keys must be
//    finite (chunk buffers hold zeros or earlier K/V rows there).
// fp32 shared memory holds the Q tile, one K or V block (V overwrites K
// once the scores are taken) and the block's probabilities, with a
// one-float row pad so the 16 lanes of a row group read 16 banks.
//
// Head dims 16, 32, 64, 80 (the audio encoder's) and 128.  80 is the one
// that is not a power of two; nothing here needs one: the bf16 body takes
// HD/16 = 5 k-steps of Q K^T, HD/8 = 10 output n-tiles in ldmatrix pairs
// and HD/8 = 10 16-byte cp.async chunks a row, and its 176-byte padded
// rows put an ldmatrix phase's 8 rows on 8 distinct 4-bank groups
// (44-word stride: offsets 0, 12, 24, 4, 16, 28, 8, 20 mod 32); the fp32
// body gives each lane HD/16 = 5 output columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per block
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// one block of `rows` rows of width HD, row stride `stride` elements, into
// shared memory [rows][HD + 1]; rows at or past `valid` read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int valid) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] = r < valid ? to_f(src[r * stride + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int T_len, int H, int KV,
             int q_offset, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  constexpr int DC = HD / 16;     // output columns per lane
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][LD]
  float* sKV = sQ + BQ * LD;      // [BK][LD]
  float* sP = sKV + BK * LD;      // [BQ][LP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, S - q0);
  const long long qs = (long long)H * HD, ks = (long long)KV * HD;
  const T* qb = q + ((long long)b * S + q0) * qs + (long long)h * HD;
  const T* kb = k + (long long)b * T_len * ks + (long long)kvh * HD;
  const T* vb = v + (long long)b * T_len * ks + (long long)kvh * HD;
  load_tile<T, HD>(sQ, qb, qs, rows);

  // the key blocks any row of this tile can see
  const int first = q_offset + q0, last = q_offset + q0 + rows - 1;
  const int kb_lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  const int k_end = causal ? min(T_len, last + 1) : T_len;
  const int kb_hi = (k_end + BK - 1) / BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();              // the last block's V reads are done
    load_tile<T, HD>(sKV, kb + (long long)k0 * ks, ks, T_len - k0);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sKV[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q_offset + q0 + ty + 16 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        const bool ok = key < T_len && (!causal || key <= qpos) &&
                        (window <= 0 || key > qpos - window);
        s[r][c] = ok ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps += p;
        sP[(ty + 16 * r) * LP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + ps;
      m[r] = m_new;
    }
    __syncthreads();              // scores taken: V may overwrite K
    load_tile<T, HD>(sKV, vb + (long long)k0 * ks, ks, T_len - k0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr[r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty + 16 * r) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sKV[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= rows) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* o = out + ((long long)b * S + q0 + row) * qs + (long long)h * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[r][c] * inv);
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * S + q0 + row] = m[r] + logf(l[r]);
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int T_len, int H, int KV, int q_offset, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, T_len, H, KV,
      q_offset, causal, window, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int T_len, int H, int KV, int hd,
             int q_offset, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                          causal, window, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                          causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                          causal, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                          causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                          causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int NS = 2;                   // K/V ring stages
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared; `bytes` = 0 writes zeros, reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
// d += a b: a 16x16 row-major, b 16x8 column-major, bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (p0, p1) as two bf16 terms: hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack(p0 - __low2float(h), p1 - __high2float(h));
}
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// elements of a padded shared row (16 bytes of pad: ldmatrix rows hit
// distinct banks)
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }
template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return NS * 2 * BK * ld<HD>() * (int)sizeof(bf16);
}

// key block at k0: K and V rows into one ring stage, rows past T zeros
template <int HD>
__device__ __forceinline__ void load_kv(bf16* sK, bf16* sV, const bf16* kb,
                                        const bf16* vb, long long ks, int k0,
                                        int T_len) {
  constexpr int CH = HD / 8, LD = ld<HD>();
  for (int e = threadIdx.x; e < BK * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool ok = k0 + r < T_len;
    const long long off = (ok ? (long long)(k0 + r) * ks : 0) + c * 8;
    cp_async16(smem_u32(sK + r * LD + c * 8), kb + off, ok ? 16 : 0);
    cp_async16(smem_u32(sV + r * LD + c * 8), vb + off, ok ? 16 : 0);
  }
}

__device__ __forceinline__ bool sees(int key, int pos, int T_len, int causal,
                                     int window) {
  return key < T_len && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window);
}

// grid (row tiles, B * KV * G/HB); block HB*MT warps: warp w serves query
// head kvh*G + hc*HB + w/MT over absolute rows tile*16*MT + (w%MT)*16 + [0,16)
template <int HD>
__global__ void __launch_bounds__(128)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int S, int T_len, int H, int KV,
                int HB, int MT, int q_offset, int causal, int window,
                float scale_log2) {
  constexpr int LD = ld<HD>();
  constexpr int KT = HD / 16;           // k-steps of QK^T
  constexpr int NT = BK / 8;            // score n-tiles
  constexpr int OT = HD / 8;            // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int BM = 16 * MT;
  const int G = H / KV, n_hc = G / HB;
  const int t_first = q_offset / BM;
  const int n_tiles = (q_offset + S - 1) / BM - t_first + 1;
  const int tile = t_first + (n_tiles - 1 - (int)blockIdx.x);
  const int hc = blockIdx.y % n_hc, bkv = blockIdx.y / n_hc;
  const int kvh = bkv % KV, b = bkv / KV;
  const int h = kvh * G + hc * HB + warp / MT;
  const int row0 = tile * BM + (warp % MT) * 16;

  // the key blocks any present row of this block can see
  const int first = max(tile * BM, q_offset);
  const int last = min(tile * BM + BM, q_offset + S) - 1;
  const int kb_lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  const int k_end = causal ? min(T_len, last + 1) : T_len;
  const int kb_hi = (k_end + BK - 1) / BK;

  const long long qs = (long long)H * HD, ks = (long long)KV * HD;
  const bf16* kbase = k + (long long)b * T_len * ks + (long long)kvh * HD;
  const bf16* vbase = v + (long long)b * T_len * ks + (long long)kvh * HD;
  bf16* const sKV = smem;               // stage s: K at 2s, V at 2s+1

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (kb_lo + s < kb_hi)
      load_kv<HD>(sKV + 2 * s * BK * LD, sKV + (2 * s + 1) * BK * LD, kbase,
                  vbase, ks, (kb_lo + s) * BK, T_len);
    cp_commit();
  }

  // this thread's rows: g and g + 8 of the warp's tile
  const int pa = row0 + g, pb = row0 + g + 8;
  const int ia = pa - q_offset, ib = pb - q_offset;
  const bool oka = ia >= 0 && ia < S, okb = ib >= 0 && ib < S;
  const bf16* qa = q + ((long long)b * S + (oka ? ia : 0)) * qs +
                   (long long)h * HD;
  const bf16* qb = q + ((long long)b * S + (okb ? ib : 0)) * qs +
                   (long long)h * HD;
  uint32_t qf[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + 2 * tig;
    qf[kt][0] = oka ? ld_pair(qa + c) : 0u;
    qf[kt][1] = okb ? ld_pair(qb + c) : 0u;
    qf[kt][2] = oka ? ld_pair(qa + c + 8) : 0u;
    qf[kt][3] = okb ? ld_pair(qb + c + 8) : 0u;
  }

  float ma = NEG_INF, mb = NEG_INF, la = 0.f, lb = 0.f;
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  // ldmatrix lane addresses: matrix mi = lane / 8, its row lane % 8
  const int mi = lane >> 3, mr = lane & 7;

  for (int blk = kb_lo, it = 0; blk < kb_hi; ++blk, ++it) {
    const int st = it % NS;
    const bf16* sK = sKV + 2 * st * BK * LD;
    const bf16* sV = sK + BK * LD;
    cp_wait<NS - 1>();
    __syncthreads();                    // block blk landed for every thread

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b0, b1, b2, b3;        // key n-tiles j, j+1 at k-step kt
        ldsm_x4(smem_u32(sK + ((j + (mi >> 1)) * 8 + mr) * LD + kt * 16 +
                         8 * (mi & 1)),
                b0, b1, b2, b3);
        mma(s[j], qf[kt], b0, b1);
        mma(s[j + 1], qf[kt], b2, b3);
      }

    const int k0 = blk * BK;
    float xa = NEG_INF, xb = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + j * 8 + 2 * tig + c;
        s[j][c] = sees(key, pa, T_len, causal, window) ? s[j][c] * scale_log2
                                                       : NEG_INF;
        s[j][2 + c] = sees(key, pb, T_len, causal, window)
                          ? s[j][2 + c] * scale_log2
                          : NEG_INF;
        xa = fmaxf(xa, s[j][c]);
        xb = fmaxf(xb, s[j][2 + c]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
      xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
    }
    const float na = fmaxf(ma, xa), nb = fmaxf(mb, xb);
    const float ca = exp2f(ma - na), cb = exp2f(mb - nb);
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[j][c] = exp2f(s[j][c] - na);
        s[j][2 + c] = exp2f(s[j][2 + c] - nb);
        sa += s[j][c];
        sb += s[j][2 + c];
      }
    la = la * ca + sa;                  // this thread's columns only
    lb = lb * cb + sb;
    ma = na;
    mb = nb;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= ca;
      o[n][1] *= ca;
      o[n][2] *= cb;
      o[n][3] *= cb;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];            // A fragments of keys 16kk..16kk+15
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t b0, b1, b2, b3;        // dim n-tiles n, n+1 at these keys
        ldsm_x4_t(smem_u32(sV + (kk * 16 + mr + 8 * (mi & 1)) * LD +
                           (n + (mi >> 1)) * 8),
                  b0, b1, b2, b3);
        mma(o[n], ph, b0, b1);
        mma(o[n], pl, b0, b1);
        mma(o[n + 1], ph, b2, b3);
        mma(o[n + 1], pl, b2, b3);
      }
    }

    __syncthreads();                    // every warp is done with stage st
    if (blk + NS < kb_hi)
      load_kv<HD>(sKV + 2 * st * BK * LD, sKV + (2 * st + 1) * BK * LD,
                  kbase, vbase, ks, (blk + NS) * BK, T_len);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  const float inva = 1.f / fmaxf(la, 1e-30f), invb = 1.f / fmaxf(lb, 1e-30f);
  bf16* oa = out + ((long long)b * S + (oka ? ia : 0)) * qs + (long long)h * HD;
  bf16* ob = out + ((long long)b * S + (okb ? ib : 0)) * qs + (long long)h * HD;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * tig;
    if (oka)
      *reinterpret_cast<uint32_t*>(oa + c) =
          pack(o[n][0] * inva, o[n][1] * inva);
    if (okb)
      *reinterpret_cast<uint32_t*>(ob + c) =
          pack(o[n][2] * invb, o[n][3] * invb);
  }
  // the scores are in log2 units (scale_log2 carries log2(e))
  if (lse != nullptr && tig == 0) {
    float* lrow = lse + ((long long)b * H + h) * S;
    if (oka) lrow[ia] = (ma + log2f(la)) * LN2;
    if (okb) lrow[ib] = (mb + log2f(lb)) * LN2;
  }
}

// heads of one GQA group per block: the largest divisor of G up to 4,
// and as many 16-row tiles per head as bring the block to 4 warps
inline int heads_per_block(int G) {
  for (int hb = 4; hb > 1; --hb)
    if (G % hb == 0) return hb;
  return 1;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int S, int T_len, int H, int KV, int q_offset, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_tc_kernel<HD>;
  static bool opted_in = false;         // once: the call is not free
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int G = H / KV, HB = heads_per_block(G), MT = 4 / HB;
  const int BM = 16 * MT;
  const int n_tiles = (q_offset + S - 1) / BM - q_offset / BM + 1;
  dim3 grid(n_tiles, B * KV * (G / HB));
  kern<<<grid, 32 * HB * MT, smem_bytes<HD>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, S, T_len, H,
      KV, HB, MT, q_offset, causal, window, LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int T_len, int H, int KV, int hd,
             int q_offset, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                       causal, window, stream);
    case 32:
      return launch<32>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                       causal, window, stream);
    case 64:
      return launch<64>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                       causal, window, stream);
    case 80:
      return launch<80>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                       causal, window, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, B, S, T_len, H, KV, q_offset,
                       causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// dtype: 0 fp32, 1 bf16.  Returns a cudaError_t code (0: launched).
// lse: [B,H,S] fp32, or null for none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int S, int T_len,
                               int H, int KV, int hd, int q_offset, int causal,
                               int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, B, S, T_len, H, KV, hd,
                           q_offset, causal, window, s);
  if (dtype == 1)
    return tc::dispatch(q, k, v, out, lse, B, S, T_len, H, KV, hd, q_offset,
                        causal, window, s);
  return (int)cudaErrorInvalidValue;
}
