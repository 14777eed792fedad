// flash_attention_bwd: the gradient of flash_attention.cu's GQA attention
// (causal, sliding-window or full), recomputing the probabilities from
// each row's log-sum-exp instead of storing them.
//
// The TPU kernel repro/kernels/flash_attention/flash_attention.py:70
// (`flash_attention`) has no backward: the reference trains through plain
// XLA attention, which XLA differentiates.  The port runs the forward
// kernel in every attention layer on a card, so training there needs
// this one; its plain version is `attention_bwd_ref` in ref.py.
//
// Inputs, all contiguous, in the forward's layouts: q [B,S,H,hd], k and v
// [B,T,KV,hd], the forward's out o [B,S,H,hd] and the upstream gradient
// do [B,S,H,hd], fp32 or bf16 (all one type), and the forward's lse
// [B,H,S] fp32.  The mask and scale are the forward's: query row i sits at
// absolute position q_offset + i, key j at j; row i sees key j when j < T,
// (causal) j <= q_offset + i and (window > 0) j > q_offset + i - window;
// scale 1/sqrt(hd).  Outputs dq [B,S,H,hd], dk and dv [B,T,KV,hd] in the
// inputs' type.  With s = scale q.k:
//   P = exp(s - lse) on seen pairs, exactly 0 elsewhere;
//   D_i = sum_d do_i o_i (fp32, a pre-pass);
//   dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q.
// A row that sees no key at all gets zero gradients (the forward gave it
// the mean of V; no training path makes such rows).
//
// Three launches:
//  1. rowdot_kernel: D, one warp per (b, i, h) row.  Kept as a pre-pass:
//     folded into the two kernels below, every dkdv block would read O
//     and dO rows again for each query tile it walks (O is read nowhere
//     else), more bytes than one pass over O and dO;
//  2. dkdv: grid (B*KV, key blocks).  A block owns 64 keys of one KV head
//     and walks every query head of its GQA group and every 64-row query
//     tile that can see those keys, in a fixed order, so dk and dv sum the
//     G heads and the tiles inside the block, in registers: no atomics,
//     and the result is the same bits on every run (a resumed training
//     run equals an uninterrupted one);
//  3. dq: grid (B*H, query tiles), over the key blocks its rows can see,
//     as the forward walks them.
// Bound on the H100: operations.  The backward does 2.5x the forward's
// multiply-adds (QK^T again, dO V^T, P^T dO, dS K, dS^T Q against QK^T and
// PV); dkdv and dq each recompute QK^T and dO V^T, 3.5x in all.
//
// bf16 runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 sums),
// the forward's helpers (cp.async, ldmatrix, accumulators repacked as A
// fragments, rows padded by 16 bytes):
//  * dkdv: 4 warps, 16 keys a warp as the MMA rows.  A warp loads its K
//    rows as A fragments into registers once and keeps them, with its dK
//    and dV accumulators (16 keys x hd each), for the whole walk; the
//    block's V rows stay in shared memory, read by ldmatrix as A
//    fragments (V in registers too would take more than 255 registers a
//    thread at hd 128: ptxas spilled).  Each (head, query tile) arrives
//    by cp.async into a two-stage ring, Q and dO rows as bf16 with the
//    tile's lse and D beside them: the next tile loads while this one is
//    multiplied.  Per 16-query chunk the warp forms S^T = K Q^T and dP^T =
//    V dO^T (B from the shared Q and dO by ldmatrix), P^T = exp(scale S^T
//    - lse), exactly 0 on masked pairs, and dS^T = P^T (dP^T - D), then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T repacked from the
//    accumulators into A fragments and dO, Q read by ldmatrix.trans: no P
//    or dS goes through shared memory.  A chunk that is fully masked for
//    the warp's keys is skipped (its products would add exact zeros);
//  * dq: 4 warps, 16 query rows of one head a warp, their Q and dO held
//    as A fragments in registers; K and V blocks of 64 keys arrive by
//    cp.async into a two-stage ring; per 16-key chunk S = Q K^T, dP =
//    dO V^T, then dQ += dS K with dS repacked as A fragments and K read
//    by ldmatrix.trans;
//  * the heaviest tiles launch first: blockIdx.y is the slow grid axis,
//    so every head's key block 0 (dkdv: the most query rows under a
//    causal mask) and last query tile (dq: the most keys) are issued
//    before any lighter one;
//  * precision: P and dS enter their products as two bf16 terms, hi =
//    bf16(x) and lo = bf16(x - hi), the forward's split.  One rounding of
//    either breaks the 5e-3 gate on some inputs (a CPU emulation of this
//    design, tests/test_torch_kernels.py: dS rounded once reaches 6.0e-3
//    of dq's max at one of its seeds, P rounded once 5.2e-3 of dv's at
//    another; a bf16 output's own rounding takes up to 3.9e-3).  The
//    split issues dV += P^T dO, dK += dS^T Q and dQ += dS K twice: 10
//    product passes where single terms need 7 (1.43x the tensor-core
//    work);
//  * registers and shared memory, hd 128 (ptxas -v, which `_build.py`
//    keeps): dkdv 254 registers, dq 206, no spills at any head dim;
//    dkdv's ring (2 stages x Q, dO of 64 rows x (hd + 8) bf16, 68 KB),
//    1 KB of lse and D and 17 KB of V, dq's ring of K and V (68 KB): two
//    blocks an SM.  Chunks of 32 queries or keys (more independent
//    MMAs) measured no faster.
// Head dims 16, 32, 64, 80 and 128, all on the tensor-core path (80: 5
// k-steps, 10 output n-tiles in ldmatrix pairs, 176-byte padded rows
// whose 8 ldmatrix rows fall on 8 distinct 4-bank groups).
// fp32 keeps the CUDA-core body (TF32 keeps ~3 decimal digits and would
// break the fp32 gate of 1e-4): 256 threads as 16 row groups x 16 lanes,
// each thread a 4 x 4 tile of scores and 4 x hd/16 accumulators, tiles in
// shared memory as fp32 rows padded by one float; its grid is the old
// one (key or query blocks fastest).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per block
constexpr int THREADS = 256;    // fp32: 16 row groups x 16 lanes
constexpr int ROW_WARPS = 8;    // rows per rowdot block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool sees(int key, int pos, int T_len, int causal,
                                     int window) {
  return key < T_len && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window);
}

// D[b,h,i] = sum_d do[b,i,h,d] o[b,i,h,d]; row = (b*S + i)*H + h
template <typename T>
__global__ void rowdot_kernel(const T* __restrict__ o,
                              const T* __restrict__ dout,
                              float* __restrict__ D, long long n_rows, int S,
                              int H, int hd) {
  const long long row =
      (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_f(op[d]), to_f(dp[d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;
    const int i = (int)(bi % S);
    const long long b = bi / S;
    D[(b * H + h) * S + i] = s;
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

// `rows` rows of width HD, row stride `stride` elements, into shared memory
// [64][HD + 1]; rows at or past `valid` read as zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int valid) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] = r < valid ? src[r * stride + d] : 0.f;
  }
}

// S = Q K^T (4 x 4 per thread: rows ty + 16r, keys tx + 16c, in shared
// tiles sQ, sK) and dP = dO V^T likewise, then
// P = exp(scale S - lse) where the row sees the key (else 0) and
// dS = P (dP - D).  P goes to sP [64][BK + 1]; dS stays in `ds`.
template <int HD>
__device__ __forceinline__ void scores(const float* sQ, const float* sdO,
                                       const float* sK, const float* sV,
                                       const float* sL, const float* sD,
                                       float* sP, float (&ds)[4][4], int i0,
                                       int rows, int k0, int T_len,
                                       int q_offset, int causal, int window,
                                       float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qv[r] = sQ[(ty + 16 * r) * LD + d];
      ov[r] = sdO[(ty + 16 * r) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = sK[(tx + 16 * c) * LD + d];
      vv[c] = sV[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    const int pos = q_offset + i0 + row;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + tx + 16 * c;
      const bool ok = row < rows && sees(key, pos, T_len, causal, window);
      const float p = ok ? expf(s[r][c] * scale - sL[row]) : 0.f;
      sP[row * LP + tx + 16 * c] = p;
      ds[r][c] = p * (dp[r][c] - sD[row]);
    }
  }
}

// the row tile's lse and D into shared memory (zeros past the call's rows)
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* lse, const float* D,
                                          long long base, int rows) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sL[r] = r < rows ? lse[base + r] : 0.f;
    sD[r] = r < rows ? D[base + r] : 0.f;
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) *
         (4 * 64 * (HD + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            float* __restrict__ dk, float* __restrict__ dv, int S, int T_len,
            int H, int KV, int q_offset, int causal, int window,
            float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  constexpr int DC = HD / 16;     // output columns per lane
  extern __shared__ float smem[];
  float* sK = smem;               // [BK][LD]
  float* sV = sK + BK * LD;       // [BK][LD]
  float* sQ = sV + BK * LD;       // [BQ][LD]
  float* sdO = sQ + BQ * LD;      // [BQ][LD]
  float* sP = sdO + BQ * LD;      // [BQ][LP]: P, then dS
  float* sL = sP + BQ * LP;       // [BQ]
  float* sD = sL + BQ;            // [BQ]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const long long qs = (long long)H * HD, ks = (long long)KV * HD;
  const long long kv_off = ((long long)b * T_len + k0) * ks +
                           (long long)kvh * HD;
  load_tile<HD>(sK, k + kv_off, ks, T_len - k0);
  load_tile<HD>(sV, v + kv_off, ks, T_len - k0);

  // the query rows that can see a key of this block: causal, pos >= k0;
  // window, pos < last key + window
  const int k_last = min(k0 + BK, T_len) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(S, k_last + window - q_offset) : S;

  float gk[4][DC], gv[4][DC];     // keys ty + 16r, dims tx + 16c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[r][c] = gv[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int i0 = (i_lo / BQ) * BQ; i0 < i_hi; i0 += BQ) {
      const int rows = min(BQ, S - i0);
      const long long q_off = ((long long)b * S + i0) * qs + (long long)h * HD;
      __syncthreads();            // the last tile's reads are done
      load_tile<HD>(sQ, q + q_off, qs, rows);
      load_tile<HD>(sdO, dout + q_off, qs, rows);
      load_rows(sL, sD, lse, D, ((long long)b * H + h) * S + i0, rows);
      __syncthreads();
      float ds[4][4];
      scores<HD>(sQ, sdO, sK, sV, sL, sD, sP, ds, i0, rows, k0, T_len,
                 q_offset, causal, window, scale);
      __syncthreads();            // P complete
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float p[4], o[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = sP[i * LP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) o[c] = sdO[i * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) gv[r][c] = fmaf(p[r], o[c], gv[r][c]);
      }
      __syncthreads();            // P read: dS may overwrite it
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sP[(ty + 16 * r) * LP + tx + 16 * c] = ds[r][c];
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float p[4], qv[DC];
#pragma unroll
        for (int r = 0; r < 4; ++r) p[r] = sP[i * LP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < DC; ++c) qv[c] = sQ[i * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) gk[r][c] = fmaf(p[r], qv[c], gk[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = ty + 16 * r;
    if (k0 + j >= T_len) continue;
    const long long off = ((long long)b * T_len + k0 + j) * ks +
                          (long long)kvh * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = gk[r][c] * scale;
      dv[off + tx + 16 * c] = gv[r][c];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          float* __restrict__ dq, int S, int T_len, int H, int KV,
          int q_offset, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int LP = BK + 1;
  constexpr int DC = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;      // dS
  float* sL = sP + BQ * LP;
  float* sD = sL + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, S - i0);
  const long long qs = (long long)H * HD, ks = (long long)KV * HD;
  const long long q_off = ((long long)b * S + i0) * qs + (long long)h * HD;
  load_tile<HD>(sQ, q + q_off, qs, rows);
  load_tile<HD>(sdO, dout + q_off, qs, rows);
  load_rows(sL, sD, lse, D, ((long long)b * H + h) * S + i0, rows);

  // the key blocks any row of this tile can see (the forward's walk)
  const int first = q_offset + i0, last = q_offset + i0 + rows - 1;
  const int kb_lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  const int k_end = causal ? min(T_len, last + 1) : T_len;
  const int kb_hi = (k_end + BK - 1) / BK;
  const float* kb = k + (long long)b * T_len * ks + (long long)kvh * HD;
  const float* vb = v + (long long)b * T_len * ks + (long long)kvh * HD;

  float acc[4][DC];               // rows ty + 16r, dims tx + 16c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();              // the last block's reads are done
    load_tile<HD>(sK, kb + (long long)k0 * ks, ks, T_len - k0);
    load_tile<HD>(sV, vb + (long long)k0 * ks, ks, T_len - k0);
    __syncthreads();
    float ds[4][4];
    scores<HD>(sQ, sdO, sK, sV, sL, sD, sP, ds, i0, rows, k0, T_len,
               q_offset, causal, window, scale);
    __syncthreads();              // every thread's P written: overwrite
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sP[(ty + 16 * r) * LP + tx + 16 * c] = ds[r][c];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], kv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty + 16 * r) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    if (row >= rows) continue;
    float* o = dq + q_off + (long long)row * qs;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[r][c] * scale;
  }
}

template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* D, void* dq,
                void* dk, void* dv, int B, int S, int T_len, int H, int KV,
                int q_offset, int causal, int window, cudaStream_t stream) {
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  const float scale = 1.f / sqrtf((float)HD);
  const long long n_rows = (long long)B * S * H;
  rowdot_kernel<float><<<(unsigned)((n_rows + ROW_WARPS - 1) / ROW_WARPS),
                         32 * ROW_WARPS, 0, stream>>>(
      static_cast<const float*>(o), do_, D, n_rows, S, H, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (T_len > 0) {
    auto kern = dkdv_kernel<HD>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<HD>());
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T_len + BK - 1) / BK, B * KV);
    kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
        q_, k_, v_, do_, lse, D, static_cast<float*>(dk),
        static_cast<float*>(dv), S, T_len, H, KV, q_offset, causal, window,
        scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto kern = dq_kernel<HD>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<HD>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      q_, k_, v_, do_, lse, D, static_cast<float*>(dq), S, T_len, H, KV,
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

namespace tc {

constexpr int NS = 2;                   // ring stages
constexpr int WARPS = 4;                // 16 keys (dkdv) or rows (dq) each
constexpr float LOG2E = 1.4426950408889634f;
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
// 4 bytes likewise (lse and D rows start at any float)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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
// n-tiles x0, x1 of an accumulator (16 x 16) as A fragments hi, lo
__device__ __forceinline__ void split_frag(const float (&x0)[4],
                                           const float (&x1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split2(x0[0], x0[1], hi[0], lo[0]);
  split2(x0[2], x0[3], hi[1], lo[1]);
  split2(x1[0], x1[1], hi[2], lo[2]);
  split2(x1[2], x1[3], hi[3], lo[3]);
}
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// elements of a padded shared row (16 bytes of pad: ldmatrix rows hit
// distinct banks)
template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }
// dkdv: the ring, NS stages x (Q, dO) [64][ld] bf16, then NS x (lse, D)
// [64] fp32, then the block's V rows [64][ld] bf16; dq: the ring of
// (K, V) [64][ld]
template <int HD>
__host__ __device__ constexpr int dkdv_smem() {
  return (NS * 2 * BQ + BK) * ld<HD>() * (int)sizeof(bf16) +
         NS * 2 * BQ * (int)sizeof(float);
}
template <int HD>
__host__ __device__ constexpr int dq_smem() {
  return NS * 2 * BK * ld<HD>() * (int)sizeof(bf16);
}

// 64 rows from `a` (row stride `stride` elements, `valid` rows present,
// the rest zeros) into the padded tile sa, by cp.async
template <int HD>
__device__ __forceinline__ void copy_tile(bf16* sa, const bf16* a,
                                          long long stride, int valid) {
  constexpr int CH = HD / 8, LD = ld<HD>();
  for (int e = threadIdx.x; e < 64 * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < valid;
    cp_async16(smem_u32(sa + r * LD + c * 8),
               a + (ok ? (long long)r * stride : 0) + c * 8, ok ? 16 : 0);
  }
}

// s (a 16 x 16 chunk: n-tiles 0, 1) += a x B at k-step kt: B^T is rows
// r0..r0+15 of the shared tile t (rows = the n index), by ldmatrix
template <int HD>
__device__ __forceinline__ void scores_step(float (&s)[2][4],
                                            const uint32_t (&a)[4],
                                            const bf16* t, int r0, int kt,
                                            int lane) {
  constexpr int LD = ld<HD>();
  const int mi = lane >> 3, mr = lane & 7;
  uint32_t b0, b1, b2, b3;
  ldsm_x4(smem_u32(t + (r0 + (mi >> 1) * 8 + mr) * LD + kt * 16 +
                   8 * (mi & 1)),
          b0, b1, b2, b3);
  mma(s[0], a, b0, b1);
  mma(s[1], a, b2, b3);
}

// a chunk's scores over the head dim, A (16 rows) held as fragments af
template <int HD>
__device__ __forceinline__ void chunk_scores_r(
    float (&s)[2][4], const uint32_t (&af)[HD / 16][4], const bf16* t,
    int r0, int lane) {
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt)
    scores_step<HD>(s, af[kt], t, r0, kt, lane);
}

// the same, A read by ldmatrix from rows a0..a0+15 of the shared tile at
template <int HD>
__device__ __forceinline__ void chunk_scores_s(float (&s)[2][4],
                                               const bf16* at, int a0,
                                               const bf16* t, int r0,
                                               int lane) {
  constexpr int LD = ld<HD>();
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) {
    uint32_t a[4];
    ldsm_x4(smem_u32(at + (a0 + 8 * (mi & 1) + mr) * LD + kt * 16 +
                     8 * (mi >> 1)),
            a[0], a[1], a[2], a[3]);
    scores_step<HD>(s, a, t, r0, kt, lane);
  }
}

// acc (16 x HD) += (hi + lo) x rows r0..r0+15 of the shared tile `t`
// (k = those rows, n = the head dim), B by ldmatrix.trans
template <int HD>
__device__ __forceinline__ void chunk_product(float (&acc)[HD / 8][4],
                                              const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              const bf16* t, int r0,
                                              int lane) {
  constexpr int LD = ld<HD>();
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int n = 0; n < HD / 8; n += 2) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(smem_u32(t + (r0 + mr + 8 * (mi & 1)) * LD +
                       (n + (mi >> 1)) * 8),
              b0, b1, b2, b3);
    mma(acc[n], hi, b0, b1);
    mma(acc[n], lo, b0, b1);
    mma(acc[n + 1], hi, b2, b3);
    mma(acc[n + 1], lo, b2, b3);
  }
}

// rows (or keys) r and r + 8 of 16 as A fragments over the head dim,
// zeros where absent
template <int HD>
__device__ __forceinline__ void load_frags(uint32_t (&f)[HD / 16][4],
                                           const bf16* ra, bool oka,
                                           const bf16* rb, bool okb,
                                           int tig) {
#pragma unroll
  for (int kt = 0; kt < HD / 16; ++kt) {
    const int c = kt * 16 + 2 * tig;
    f[kt][0] = oka ? ld_pair(ra + c) : 0u;
    f[kt][1] = okb ? ld_pair(rb + c) : 0u;
    f[kt][2] = oka ? ld_pair(ra + c + 8) : 0u;
    f[kt][3] = okb ? ld_pair(rb + c + 8) : 0u;
  }
}

// grid (B*KV, key blocks): warp w owns keys k0 + 16w + [0, 16)
template <int HD>
__global__ void __launch_bounds__(32 * WARPS, 2)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ D,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
               int T_len, int H, int KV, int q_offset, int causal,
               int window, float scale_log2, float scale) {
  constexpr int LD = ld<HD>(), KT = HD / 16, OT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);
  float* const rows = reinterpret_cast<float*>(ring + NS * 2 * BQ * LD);
  bf16* const sV = reinterpret_cast<bf16*>(rows + NS * 2 * BQ);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int k0 = blockIdx.y * BK;
  const int G = H / KV;
  const long long qs = (long long)H * HD, ks = (long long)KV * HD;

  // this warp's keys, and this thread's two of them: ja, jb.  K stays in
  // registers as A fragments; V in shared memory (both in registers would
  // take more than 255 at hd 128), its copy joining the ring's first group
  const int kw = k0 + 16 * warp;
  const int ja = kw + g, jb = kw + g + 8;
  const bool oka = ja < T_len, okb = jb < T_len;
  const long long kv0 = ((long long)b * T_len + k0) * ks + (long long)kvh * HD;
  const long long kva = oka ? kv0 + (long long)(ja - k0) * ks : 0;
  const long long kvb = okb ? kv0 + (long long)(jb - k0) * ks : 0;
  uint32_t kf[KT][4];
  load_frags<HD>(kf, k + kva, oka, k + kvb, okb, tig);
  copy_tile<HD>(sV, v + kv0, ks, T_len - k0);

  // the query rows that can see a key of this block: causal, pos >= k0;
  // window, pos < last key + window; walked as (head, 64-row tile)
  const int k_last = min(k0 + BK, T_len) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(S, k_last + window - q_offset) : S;
  const int t_lo = i_lo / BQ;
  const int n_qt = i_hi > i_lo ? (i_hi - 1) / BQ - t_lo + 1 : 0;
  const int n_it = G * n_qt;

  // tile `it` (head it / n_qt) into ring stage st: Q, dO, lse and D rows
  auto load = [&](int it, int st) {
    const int h = kvh * G + it / n_qt, i0 = (t_lo + it % n_qt) * BQ;
    const long long qo = ((long long)b * S + i0) * qs + (long long)h * HD;
    bf16* sQ = ring + 2 * st * BQ * LD;
    copy_tile<HD>(sQ, q + qo, qs, S - i0);
    copy_tile<HD>(sQ + BQ * LD, dout + qo, qs, S - i0);
    float* sL = rows + 2 * st * BQ;
    const long long ro = ((long long)b * H + h) * S;
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool ok = i0 + r < S;
      const long long at = ro + (ok ? i0 + r : 0);
      cp_async4(smem_u32(sL + r), lse + at, ok ? 4 : 0);
      cp_async4(smem_u32(sL + BQ + r), D + at, ok ? 4 : 0);
    }
  };

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (s < n_it) load(s, s);
    cp_commit();
  }

  for (int it = 0; it < n_it; ++it) {
    const int st = it % NS;
    const int i0 = (t_lo + it % n_qt) * BQ;
    const bf16* sQ = ring + 2 * st * BQ * LD;
    const bf16* sO = sQ + BQ * LD;
    const float* sL = rows + 2 * st * BQ;
    const float* sD = sL + BQ;
    cp_wait<NS - 1>();
    __syncthreads();                    // tile it landed for every thread

#pragma unroll 1
    for (int c0 = 0; c0 < BQ && kw < T_len; c0 += 16) {
      // skip a chunk fully masked for the warp's keys (exact zeros)
      const int p_lo = q_offset + i0 + c0, p_hi = p_lo + 15;
      if (i0 + c0 >= S) break;
      if (causal && p_hi < kw) continue;
      if (window > 0 && kw + 15 <= p_lo - window) continue;

      float s[2][4] = {}, dp[2][4] = {};
      chunk_scores_r<HD>(s, kf, sQ, c0, lane);              // S^T = K Q^T
      chunk_scores_s<HD>(dp, sV, 16 * warp, sO, c0, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = c0 + 8 * j + 2 * tig + c;     // the tile's row
          const int pos = q_offset + i0 + r;
          const bool okq = i0 + r < S;
          const float l2 = sL[r] * LOG2E, dd = sD[r];
          const float pa =
              okq && sees(ja, pos, T_len, causal, window)
                  ? exp2f(fmaf(s[j][c], scale_log2, -l2)) : 0.f;
          const float pb =
              okq && sees(jb, pos, T_len, causal, window)
                  ? exp2f(fmaf(s[j][2 + c], scale_log2, -l2)) : 0.f;
          s[j][c] = pa;
          s[j][2 + c] = pb;
          dp[j][c] = pa * (dp[j][c] - dd);
          dp[j][2 + c] = pb * (dp[j][2 + c] - dd);
        }
      uint32_t hi[4], lo[4];
      split_frag(s[0], s[1], hi, lo);
      chunk_product<HD>(dva, hi, lo, sO, c0, lane);   // dV += P^T dO
      split_frag(dp[0], dp[1], hi, lo);
      chunk_product<HD>(dka, hi, lo, sQ, c0, lane);   // dK += dS^T Q
    }

    __syncthreads();                    // every warp is done with stage st
    if (it + NS < n_it) load(it + NS, st);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * tig;
    if (oka) {
      *reinterpret_cast<uint32_t*>(dk + kva + c) =
          pack(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + kva + c) = pack(dva[n][0], dva[n][1]);
    }
    if (okb) {
      *reinterpret_cast<uint32_t*>(dk + kvb + c) =
          pack(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + kvb + c) = pack(dva[n][2], dva[n][3]);
    }
  }
}

// grid (B*H, query tiles), the last tile first: warp w owns query rows
// i0 + 16w + [0, 16) of head h
template <int HD>
__global__ void __launch_bounds__(32 * WARPS, 2)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ D,
             bf16* __restrict__ dq, int S, int T_len, int H, int KV,
             int q_offset, int causal, int window, float scale_log2,
             float scale) {
  constexpr int LD = ld<HD>(), KT = HD / 16, OT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const ring = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int rows = min(BQ, S - i0);
  const long long qs = (long long)H * HD, ks = (long long)KV * HD;

  // this warp's rows, and this thread's two of them: ia, ib
  const int r0 = i0 + 16 * warp;
  const int ia = r0 + g, ib = r0 + g + 8;
  const bool oka = ia < S, okb = ib < S;
  const int pa = q_offset + ia, pb = q_offset + ib;
  const long long qa = ((long long)b * S + (oka ? ia : 0)) * qs +
                       (long long)h * HD;
  const long long qb = ((long long)b * S + (okb ? ib : 0)) * qs +
                       (long long)h * HD;
  uint32_t qf[KT][4], of[KT][4];
  load_frags<HD>(qf, q + qa, oka, q + qb, okb, tig);
  load_frags<HD>(of, dout + qa, oka, dout + qb, okb, tig);
  const long long ro = ((long long)b * H + h) * S;
  const float la = oka ? lse[ro + ia] * LOG2E : 0.f;
  const float lb = okb ? lse[ro + ib] * LOG2E : 0.f;
  const float da = oka ? D[ro + ia] : 0.f, db = okb ? D[ro + ib] : 0.f;

  // the key blocks any row of this tile can see (the forward's walk), and
  // the positions of the warp's rows
  const int first = q_offset + i0, last = q_offset + i0 + rows - 1;
  const int kb_lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  const int k_end = causal ? min(T_len, last + 1) : T_len;
  const int kb_hi = (k_end + BK - 1) / BK;
  const bool live = r0 < S;
  const int w_lo = q_offset + r0, w_hi = q_offset + min(r0 + 15, S - 1);
  const bf16* kbase = k + (long long)b * T_len * ks + (long long)kvh * HD;
  const bf16* vbase = v + (long long)b * T_len * ks + (long long)kvh * HD;

  // key block blk into ring stage st: K and V rows, zeros past T
  auto load = [&](int blk, int st) {
    const int k0 = blk * BK;
    bf16* sK = ring + 2 * st * BK * LD;
    copy_tile<HD>(sK, kbase + (long long)k0 * ks, ks, T_len - k0);
    copy_tile<HD>(sK + BK * LD, vbase + (long long)k0 * ks, ks, T_len - k0);
  };
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (kb_lo + s < kb_hi) load(kb_lo + s, s);
    cp_commit();
  }

  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int blk = kb_lo, it = 0; blk < kb_hi; ++blk, ++it) {
    const int st = it % NS;
    const bf16* sK = ring + 2 * st * BK * LD;
    const bf16* sV = sK + BK * LD;
    const int k0 = blk * BK;
    cp_wait<NS - 1>();
    __syncthreads();                    // block blk landed for every thread

#pragma unroll 1
    for (int c0 = 0; c0 < BK && live; c0 += 16) {
      // skip a chunk fully masked for the warp's rows (exact zeros)
      const int kc = k0 + c0;
      if (kc >= T_len || (causal && kc > w_hi)) break;
      if (window > 0 && kc + 15 <= w_lo - window) continue;

      float s[2][4] = {}, dp[2][4] = {};
      chunk_scores_r<HD>(s, qf, sK, c0, lane);    // S = Q K^T
      chunk_scores_r<HD>(dp, of, sV, c0, lane);   // dP = dO V^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = kc + 8 * j + 2 * tig + c;
          const float p0 = oka && sees(key, pa, T_len, causal, window)
                               ? exp2f(fmaf(s[j][c], scale_log2, -la)) : 0.f;
          const float p1 = okb && sees(key, pb, T_len, causal, window)
                               ? exp2f(fmaf(s[j][2 + c], scale_log2, -lb))
                               : 0.f;
          dp[j][c] = p0 * (dp[j][c] - da);
          dp[j][2 + c] = p1 * (dp[j][2 + c] - db);
        }
      uint32_t hi[4], lo[4];
      split_frag(dp[0], dp[1], hi, lo);
      chunk_product<HD>(acc, hi, lo, sK, c0, lane);   // dQ += dS K
    }

    __syncthreads();                    // every warp is done with stage st
    if (blk + NS < kb_hi) load(blk + NS, st);
    cp_commit();
  }
  cp_wait<0>();

#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * tig;
    if (oka)
      *reinterpret_cast<uint32_t*>(dq + qa + c) =
          pack(acc[n][0] * scale, acc[n][1] * scale);
    if (okb)
      *reinterpret_cast<uint32_t*>(dq + qb + c) =
          pack(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int S, int T_len, int H, int KV, int q_offset,
           int causal, int window, cudaStream_t stream) {
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const float scale = 1.f / sqrtf((float)HD), scale_log2 = scale * LOG2E;
  const long long n_rows = (long long)B * S * H;
  rowdot_kernel<bf16><<<(unsigned)((n_rows + ROW_WARPS - 1) / ROW_WARPS),
                        32 * ROW_WARPS, 0, stream>>>(
      static_cast<const bf16*>(o), do_, D, n_rows, S, H, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static bool opted_in = false;         // once: the call is not free
  if (!opted_in) {
    e = cudaFuncSetAttribute(dkdv_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(dq_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<HD>());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (T_len > 0) {
    dim3 grid(B * KV, (T_len + BK - 1) / BK);
    dkdv_tc_kernel<HD><<<grid, 32 * WARPS, dkdv_smem<HD>(), stream>>>(
        q_, k_, v_, do_, lse, D, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, T_len, H, KV, q_offset, causal, window,
        scale_log2, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * H, (S + BQ - 1) / BQ);
  dq_tc_kernel<HD><<<grid, 32 * WARPS, dq_smem<HD>(), stream>>>(
      q_, k_, v_, do_, lse, D, static_cast<bf16*>(dq), S, T_len, H, KV,
      q_offset, causal, window, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

#define FA_BWD_CASES(CASE) CASE(16) CASE(32) CASE(64) CASE(80) CASE(128)

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* D, void* dq, void* dk,
             void* dv, int B, int S, int T_len, int H, int KV, int hd,
             int q_offset, int causal, int window, int dtype,
             cudaStream_t stream) {
#define FA_BWD_FP32(HD)                                                      \
  case HD:                                                                   \
    return launch_fp32<HD>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S,       \
                           T_len, H, KV, q_offset, causal, window, stream);
#define FA_BWD_BF16(HD)                                                      \
  case HD:                                                                   \
    return tc::launch<HD>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T_len, \
                          H, KV, q_offset, causal, window, stream);
  if (dtype == 0) {
    switch (hd) { FA_BWD_CASES(FA_BWD_FP32) }
  } else if (dtype == 1) {
    switch (hd) { FA_BWD_CASES(FA_BWD_BF16) }
  }
#undef FA_BWD_FP32
#undef FA_BWD_BF16
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  D: [B,H,S] fp32 scratch.  Returns a cudaError_t
// code (0: launched).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* D, void* dq, void* dk, void* dv,
                                   int B, int S, int T_len, int H, int KV,
                                   int hd, int q_offset, int causal,
                                   int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  return dispatch(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T_len, H, KV,
                  hd, q_offset, causal, window, dtype,
                  static_cast<cudaStream_t>(stream));
}
