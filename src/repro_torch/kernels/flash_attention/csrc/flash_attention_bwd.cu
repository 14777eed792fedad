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
//  1. rowdot_kernel: D, one warp per (b, i, h) row;
//  2. dkdv_kernel: grid (key blocks, B*KV).  A block owns 64 keys of one
//     KV head and walks every query head of its GQA group and every
//     64-row query block that can see those keys, in a fixed order, so
//     dk and dv sum the G heads inside the block: no atomics, and the
//     result is the same bits on every run (a resumed training run can
//     equal an uninterrupted one);
//  3. dq_kernel: grid (query blocks, B*H), over the key blocks its rows
//     can see, as the forward walks them.
// Bound on the H100: operations.  The backward does 2.5x the forward's
// multiply-adds (QK^T again, dO V^T, P^T dO, dS K, dS^T Q against QK^T and
// PV); here dkdv and dq each recompute QK^T and dO V^T, 3.5x in all.  This
// first kernel keeps everything in fp32 on the CUDA cores, the forward's
// fp32 body's layout: 256 threads as 16 row groups x 16 lanes, each thread
// a 4 x 4 tile of scores and 4 x hd/16 accumulators, tiles in shared
// memory as fp32 rows padded by one float (the 16 lanes of a row group read
// 16 banks).  Tensor cores (mma.sync or wgmma) are later work; fp32 runs
// at 1/15 of the bf16 tensor rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per block
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr int ROW_WARPS = 8;    // rows per rowdot block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool sees(int key, int pos, int T_len, int causal,
                                     int window) {
  return key < T_len && (!causal || key <= pos) &&
         (window <= 0 || key > pos - window);
}

// `rows` rows of width HD, row stride `stride` elements, into shared memory
// [64][HD + 1] as fp32; rows at or past `valid` read as zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int valid) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    dst[r * LD + d] = r < valid ? to_f(src[r * stride + d]) : 0.f;
  }
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ D,
            T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H,
            int KV, int q_offset, int causal, int window, float scale) {
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
  load_tile<T, HD>(sK, k + kv_off, ks, T_len - k0);
  load_tile<T, HD>(sV, v + kv_off, ks, T_len - k0);

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
      load_tile<T, HD>(sQ, q + q_off, qs, rows);
      load_tile<T, HD>(sdO, dout + q_off, qs, rows);
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
      store(dk + off + tx + 16 * c, gk[r][c] * scale);
      store(dv + off + tx + 16 * c, gv[r][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ D,
          T* __restrict__ dq, int S, int T_len, int H, int KV, int q_offset,
          int causal, int window, float scale) {
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
  load_tile<T, HD>(sQ, q + q_off, qs, rows);
  load_tile<T, HD>(sdO, dout + q_off, qs, rows);
  load_rows(sL, sD, lse, D, ((long long)b * H + h) * S + i0, rows);

  // the key blocks any row of this tile can see (the forward's walk)
  const int first = q_offset + i0, last = q_offset + i0 + rows - 1;
  const int kb_lo = window > 0 ? max(0, first - window + 1) / BK : 0;
  const int k_end = causal ? min(T_len, last + 1) : T_len;
  const int kb_hi = (k_end + BK - 1) / BK;
  const T* kb = k + (long long)b * T_len * ks + (long long)kvh * HD;
  const T* vb = v + (long long)b * T_len * ks + (long long)kvh * HD;

  float acc[4][DC];               // rows ty + 16r, dims tx + 16c
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  for (int blk = kb_lo; blk < kb_hi; ++blk) {
    const int k0 = blk * BK;
    __syncthreads();              // the last block's reads are done
    load_tile<T, HD>(sK, kb + (long long)k0 * ks, ks, T_len - k0);
    load_tile<T, HD>(sV, vb + (long long)k0 * ks, ks, T_len - k0);
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
    T* o = dq + q_off + (long long)row * qs;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(o + tx + 16 * c, acc[r][c] * scale);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int S, int T_len, int H, int KV, int q_offset,
           int causal, int window, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float scale = 1.f / sqrtf((float)HD);
  const long long n_rows = (long long)B * S * H;
  rowdot_kernel<T><<<(unsigned)((n_rows + ROW_WARPS - 1) / ROW_WARPS),
                     32 * ROW_WARPS, 0, stream>>>(
      static_cast<const T*>(o), do_, D, n_rows, S, H, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (T_len > 0) {
    auto kern = dkdv_kernel<T, HD>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<HD>());
    if (e != cudaSuccess) return (int)e;
    dim3 grid((T_len + BK - 1) / BK, B * KV);
    kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
        q_, k_, v_, do_, lse, D, static_cast<T*>(dk), static_cast<T*>(dv), S,
        T_len, H, KV, q_offset, causal, window, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  auto kern = dq_kernel<T, HD>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<HD>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      q_, k_, v_, do_, lse, D, static_cast<T*>(dq), S, T_len, H, KV,
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* D, void* dq, void* dk,
             void* dv, int B, int S, int T_len, int H, int KV, int hd,
             int q_offset, int causal, int window, cudaStream_t stream) {
#define FA_BWD_CASE(HD)                                                      \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T_len,  \
                         H, KV, q_offset, causal, window, stream);
  switch (hd) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(80)
    FA_BWD_CASE(128)
  }
#undef FA_BWD_CASE
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T_len,
                           H, KV, hd, q_offset, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S,
                                   T_len, H, KV, hd, q_offset, causal, window,
                                   s);
  return (int)cudaErrorInvalidValue;
}
