// flash_attention: GQA prefill attention (causal, sliding-window or full)
// over the model's layouts, with an online softmax over key blocks.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// :70 (`flash_attention`, body `_kernel` l.28), whose grid (b, h, q block,
// k block) walks the key blocks as a sequential ("arbitrary") axis and
// carries the softmax state in VMEM scratch from one grid step to the
// next.  Here one thread block owns a (b, h, 64-row query tile) and loops
// over the key blocks itself; nothing carries over between blocks.
//
// Inputs: q [B,S,H,hd], k and v [B,T,KV,hd], contiguous, fp32 or bf16;
// q head h reads kv head h / (H/KV), so grouped heads are never
// materialised.  Query row i sits at absolute position q_offset + i and
// key j at j: row i sees key j when j < T, (causal) j <= q_offset + i and
// (window > 0) j > q_offset + i - window.  Scores are fp32 dot products
// times 1/sqrt(hd), masked to -1e30 as the TPU kernel does; out [B,S,H,hd]
// in q's dtype.
//
// Bound on the H100: operations at the model's shapes.  A causal
// 2048-token prefill does about 34 GFLOP per layer (QK and PV over the
// unmasked pairs, 32 heads, hd 128) against about 12 MB of Q, K, V and O,
// some 2,800 flops per byte: far above the ~295 where the tensor cores
// would bind.  This first kernel runs on the CUDA cores in fp32 (67
// TFLOP/s peak), not on the tensor cores (989 TFLOP/s in bf16), so it is
// many times its bound; wgmma and TMA are later work.
//
// Design: every query row's result is a function of that row and of the
// keys alone, bit for bit, whatever S, q_offset, T or the tile the row
// lands in (chunked prefill must equal one-shot prefill, DESIGN.md §9):
//  * key blocks are a fixed 64 keys, aligned to absolute key 0 in every
//    call, and the ragged tail past T is masked (the TPU kernel's
//    bk = min(block_k, T) would make the reduction depend on T);
//  * each score is one fmaf chain over d = 0..hd-1; each row's max and
//    sum over a block are a fixed butterfly over the same 16 lanes,
//    whichever of the 16 row groups the row sits in; each output element
//    is one fmaf chain over the block's keys in order;
//  * a tile skips only blocks that are fully masked for all its rows.  A
//    block that is fully masked for one row but visited for another adds
//    exact zeros to that row once its running max is finite (p = 0,
//    correction 1), and before that its sums are wiped by the correction
//    exp(-1e30 - m) = 0 at the row's first visible block, exactly as a
//    skipped block would leave them.  Masked keys must be finite (chunk
//    buffers hold zeros or earlier K/V rows there).
// Shared memory holds the Q tile, one K or V block (V overwrites K once
// the scores are taken) and the block's probabilities, all fp32, with a
// one-float row pad so the 16 lanes of a row group read 16 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per block
constexpr int THREADS = 256;    // 16 row groups x 16 lanes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
             const T* __restrict__ v, T* __restrict__ out, int S, int T_len,
             int H, int KV, int q_offset, int causal, int window,
             float scale) {
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
  }
}

template <int HD>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BQ * (BK + 1));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int T_len, int H, int KV, int q_offset, int causal,
           int window, cudaStream_t stream) {
  auto kern = flash_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<HD>());
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, smem_bytes<HD>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, T_len, H, KV,
      q_offset, causal, window, 1.f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int S, int T_len, int H, int KV, int hd, int q_offset,
             int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, T_len, H, KV, q_offset,
                                  causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, T_len, H, KV, q_offset,
                                  causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, T_len, H, KV, q_offset,
                                  causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, T_len, H, KV,
                                    q_offset, causal, window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 fp32, 1 bf16.  Returns a cudaError_t code (0: launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int S, int T_len, int H,
                               int KV, int hd, int q_offset, int causal,
                               int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, S, T_len, H, KV, hd, q_offset,
                           causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, T_len, H, KV, hd,
                                   q_offset, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
