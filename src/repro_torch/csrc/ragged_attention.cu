// Ragged flat token-batch paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ragged_attention.py::ragged_attention
// (Pallas: a host-built work list of (token tile, owning row, page) grid
// steps, scalar-prefetched page tables, VMEM accumulators carried across
// the sequential grid).  Same contract:
//
//   q          [W, KV, G, hd]   f32 | bf16: the tick's tokens packed flat;
//                               row b owns slots [row_start[b],
//                               row_start[b] + q_len[b]), row_start the
//                               exclusive prefix sum of q_len
//   k/v pages  [N, bs, KV, hd]  f32 | bf16 | int8 (+ k/v scales [N, bs, KV])
//   page_table [R, P] int32, q_start [R] int32, q_len [R] int32
//   out        [W, KV, G, hd]   q's dtype; slots past sum(q_len) are zero
//
// Slot t of row b sits at absolute position q_start[b] + t - row_start[b]
// and attends the keys at positions <= its own (and > pos - window with a
// sliding window) through row b's page table.
//
// What bounds it on this card: on a prefill tick, operations — the tokens
// of one row's chunk all read the same pages, so the f32 multiply-adds of
// q.k and p.v (4 hd per query head per visible key) outweigh the bytes:
// at phi4-mini's shape, 8 rows x 64 tokens, ~59 operations per byte,
// against a ridge of 67 TFLOP/s / 3.35 TB/s = 20.  On a decode tick (one
// token per row) each page serves one token, and the bytes bound it.
//
// Design: the TPU design's work list existed so a sequential grid could
// keep one output tile resident; blocks here run in parallel, so one
// block owns one (flat token, KV head) pair and finds its row itself by
// scanning the prefix sum of q_len (R is the engine's slot count).  It
// walks only the pages its window can see — from max(0, pos - window +
// 1) / bs to pos / bs — staging each K/V tile in shared memory as f32 and
// running an f32 online softmax for the token's G query heads.  Scale
// order follows the TPU kernel: s = (q.k) / sqrt(hd) * k_scale, masked
// keys contribute e = 0, l += sum(e), then e * v_scale before e . v.
// Neighbouring tokens of one row re-read the same pages; the 50 MB L2
// absorbs most of that, and tensor-core (wgmma) tiles over a token tile
// are the next step once the simple kernel is measured.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
              const KT* __restrict__ vp, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ pt,
              const int* __restrict__ q_start, const int* __restrict__ q_len,
              QT* __restrict__ out, int KV, int G, int hd, int R, int P,
              int bs, int window, float scale) {
  const int t = blockIdx.x;        // flat token slot
  const int h = blockIdx.y;        // KV head
  const int tid = threadIdx.x;
  const int GH = G * hd;

  extern __shared__ float smem[];
  float* q_s = smem;               // [G, hd]
  float* acc_s = q_s + GH;         // [G, hd]
  float* k_s = acc_s + GH;         // [bs, hd]
  float* v_s = k_s + bs * hd;      // [bs, hd]
  float* p_s = v_s + bs * hd;      // [G, bs] scores, then probs * v_scale
  float* m_s = p_s + G * bs;       // [G] running max
  float* l_s = m_s + G;            // [G] running sum of e
  float* c_s = l_s + G;            // [G] rescale factor of this page
  __shared__ int row_sh, start_sh;

  QT* o = out + (static_cast<long long>(t) * KV + h) * GH;
  if (tid == 0) {
    // owning row: the first b with cumsum(q_len)[b] > t
    int csum = 0, row = -1, start = 0;
    for (int b = 0; b < R; ++b) {
      int n = q_len[b];
      if (t < csum + n) {
        row = b;
        start = csum;
        break;
      }
      csum += n;
    }
    row_sh = row;
    start_sh = start;
  }
  __syncthreads();
  const int row = row_sh;
  if (row < 0) {                   // bucket padding: zeros
    for (int i = tid; i < GH; i += kThreads) store(o + i, 0.0f);
    return;
  }
  const int pos = q_start[row] + (t - start_sh);

  const QT* qt = q + (static_cast<long long>(t) * KV + h) * GH;
  for (int i = tid; i < GH; i += kThreads) {
    q_s[i] = to_f32(qt[i]);
    acc_s[i] = 0.0f;
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.0f;
  }
  int lo_page = 0;
  if (window > 0) lo_page = max(pos - window + 1, 0) / bs;
  const int hi_page = min(pos / bs, P - 1);
  const int* prow = pt + static_cast<long long>(row) * P;
  const int warp = tid >> 5, lane = tid & 31, nwarps = kThreads >> 5;
  __syncthreads();

  for (int j = lo_page; j <= hi_page; ++j) {
    const long long blk = prow[j];
    // stage the page's K/V tile for this head: rows of hd are contiguous
    for (int i = tid; i < bs * hd; i += kThreads) {
      int r = i / hd, d = i - r * hd;
      long long src = ((blk * bs + r) * KV + h) * hd + d;
      k_s[i] = to_f32(kp[src]);
      v_s[i] = to_f32(vp[src]);
    }
    __syncthreads();
    // scores: one warp per (query head, key) pair, lanes split hd
    for (int pair = warp; pair < G * bs; pair += nwarps) {
      int g = pair / bs, r = pair - g * bs;
      float dot = 0.0f;
      for (int d = lane; d < hd; d += 32) dot += q_s[g * hd + d] * k_s[r * hd + d];
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        int key = j * bs + r;
        bool live = key <= pos && (window <= 0 || key > pos - window);
        float s = dot * scale;
        if (ksc != nullptr) s *= ksc[(blk * bs + r) * KV + h];
        p_s[pair] = live ? s : kNeg;
      }
    }
    __syncthreads();
    // online softmax bookkeeping, one thread per query head
    if (tid < G) {
      const int g = tid;
      float m_old = m_s[g], mx = kNeg;
      for (int r = 0; r < bs; ++r) mx = fmaxf(mx, p_s[g * bs + r]);
      float m_new = fmaxf(m_old, mx);
      float corr = expf(m_old - m_new);
      float sum = 0.0f;
      for (int r = 0; r < bs; ++r) {
        int key = j * bs + r;
        bool live = key <= pos && (window <= 0 || key > pos - window);
        float e = live ? expf(p_s[g * bs + r] - m_new) : 0.0f;
        sum += e;
        if (vsc != nullptr) e *= vsc[(blk * bs + r) * KV + h];
        p_s[g * bs + r] = e;
      }
      l_s[g] = l_s[g] * corr + sum;
      m_s[g] = m_new;
      c_s[g] = corr;
    }
    __syncthreads();
    for (int i = tid; i < GH; i += kThreads) {
      int g = i / hd, d = i - g * hd;
      float a = acc_s[i] * c_s[g];
      const float* pg = p_s + g * bs;
      for (int r = 0; r < bs; ++r) a += pg[r] * v_s[r * hd + d];
      acc_s[i] = a;
    }
    __syncthreads();               // the next page overwrites k_s/v_s/p_s
  }
  for (int i = tid; i < GH; i += kThreads) {
    int g = i / hd;
    store(o + i, acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

size_t smem_bytes(int G, int hd, int bs) {
  return sizeof(float) * (2 * static_cast<size_t>(G) * hd +
                          2 * static_cast<size_t>(bs) * hd +
                          static_cast<size_t>(G) * bs + 3 * G);
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* pt, const int* q_start,
           const int* q_len, void* out, int W, int KV, int G, int hd, int R,
           int P, int bs, int window, cudaStream_t s) {
  size_t smem = smem_bytes(G, hd, bs);
  auto kern = ragged_kernel<QT, KT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned>(W), static_cast<unsigned>(KV));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ksc, vsc, pt, q_start, q_len,
      static_cast<QT*>(out), KV, G, hd, R, P, bs, window,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                const float* ksc, const float* vsc, const int* pt,
                const int* q_start, const int* q_len, void* out, int W,
                int KV, int G, int hd, int R, int P, int bs, int window,
                cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, kp, vp, ksc, vsc, pt, q_start, q_len, out,
                               W, KV, G, hd, R, P, bs, window, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, kp, vp, ksc, vsc, pt, q_start,
                                       q_len, out, W, KV, G, hd, R, P, bs,
                                       window, s);
    case 2:
      return launch<QT, int8_t>(q, kp, vp, ksc, vsc, pt, q_start, q_len, out,
                                W, KV, G, hd, R, P, bs, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  Returns cudaGetLastError().
extern "C" int ragged_attention(const void* q, const void* k_pages,
                                const void* v_pages, const float* k_scale,
                                const float* v_scale, const int* page_table,
                                const int* q_start, const int* q_len,
                                void* out, int W, int KV, int G, int hd,
                                int R, int P, int bs, int window, int q_dtype,
                                int kv_dtype, void* stream) {
  if (W <= 0 || KV <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_start, q_len, out, W, KV, G, hd,
                              R, P, bs, window, s);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scale,
                                      v_scale, page_table, q_start, q_len,
                                      out, W, KV, G, hd, R, P, bs, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
