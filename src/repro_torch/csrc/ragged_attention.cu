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
// scanning the prefix sum of q_len (R is the engine's slot count).  From
// there a slot is one query at its own position, as a slot of the padded
// mixed kernel is: the block's 8 warps walk the pages its window sees side
// by side and merge their online-softmax states at the end
// (paged_attend.cuh, shared with paged_attention.cu and
// mixed_attention.cu).  Neighbouring tokens of one row re-read the same
// pages; the 50 MB L2 absorbs most of that, and tensor-core (wgmma) tiles
// over a token tile are later work.
#include "paged_attend.cuh"

namespace {

using paged::kThreads;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
              const KT* __restrict__ vp, const float* __restrict__ ksc,
              const float* __restrict__ vsc, const int* __restrict__ pt,
              const int* __restrict__ q_start, const int* __restrict__ q_len,
              QT* __restrict__ out, int KV, int G, int hd, int R, int P,
              int bs, int window, float scale) {
  extern __shared__ float smem[];
  __shared__ int row_sh, start_sh;
  const int t = blockIdx.x, h = blockIdx.y;     // flat token slot, KV head
  const long long off = (static_cast<long long>(t) * KV + h) * G * hd;
  if (threadIdx.x == 0) {
    // owning row: the first b with cumsum(q_len)[b] > t
    int csum = 0, row = -1, start = 0;
    for (int b = 0; b < R; ++b) {
      const int n = q_len[b];
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
    paged::write_zeros(out + off, G * hd);
    return;
  }
  paged::attend<QT, KT>(q + off, kp, vp, ksc, vsc,
                        pt + static_cast<long long>(row) * P, P,
                        q_start[row] + (t - start_sh), KV, h, G, hd, bs,
                        window, scale, out + off, smem);
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* pt, const int* q_start,
           const int* q_len, void* out, int W, int KV, int G, int hd, int R,
           int P, int bs, int window, cudaStream_t s) {
  const size_t smem = paged::smem_bytes(G, hd, bs);
  auto kern = ragged_kernel<QT, KT>;
  cudaError_t e = paged::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
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
// full causal attention.  hd must be a multiple of 32 up to 256.  Returns
// cudaGetLastError().
extern "C" int ragged_attention(const void* q, const void* k_pages,
                                const void* v_pages, const float* k_scale,
                                const float* v_scale, const int* page_table,
                                const int* q_start, const int* q_len,
                                void* out, int W, int KV, int G, int hd,
                                int R, int P, int bs, int window, int q_dtype,
                                int kv_dtype, void* stream) {
  if (W <= 0 || KV <= 0) return 0;
  if (hd % 32 != 0 || hd > 32 * paged::kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
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
