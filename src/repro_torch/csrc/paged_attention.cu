// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (Pallas: grid (rows, KV heads, pages) with the page sweep innermost, the
// page table and positions scalar-prefetched, online-softmax accumulators
// in VMEM carried across the sequential page sweep).  Same contract:
//
//   q          [B, KV, G, hd]   f32 | bf16: one query per row
//   k/v pages  [N, bs, KV, hd]  f32 | bf16 | int8 (+ k/v scales [N, bs, KV])
//   page_table [B, P] int32, pos [B] int32
//   out        [B, KV, G, hd]   q's dtype
//
// Row b's query sits at position pos[b] and attends the keys at positions
// <= pos[b] (and > pos[b] - window with a sliding window) through its page
// table.  A row whose page-table row is all zeros (a row the split decode
// step masks) attends the null block 0; its output is discarded.
//
// What bounds it on this card: bytes.  One token per row meets every
// visible key once, so a key costs 4 hd f32 operations per query head
// against 2 hd element reads — under 2 operations per byte, far below the
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design: one block per (row, KV head), its G query heads together.  The
// TPU's sequential page sweep becomes the block's 8 warps walking the
// row's visible pages side by side (page j to warp j mod 8), each with its
// own online-softmax state, merged once at the end (paged_attend.cuh,
// shared with mixed_attention.cu and ragged_attention.cu).  A single
// serial walk of the pages, one tile and four block barriers per page,
// took about three times as long at decode on this card.
// Splitting a row's pages over several blocks (a second pass to merge)
// and tensor-core tiles are later work.
#include "paged_attend.cuh"

namespace {

using paged::kThreads;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                    const KT* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ pt, const int* __restrict__ pos,
                    QT* __restrict__ out, int KV, int G, int hd, int P,
                    int bs, int window, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const long long off = (static_cast<long long>(b) * KV + h) * G * hd;
  paged::attend<QT, KT>(q + off, kp, vp, ksc, vsc,
                        pt + static_cast<long long>(b) * P, P, pos[b], KV, h,
                        G, hd, bs, window, scale, out + off, smem);
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* pt, const int* pos, void* out,
           int B, int KV, int G, int hd, int P, int bs, int window,
           cudaStream_t s) {
  const size_t smem = paged::smem_bytes(G, hd, bs);
  auto kern = paged_decode_kernel<QT, KT>;
  cudaError_t e = paged::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(KV));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ksc, vsc, pt, pos, static_cast<QT*>(out),
      KV, G, hd, P, bs, window, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                const float* ksc, const float* vsc, const int* pt,
                const int* pos, void* out, int B, int KV, int G, int hd,
                int P, int bs, int window, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, kp, vp, ksc, vsc, pt, pos, out, B, KV, G,
                               hd, P, bs, window, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, kp, vp, ksc, vsc, pt, pos, out, B,
                                       KV, G, hd, P, bs, window, s);
    case 2:
      return launch<QT, int8_t>(q, kp, vp, ksc, vsc, pt, pos, out, B, KV, G,
                                hd, P, bs, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  hd must be a multiple of 32 up to 256.  Returns
// cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const int* page_table,
                               const int* pos, void* out, int B, int KV,
                               int G, int hd, int P, int bs, int window,
                               int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  if (hd % 32 != 0 || hd > 32 * paged::kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scale, v_scale,
                              page_table, pos, out, B, KV, G, hd, P, bs,
                              window, s);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scale,
                                      v_scale, page_table, pos, out, B, KV, G,
                                      hd, P, bs, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
