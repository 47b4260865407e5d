// Unified mixed prefill+decode paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mixed_attention.py::mixed_attention
// (Pallas: grid (rows, KV heads, pages), the page sweep innermost, one
// [C * G, hd] accumulator per (row, head) in VMEM carried across it; the
// chunked-prefill kernel repro/kernels/prefill_attention.py delegates to
// it).  Same contract:
//
//   q          [B, C, KV, G, hd]  f32 | bf16: C token slots per row
//   k/v pages  [N, bs, KV, hd]    f32 | bf16 | int8 (+ scales [N, bs, KV])
//   page_table [B, P] int32, q_start [B] int32, q_len [B] int32
//   out        [B, C, KV, G, hd]  q's dtype
//
// Slot i < q_len[b] of row b sits at position q_start[b] + i and attends
// the keys at positions <= its own (and > pos - window with a sliding
// window) through row b's page table.  Slots i >= q_len[b], and every slot
// of a q_len == 0 row, are written as zeros (the TPU kernel's output
// there is zero too: it zeroes e for masked keys).
//
// What bounds it on this card: operations on a prefill chunk — the C
// tokens of a row read the same pages, so at phi4-mini's shape (8 rows x
// 64 tokens, G = 3, hd = 128) the f32 multiply-adds outweigh the bytes by
// about 59 operations a byte against a ridge of 20; bytes on a width-1
// decode batch, as for paged_attention.cu.
//
// Design: one block per (row, slot, KV head).  Dead slots write zeros and
// return at once, so a padded decode row costs one short block per dead
// slot.  A live slot is one decode query at its own position: the block's
// 8 warps walk the pages its window sees side by side and merge their
// online-softmax states at the end (paged_attend.cuh).  Neighbouring
// slots of a row re-read the same pages; the 50 MB L2 absorbs most of
// that.  Moving onto the tensor-core tile body of paged_tile.cuh, as the
// ragged and paged kernels did, is the next step.
#include "paged_attend.cuh"

namespace {

using paged::kThreads;

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
mixed_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
             const KT* __restrict__ vp, const float* __restrict__ ksc,
             const float* __restrict__ vsc, const int* __restrict__ pt,
             const int* __restrict__ q_start, const int* __restrict__ q_len,
             QT* __restrict__ out, int C, int KV, int G, int hd, int P,
             int bs, int window, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, h = blockIdx.y;     // t = b * C + i
  const int b = t / C, i = t - b * C;
  const long long off = (static_cast<long long>(t) * KV + h) * G * hd;
  if (i >= q_len[b]) {
    paged::write_zeros(out + off, G * hd);
    return;
  }
  paged::attend<QT, KT>(q + off, kp, vp, ksc, vsc,
                        pt + static_cast<long long>(b) * P, P,
                        q_start[b] + i, KV, h, G, hd, bs, window, scale,
                        out + off, smem);
}

template <typename QT, typename KT>
int launch(const void* q, const void* kp, const void* vp, const float* ksc,
           const float* vsc, const int* pt, const int* q_start,
           const int* q_len, void* out, int B, int C, int KV, int G, int hd,
           int P, int bs, int window, cudaStream_t s) {
  const size_t smem = paged::smem_bytes(G, hd, bs);
  auto kern = mixed_kernel<QT, KT>;
  cudaError_t e = paged::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>(B * C), static_cast<unsigned>(KV));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), ksc, vsc, pt, q_start, q_len,
      static_cast<QT*>(out), C, KV, G, hd, P, bs, window,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* kp, const void* vp,
                const float* ksc, const float* vsc, const int* pt,
                const int* q_start, const int* q_len, void* out, int B, int C,
                int KV, int G, int hd, int P, int bs, int window,
                cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, kp, vp, ksc, vsc, pt, q_start, q_len, out,
                               B, C, KV, G, hd, P, bs, window, s);
    case 1:
      return launch<QT, __nv_bfloat16>(q, kp, vp, ksc, vsc, pt, q_start,
                                       q_len, out, B, C, KV, G, hd, P, bs,
                                       window, s);
    case 2:
      return launch<QT, int8_t>(q, kp, vp, ksc, vsc, pt, q_start, q_len, out,
                                B, C, KV, G, hd, P, bs, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  hd must be a multiple of 32 up to 256.  Returns
// cudaGetLastError().
extern "C" int mixed_attention(const void* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const int* page_table,
                               const int* q_start, const int* q_len,
                               void* out, int B, int C, int KV, int G,
                               int hd, int P, int bs, int window, int q_dtype,
                               int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0) return 0;
  if (hd % 32 != 0 || hd > 32 * paged::kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_kv<float>(kv_dtype, q, k_pages, v_pages, k_scale, v_scale,
                              page_table, q_start, q_len, out, B, C, KV, G,
                              hd, P, bs, window, s);
  if (q_dtype == 1)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pages, v_pages, k_scale,
                                      v_scale, page_table, q_start, q_len, out,
                                      B, C, KV, G, hd, P, bs, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
