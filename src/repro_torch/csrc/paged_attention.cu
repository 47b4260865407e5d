// Paged flash-decode attention for Hopper (sm_90a), on the tensor cores.
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
// step masks) attends the null block 0; its output is finite and
// discarded.
//
// What bounds it on this card: bytes.  One token per row meets every
// visible key once, so a key costs 4 hd f32 operations per query head
// against 2 hd element reads — under 2 operations per byte, far below the
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.
//
// Design: a row is a work item of one token of the tile body in
// paged_tile.cuh (shared with ragged_attention.cu): its G query heads are
// the live MMA rows, and the block's 4 warps each multiply a quarter of
// every K/V tile's keys (3xTF32 mma.sync), the tiles double-buffered by
// cp.async through the page table.  What starves decode is the grid: one
// block per (row, KV head) is 8 blocks at gemma3 (KV = 1) and 64 at phi4
// on 132 SMs.  So grid z splits a row's visible pages across blocks (the
// launcher picks the count, paged_attention.py::plan_page_splits), each
// writing its unnormalised state to a workspace that a second kernel
// merges in a fixed order; with one split no merge is launched.
#include "paged_tile.cuh"

namespace {

using ptile::kThreads;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads, D >= 256 ? 1 : 2)
paged_decode_kernel(ptile::Args<QT, KT> a, const int* __restrict__ pos) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.x;
  ptile::attend_item<QT, KT, D>(a, ptile::Item{b, b, 1, pos[b]},
                                reinterpret_cast<char*>(smem4));
}

template <typename QT>
__global__ void __launch_bounds__(ptile::kMergeThreads)
paged_merge_kernel(const float* __restrict__ acc, const float* __restrict__ ml,
                   QT* __restrict__ out, long long rows, int D, int splits) {
  ptile::merge_splits(acc, ml, out, rows, rows, D, splits);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  hd must be 32, 64, 112, 128 or 256, G at most 64.
// splits >= 1 blocks share each row's visible pages; with splits > 1
// ws_acc [splits, B, KV, G, hd] and ws_ml [splits, B, KV, G, 2] f32 hold
// their states until the merge.  Returns cudaGetLastError().
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const int* page_table,
                               const int* pos, void* out, float* ws_acc,
                               float* ws_ml, int B, int KV, int G, int hd,
                               int P, int bs, int window, int splits,
                               int q_dtype, int kv_dtype, void* stream) {
  if (B <= 0 || KV <= 0) return 0;
  if (G <= 0 || G > ptile::kRows || P <= 0 || bs <= 0 || splits <= 0 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto qt, auto kt, auto d) -> int {
    using QT = decltype(qt);
    using KT = decltype(kt);
    constexpr int D = decltype(d)::value;
    const size_t smem = ptile::Geom<QT, KT, D>::smem(P);
    auto kern = paged_decode_kernel<QT, KT, D>;
    cudaError_t e = ptile::allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ptile::Args<QT, KT> a{static_cast<const QT*>(q),
                          static_cast<const KT*>(k_pages),
                          static_cast<const KT*>(v_pages),
                          k_scale, v_scale, page_table,
                          static_cast<QT*>(out), ws_acc, ws_ml,
                          B, KV, G, P, bs, window, splits,
                          1.0f / sqrtf(static_cast<float>(D))};
    kern<<<dim3(B, KV, splits), kThreads, smem, s>>>(a, pos);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long rows = static_cast<long long>(B) * KV * G;
    paged_merge_kernel<QT><<<ptile::merge_blocks(rows, D),
                             ptile::kMergeThreads, 0, s>>>(
        ws_acc, ws_ml, static_cast<QT*>(out), rows, D, splits);
    return static_cast<int>(cudaGetLastError());
  };
  return ptile::dispatch(q_dtype, kv_dtype, hd, launch);
}
