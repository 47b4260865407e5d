// Ragged flat token-batch paged attention for Hopper (sm_90a), on the
// tensor cores.
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
// What bounds it on this card: on a prefill tick, operations on the tensor
// cores — the tokens of a row's chunk all read the same pages, ~59 f32
// operations a byte at phi4-mini's 8 rows x 64 tokens, 3 TF32 products
// each under 3xTF32; on a decode tick (one token a row) each key serves
// one token, and the bytes bound it.
//
// Design: the TPU's work list existed so a sequential grid could keep one
// output tile resident; here blocks run in parallel and each finds its own
// work item — BT = 64 / G consecutive tokens of one row, so G query heads
// x BT tokens fill the 64 MMA rows and one page read serves the whole
// tile — by scanning ceil(q_len[b] / BT) over the R rows (R is the
// engine's slot count).  Grid x is ceil(W / BT) + R, a bound on the
// items the host knows without reading q_len; a block past the last item
// zeroes its share of the padding slots.  Grid y is the KV head, grid z
// the split of the item's visible pages (several blocks share a decode
// token's pages where the unsplit grid would leave the card idle; a
// second kernel merges their states).  The item itself is the tile body
// of paged_tile.cuh, shared with paged_attention.cu: 3xTF32 mma.sync,
// double-buffered cp.async K/V tiles through the page table.
#include "paged_tile.cuh"

namespace {

using ptile::kThreads;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads, D >= 256 ? 1 : 2)
ragged_kernel(ptile::Args<QT, KT> a, const int* __restrict__ q_start,
              const int* __restrict__ q_len, int R) {
  extern __shared__ float4 smem4[];
  __shared__ ptile::Item item_sh;
  if (threadIdx.x == 0) {
    // the work item: the x-th tile of ceil(q_len[b] / BT) over the rows;
    // past the last item, row = -1, slot0 = the block's index among the
    // blocks past it, ntok = their count and pos0 = sum(q_len)
    const int bt = ptile::kRows / a.G;
    const int x = blockIdx.x;
    int items = 0, csum = 0;
    ptile::Item it{-1, 0, 0, 0};
    for (int b = 0; b < R; ++b) {
      const int n = q_len[b], nt = (n + bt - 1) / bt;
      if (it.row < 0 && x < items + nt) {
        const int i = x - items;
        it = {b, csum + i * bt, min(bt, n - i * bt), q_start[b] + i * bt};
      }
      items += nt;
      csum += n;
    }
    if (it.row < 0) it = {-1, x - items, static_cast<int>(gridDim.x) - items,
                          csum};
    item_sh = it;
  }
  __syncthreads();
  const ptile::Item it = item_sh;
  if (it.row < 0) {
    // bucket padding: slots sum(q_len) + slot0, + ntok, ... are zeros
    if (blockIdx.z != 0) return;
    const int GD = a.G * D;
    for (int slot = it.pos0 + it.slot0; slot < a.slots; slot += it.ntok) {
      QT* o = a.out + (static_cast<long long>(slot) * a.KV + blockIdx.y) * GD;
      for (int i = threadIdx.x; i < GD; i += kThreads)
        ptile::store1(o + i, 0.0f);
    }
    return;
  }
  ptile::attend_item<QT, KT, D>(a, it, reinterpret_cast<char*>(smem4));
}

template <typename QT>
__global__ void __launch_bounds__(ptile::kMergeThreads)
ragged_merge_kernel(const float* __restrict__ acc,
                    const float* __restrict__ ml, QT* __restrict__ out,
                    const int* __restrict__ q_len, int R, long long rows,
                    int KVG, int D, int splits) {
  int total = 0;
  for (int b = 0; b < R; ++b) total += q_len[b];
  ptile::merge_splits(acc, ml, out, rows,
                      static_cast<long long>(total) * KVG, D, splits);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  hd must be 32, 64, 128 or 256, G at most 64.
// splits >= 1 blocks share each item's visible pages; with splits > 1
// ws_acc [splits, W, KV, G, hd] and ws_ml [splits, W, KV, G, 2] f32 hold
// their states until the merge.  Returns cudaGetLastError().
extern "C" int ragged_attention(const void* q, const void* k_pages,
                                const void* v_pages, const float* k_scale,
                                const float* v_scale, const int* page_table,
                                const int* q_start, const int* q_len,
                                void* out, float* ws_acc, float* ws_ml,
                                int W, int KV, int G, int hd, int R, int P,
                                int bs, int window, int splits, int q_dtype,
                                int kv_dtype, void* stream) {
  if (W <= 0 || KV <= 0) return 0;
  if (G <= 0 || G > ptile::kRows || R <= 0 || P <= 0 || bs <= 0 ||
      splits <= 0 || (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = ptile::kRows / G;
  const unsigned items = static_cast<unsigned>((W + bt - 1) / bt + R);
  auto launch = [&](auto qt, auto kt, auto d) -> int {
    using QT = decltype(qt);
    using KT = decltype(kt);
    constexpr int D = decltype(d)::value;
    const size_t smem = ptile::Geom<QT, KT, D>::smem(P);
    auto kern = ragged_kernel<QT, KT, D>;
    cudaError_t e = ptile::allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ptile::Args<QT, KT> a{static_cast<const QT*>(q),
                          static_cast<const KT*>(k_pages),
                          static_cast<const KT*>(v_pages),
                          k_scale, v_scale, page_table,
                          static_cast<QT*>(out), ws_acc, ws_ml,
                          W, KV, G, P, bs, window, splits,
                          1.0f / sqrtf(static_cast<float>(D))};
    kern<<<dim3(items, KV, splits), kThreads, smem, s>>>(a, q_start, q_len,
                                                         R);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long rows = static_cast<long long>(W) * KV * G;
    ragged_merge_kernel<QT><<<ptile::merge_blocks(rows, D),
                              ptile::kMergeThreads, 0, s>>>(
        ws_acc, ws_ml, static_cast<QT*>(out), q_len, R, rows, KV * G, D,
        splits);
    return static_cast<int>(cudaGetLastError());
  };
  return ptile::dispatch(q_dtype, kv_dtype, hd, launch);
}
