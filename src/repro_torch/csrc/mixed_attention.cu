// Unified mixed prefill+decode paged attention for Hopper (sm_90a), on the
// tensor cores.
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
// What bounds it on this card: on a prefill chunk, operations on the
// tensor cores — the C tokens of a row read the same pages, ~59 f32
// operations a byte at phi4-mini's 8 rows x 64 tokens, 3 TF32 products
// each under 3xTF32; on a width-1 decode batch each key serves one token,
// and the bytes bound it.
//
// Design: the padded rows are the ragged kernel's work items at a fixed
// stride, so this is a third thin entry kernel of the tile body in
// paged_tile.cuh (3xTF32 mma.sync over (token, query head) rows,
// double-buffered cp.async K/V tiles through the page table; shared with
// ragged_attention.cu and paged_attention.cu).  Block (b, i) of grid x =
// B * ceil(C / BT) takes BT = 64 / G consecutive slots of row b from slot
// i * BT: its live ones, up to q_len[b], are one item; split z = 0 writes
// the zeros of the rest, and a tile with no live slot does only that.  A
// row's last tile may hold few tokens (1 of phi4's 64 at BT = 21) and then
// takes the body's decode layout.  Grid y is the KV head, grid z the
// split of an item's visible pages (plan_page_splits); with more than one
// split, mixed_merge_kernel combines the splits' states for the live
// slots only — the workspace rows of dead slots are never written, and
// their zeros are never overwritten.
#include "paged_tile.cuh"

namespace {

using ptile::kThreads;

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads, D >= 256 ? 1 : 2)
mixed_kernel(ptile::Args<QT, KT> a, const int* __restrict__ q_start,
             const int* __restrict__ q_len, int C, int tiles) {
  extern __shared__ float4 smem4[];
  const int bt = ptile::kRows / a.G;
  const int b = blockIdx.x / tiles;
  const int s0 = (blockIdx.x - b * tiles) * bt;
  const int live = min(q_len[b], C);
  const int ntok = max(0, min(bt, live - s0));
  if (blockIdx.z == 0) {
    // the tile's dead slots [s0 + ntok, min(s0 + bt, C)) are zeros
    const int GD = a.G * D;
    const int first = s0 + ntok, n = min(s0 + bt, C) - first;
    for (int e = threadIdx.x; e < n * GD; e += kThreads) {
      const int s = first + e / GD;
      ptile::store1(a.out + (static_cast<long long>(b * C + s) * a.KV +
                             blockIdx.y) * GD + e % GD,
                    0.0f);
    }
  }
  if (ntok == 0) return;
  ptile::attend_item<QT, KT, D>(a, ptile::Item{b, b * C + s0, ntok,
                                               q_start[b] + s0},
                                reinterpret_cast<char*>(smem4));
}

// out element i of a live slot from the splits' states; a dead slot's
// element (slot (i / D) / KVG of row b, at or past q_len[b]) is left alone
template <typename QT>
__global__ void __launch_bounds__(ptile::kMergeThreads)
mixed_merge_kernel(const float* __restrict__ acc,
                   const float* __restrict__ ml, QT* __restrict__ out,
                   const int* __restrict__ q_len, long long rows, int C,
                   int KVG, int D, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= rows * D) return;
  const long long slot = i / D / KVG;
  const int b = static_cast<int>(slot / C);
  if (slot - static_cast<long long>(b) * C >= q_len[b]) return;
  ptile::merge_element(acc, ml, out, rows, i, D, splits);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale required).  window <= 0 means
// full causal attention.  hd must be 32, 64, 112, 128 or 256, G at most 64.
// splits >= 1 blocks share each item's visible pages; with splits > 1
// ws_acc [splits, B * C, KV, G, hd] and ws_ml [splits, B * C, KV, G, 2]
// f32 hold their states until the merge.  Returns cudaGetLastError().
extern "C" int mixed_attention(const void* q, const void* k_pages,
                               const void* v_pages, const float* k_scale,
                               const float* v_scale, const int* page_table,
                               const int* q_start, const int* q_len,
                               void* out, float* ws_acc, float* ws_ml,
                               int B, int C, int KV, int G, int hd, int P,
                               int bs, int window, int splits, int q_dtype,
                               int kv_dtype, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0) return 0;
  if (G <= 0 || G > ptile::kRows || P <= 0 || bs <= 0 || splits <= 0 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bt = ptile::kRows / G;
  const int tiles = (C + bt - 1) / bt;
  auto launch = [&](auto qt, auto kt, auto d) -> int {
    using QT = decltype(qt);
    using KT = decltype(kt);
    constexpr int D = decltype(d)::value;
    const size_t smem = ptile::Geom<QT, KT, D>::smem(P);
    auto kern = mixed_kernel<QT, KT, D>;
    cudaError_t e = ptile::allow_smem(kern, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ptile::Args<QT, KT> a{static_cast<const QT*>(q),
                          static_cast<const KT*>(k_pages),
                          static_cast<const KT*>(v_pages),
                          k_scale, v_scale, page_table,
                          static_cast<QT*>(out), ws_acc, ws_ml,
                          B * C, KV, G, P, bs, window, splits,
                          1.0f / sqrtf(static_cast<float>(D))};
    kern<<<dim3(static_cast<unsigned>(B * tiles), KV, splits), kThreads,
           smem, s>>>(a, q_start, q_len, C, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
    const long long rows = static_cast<long long>(B) * C * KV * G;
    mixed_merge_kernel<QT><<<ptile::merge_blocks(rows, D),
                             ptile::kMergeThreads, 0, s>>>(
        ws_acc, ws_ml, static_cast<QT*>(out), q_len, rows, C, KV * G, D,
        splits);
    return static_cast<int>(cudaGetLastError());
  };
  return ptile::dispatch(q_dtype, kv_dtype, hd, launch);
}
