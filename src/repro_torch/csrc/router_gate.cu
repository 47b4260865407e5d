// MoE router gate and queue ranks for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/router_gate.py::router_gate
// (Pallas: row tiles of 8 with E padded to a multiple of 128, k argmax
// extractions unrolled over the tile).  Per row of logits [R, E],
// E <= 1024, computed in f32:
//
//   m = max_e x_e,  s = sum_e exp(x_e - m)
//   k rounds: pick the largest logit not yet picked (the lowest index
//             among equals); gate_j = exp(x_pick - m) / s
//   gate_j /= max(sum_j gate_j, 1e-9)
//
// Two entry points share that row body:
//
//   router_gate  (gates, idx) of every row: router_kernel;
//   moe_route    the same for logits [G, gs, E] (G groups of gs token
//                slots), and besides, for every (slot, pick) pair of a
//                group, its rank in its expert's queue — how many earlier
//                pairs of the group, in (slot, pick) order, picked the
//                same expert — and from it the pair's row of the MoE
//                capacity buffer, dest = (e * G + g) * cap + rank if
//                rank < cap, else the spare row E * G * cap, and its
//                combine weight (the gate if kept, else 0):
//                moe_route_kernel.  It replaces the one-hot cumsum of
//                repro/models/blocks.py::moe_ffn (the JAX package
//                computes the ranks there, outside any Pallas kernel).
//
// What bounds it on this card: launch latency and the ranks' order.  At
// granite-moe's [512, 40] f32 rows it reads 80 KiB and writes 80 KiB,
// some 0.05 us of HBM time against a few microseconds to launch any
// kernel; the work (k shuffle rounds per row) is as small.  The ranks
// are a scan in (slot, pick) order over the group: 4096 pairs in
// granite's full bucket, 2048 a group in jamba's prefill.
//
// Design: one warp owns one row, with no block barrier in the row body.
// Lane l holds the row's elements l, l + 32, ... in registers (NPER =
// ceil(E / 32) of them, a template parameter so the array stays in
// registers), loaded coalesced.  The max and the sum are warp-shuffle
// reductions; in each of the k rounds every lane takes its best element
// not yet picked (the lower index on a tie), and two redux.sync
// reductions find the warp's largest value (as an order-preserving
// unsigned key) and the lowest index holding it; the lane that owns the
// pick marks it in a bitmask.  Lane j % 32 writes pick j and
// rescales it after the last round: it rereads only its own writes.
//
// moe_route spreads a group's rows over ceil(gs / rpb) blocks of rpb <=
// 32 rows, warp w routing the block's row w.  A row's k picks are
// distinct experts, so the pairs of the block ahead of (row w, pick j)
// with its expert e are exactly the block's earlier rows that picked e:
// each warp ORs bit w into a shared word per expert (rows_of[e], an
// order-free integer OR), and after one barrier the pair's block-local
// rank is popc(rows_of[e] & ((1 << w) - 1)) and the block's count of e
// is popc(rows_of[e]).  A group of one block is done there.  Otherwise
// each block writes its local ranks (into dest) and its per-expert
// counts to a workspace, fences, and bumps the group's counter with one
// acquire-release atom.inc (it wraps back to 0, so the counters need no
// reset); the group's last block scans the counts per expert in block
// order (a warp's shuffle scan an expert) into the blocks' offsets, adds
// each pair's block offset to its local rank, and writes dest (and the
// weight 0 of a dropped pair).  Every step is an integer OR, count or
// sum in a fixed order, so the results do not depend on which block
// ends last and two calls give the same bits; no float is merged by an
// atomic.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // router_gate: rows per block
constexpr int kMaxExperts = 1024;  // 32 registers per lane
constexpr int kMaxRouteRows = 32;  // moe_route: rows a block, one bit each
constexpr int kTable = 8192;       // block offsets the last block keeps in
                                   // shared memory (else in the workspace)
constexpr int kPairBatch = 4;      // pairs a last-block thread loads at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// An unsigned key in the order of the float v (-0 as +0, which compares
// equal to it), and the value of a key.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// One warp routes the row x[0, E): lane r % 32 writes pick r's index to
// ix[r] and its gate before renormalising to g[r].  Returns the
// renormalising denominator max(sum of the k gates, 1e-9), the same in
// every lane.
template <typename T, int NPER>
__device__ __forceinline__ float route_row(const T* __restrict__ x, int E,
                                           int k, int lane, float* g,
                                           int* ix) {
  float v[NPER];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NPER; ++j) {
    const int e = j * 32 + lane;
    v[j] = e < E ? to_f32(x[e]) : -INFINITY;
    m = fmaxf(m, v[j]);
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NPER; ++j)
    if (j * 32 + lane < E) s += expf(v[j] - m);
  // xor butterflies: every lane ends with the same bits (a + b == b + a)
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);

  uint32_t taken = 0;              // bit j: element j * 32 + lane picked
  float total = 0.0f;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < NPER; ++j) {
      const int e = j * 32 + lane;
      if (e < E && !((taken >> j) & 1u) && better(v[j], e, bv, bi)) {
        bv = v[j];
        bi = e;
      }
    }
    // the warp's largest value, then the lowest index holding it: two
    // redux.sync reductions
    const unsigned key = bi != 0x7fffffff ? order_key(bv) : 0u;
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    bi = __reduce_min_sync(0xffffffffu, key == top ? bi : 0x7fffffff);
    bv = key_value(top);
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    const float gate = expf(bv - m) / s;
    total += gate;
    if ((r & 31) == lane) {
      g[r] = gate;
      ix[r] = bi;
    }
  }
  return fmaxf(total, 1e-9f);
}

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const T* __restrict__ logits, long long rows, int E, int k,
              float* __restrict__ gates, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;         // the whole warp leaves together
  float* g = gates + row * k;
  const float denom = route_row<T, NPER>(logits + row * E, E, k, lane, g,
                                         idx + row * k);
  for (int r = lane; r < k; r += 32) g[r] /= denom;
}

// Block (g, b) of grid G * nb routes slots [b * rpb, b * rpb + rpb) of
// group g; see the file's head.  gates, idx, dest, weight: [G, gs, k];
// hist: [G, nb, E] and count: [G] (zero on entry, left zero), read only
// when nb > 1.
template <typename T, int NPER>
__global__ void __launch_bounds__(kMaxRouteRows * 32)
moe_route_kernel(const T* __restrict__ logits, int G, int gs, int E, int k,
                 int cap, int rpb, int nb, float* __restrict__ gates,
                 int* __restrict__ idx, long long* __restrict__ dest,
                 float* __restrict__ weight, int* __restrict__ hist,
                 unsigned* __restrict__ count) {
  __shared__ unsigned rows_of[kMaxExperts];   // bit w: row w picked e
  __shared__ int table[kTable];
  __shared__ bool last;
  const int g = blockIdx.x / nb, b = blockIdx.x % nb;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int s = b * rpb + w;                  // the warp's slot
  const long long gp = static_cast<long long>(g) * gs * k;
  const long long p0 = gp + static_cast<long long>(s) * k;
  const long long spare = static_cast<long long>(E) * G * cap;
  for (int e = threadIdx.x; e < E; e += blockDim.x) rows_of[e] = 0u;
  __syncthreads();
  if (s < gs) {
    const float denom = route_row<T, NPER>(
        logits + (static_cast<long long>(g) * gs + s) * E, E, k, lane,
        gates + p0, idx + p0);
    for (int r = lane; r < k; r += 32) {
      const float gate = gates[p0 + r] / denom;
      gates[p0 + r] = gate;
      weight[p0 + r] = gate;
      atomicOr(&rows_of[idx[p0 + r]], 1u << w);
    }
  }
  __syncthreads();
  if (s < gs) {
    const unsigned before = (1u << w) - 1u;   // the block's earlier rows
    for (int r = lane; r < k; r += 32) {
      const int e = idx[p0 + r];
      const int rank = __popc(rows_of[e] & before);
      if (nb > 1) {
        dest[p0 + r] = rank;                  // block-local, for the merge
      } else if (rank < cap) {
        dest[p0 + r] = (static_cast<long long>(e) * G + g) * cap + rank;
      } else {
        dest[p0 + r] = spare;
        weight[p0 + r] = 0.0f;
      }
    }
  }
  if (nb == 1) return;

  int* hg = hist + static_cast<long long>(g) * nb * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    hg[b * E + e] = __popc(rows_of[e]);
  // each thread's writes reach the device before the count moves
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: this block's writes are visible before the count moves;
    // acquire: the last block sees every block counted before it
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(prev)
                 : "l"(count + g), "r"(nb - 1)
                 : "memory");
    last = prev == unsigned(nb - 1);
  }
  __syncthreads();
  if (!last) return;

  // the group's last block.  offset[b][e] = the count of e over the
  // blocks before b: warp w scans experts w, w + warps, ..., lane l
  // holding blocks l, l + 32, ... (one shuffle scan per 32 blocks)
  int* tab = nb * E <= kTable ? table : hg;   // in place in the workspace
  const int warps = blockDim.x >> 5;
  for (int e = w; e < E; e += warps) {
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int bb = b0 + lane;
      const int h = bb < nb ? __ldcg(hg + bb * E + e) : 0;
      int incl = h;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (bb < nb) tab[bb * E + e] = carry + incl - h;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
  __syncthreads();
  // every pair of the group: its local rank plus its block's offset,
  // kPairBatch pairs a thread loaded at once
  const int n = gs * k, nt = blockDim.x;
  for (int q = threadIdx.x; q < n; q += kPairBatch * nt) {
    int e[kPairBatch], lr[kPairBatch];
#pragma unroll
    for (int u = 0; u < kPairBatch; ++u) {
      const int p = q + u * nt;
      if (p < n) {
        e[u] = __ldcg(idx + gp + p);
        lr[u] = static_cast<int>(__ldcg(dest + gp + p));
      }
    }
#pragma unroll
    for (int u = 0; u < kPairBatch; ++u) {
      const int p = q + u * nt;
      if (p >= n) continue;
      const int rank = lr[u] + tab[(p / k / rpb) * E + e[u]];
      if (rank < cap) {
        dest[gp + p] = (static_cast<long long>(e[u]) * G + g) * cap + rank;
      } else {
        dest[gp + p] = spare;
        weight[gp + p] = 0.0f;
      }
    }
  }
}

template <typename T>
void launch(const T* x, long long rows, int E, int k, float* gates, int* idx,
            cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const int nper = (E + 31) / 32;
  if (nper <= 1)
    router_kernel<T, 1><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
  else if (nper <= 2)
    router_kernel<T, 2><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
  else if (nper <= 4)
    router_kernel<T, 4><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
  else if (nper <= 8)
    router_kernel<T, 8><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
  else if (nper <= 16)
    router_kernel<T, 16><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
  else
    router_kernel<T, 32><<<grid, block, 0, s>>>(x, rows, E, k, gates, idx);
}

struct RouteArgs {
  int G, gs, E, k, cap, rpb, nb;
  float* gates;
  int* idx;
  long long* dest;
  float* weight;
  int* hist;
  unsigned* count;
};

template <typename T, int NPER>
void launch_route_n(const T* x, const RouteArgs& a, cudaStream_t s) {
  moe_route_kernel<T, NPER><<<a.G * a.nb, a.rpb * 32, 0, s>>>(
      x, a.G, a.gs, a.E, a.k, a.cap, a.rpb, a.nb, a.gates, a.idx, a.dest,
      a.weight, a.hist, a.count);
}

template <typename T>
void launch_route(const T* x, const RouteArgs& a, cudaStream_t s) {
  const int nper = (a.E + 31) / 32;
  if (nper <= 1)
    launch_route_n<T, 1>(x, a, s);
  else if (nper <= 2)
    launch_route_n<T, 2>(x, a, s);
  else if (nper <= 4)
    launch_route_n<T, 4>(x, a, s);
  else if (nper <= 8)
    launch_route_n<T, 8>(x, a, s);
  else if (nper <= 16)
    launch_route_n<T, 16>(x, a, s);
  else
    launch_route_n<T, 32>(x, a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Needs 1 <= k <= E <=
// 1024.  Returns cudaGetLastError().
extern "C" int router_gate(const void* logits, long long rows, int E, int k,
                           int dtype, float* gates, int* idx, void* stream) {
  if (E < 1 || E > kMaxExperts || k < 1 || k > E)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch(static_cast<const float*>(logits), rows, E, k, gates, idx, s);
  else if (dtype == 1)
    launch(static_cast<const __nv_bfloat16*>(logits), rows, E, k, gates,
           idx, s);
  else if (dtype == 2)
    launch(static_cast<const __half*>(logits), rows, E, k, gates, idx, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// logits [G, gs, E] (dtype as router_gate's), k picks a slot, cap queue
// places an expert per group, rows_per_block in 1..32 (blocks a group:
// ceil(gs / rows_per_block)).  Writes gates, weight [G, gs, k] f32, idx
// [G, gs, k] int32 and dest [G, gs, k] int64.  With more than one block
// a group: hist [G, blocks, E] int32 as workspace and count [G] zero on
// entry and left zero.  Needs 1 <= k <= E <= 1024, cap >= 1.  Returns
// cudaGetLastError().
extern "C" int moe_route(const void* logits, long long groups, long long gs,
                         int E, int k, long long cap, int rows_per_block,
                         int dtype, float* gates, int* idx, long long* dest,
                         float* weight, int* hist, unsigned* count,
                         void* stream) {
  if (E < 1 || E > kMaxExperts || k < 1 || k > E || cap < 1 ||
      cap >= (1LL << 31) || rows_per_block < 1 ||
      rows_per_block > kMaxRouteRows || groups < 0 || gs < 0 ||
      gs * k >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups == 0 || gs == 0) return 0;
  RouteArgs a;
  a.G = static_cast<int>(groups);
  a.gs = static_cast<int>(gs);
  a.E = E;
  a.k = k;
  a.cap = static_cast<int>(cap);
  a.rpb = rows_per_block < gs ? rows_per_block : a.gs;
  a.nb = (a.gs + a.rpb - 1) / a.rpb;
  if (groups * a.nb >= (1LL << 31) ||
      static_cast<long long>(a.nb) * E >= (1LL << 31) ||
      (a.nb > 1 && (hist == nullptr || count == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.gates = gates;
  a.idx = idx;
  a.dest = dest;
  a.weight = weight;
  a.hist = hist;
  a.count = count;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_route(static_cast<const float*>(logits), a, s);
  else if (dtype == 1)
    launch_route(static_cast<const __nv_bfloat16*>(logits), a, s);
  else if (dtype == 2)
    launch_route(static_cast<const __half*>(logits), a, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
