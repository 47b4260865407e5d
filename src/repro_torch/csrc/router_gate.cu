// MoE router gate for Hopper (sm_90a).
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
// What bounds it on this card: launch latency.  At granite-moe's
// [512, 40] f32 rows it reads 80 KiB and writes 32 KiB, some 0.03 us of
// HBM time against a few microseconds to launch any kernel; the work
// (k shuffle rounds per row) is as small.
//
// Design: the TPU tile layout is not carried over.  One warp owns one
// row, with no shared memory and no block barrier.  Lane l holds the
// row's elements l, l + 32, ... in registers (NPER = ceil(E / 32) of
// them, a template parameter so the array stays in registers), loaded
// coalesced.  The max and the sum are warp-shuffle reductions; each of
// the k rounds is a shuffle argmax over (value, index) pairs that keeps
// the lower index on a tie, and the lane that owns the pick marks it in
// a bitmask.  Lane j % 32 writes pick j and rescales it after the last
// round: it rereads only its own writes, so no warp barrier is needed.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // rows per block
constexpr int kMaxExperts = 1024;  // 32 registers per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// (v, i) beats (bv, bi): a larger value, or an equal one at a lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename T, int NPER>
__global__ void __launch_bounds__(kWarps * 32)
router_kernel(const T* __restrict__ logits, long long rows, int E, int k,
              float* __restrict__ gates, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;         // the whole warp leaves together
  const T* x = logits + row * E;

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
  float* g = gates + row * k;
  int* ix = idx + row * k;
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
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    const float gate = expf(bv - m) / s;
    total += gate;
    if ((r & 31) == lane) {
      g[r] = gate;
      ix[r] = bi;
    }
  }
  const float denom = fmaxf(total, 1e-9f);
  for (int r = lane; r < k; r += 32) g[r] /= denom;
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
