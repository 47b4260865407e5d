// Fused cascade confidence gate for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/confidence_gate.py::confidence_gate
// (Pallas, one (8, 1024) vocab tile per grid step, scratch accumulators
// carried across the sequential vocab sweep).  It computes, in ONE pass
// over each row of logits [R, V]:
//
//   conf    = max softmax probability  (the paper's gate score)
//   entropy = log S - T / S            (S = sum e^{x-m}, T = sum (x-m) e^{x-m})
//   argmax  = first index of the maximum
//   logz    = m + log S
//
// What bounds it on this card: bytes.  Each logit is read once (4 bytes)
// and costs a handful of operations, far below the H100's ~20 f32
// operations per byte of HBM bandwidth.  The main path reads [R, 262144]
// and [R, 200064] f32 rows, R = engine slots (8).
//
// Design: the TPU grid ran the vocab sweep in order on one core; here
// blocks run in parallel and carry nothing between them, so one block
// owns one row and the sweep becomes a strided loop inside it.  Each of
// the 1024 threads streams every 1024th element (16-byte loads when the
// row allows) with its own online-softmax state (m, S, T, amax, aidx);
// the states then merge through warp shuffles and shared memory with the
// rescaling rule
//   m = max(m1, m2),  S = S1 e^{m1-m} + S2 e^{m2-m},
//   T = e^{m1-m} (T1 + (m1-m) S1) + e^{m2-m} (T2 + (m2-m) S2),
// and the argmax merge keeps the smaller index on a tie.  With R = 8 the
// launch uses 8 of 132 SMs: a row split over several blocks with a second
// merge pass is the next step once this kernel shows up in a profile.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kNeg = -1e30f;     // the TPU kernel's "empty" sentinel

struct GateState {
  float m, s, t, amax;
  int aidx;
};

__device__ __forceinline__ void push(GateState& st, float x, int idx) {
  if (x > st.m) {
    // rescale the running sums onto the new max
    float corr = __expf(st.m - x);
    st.t = corr * (st.t + (st.m - x) * st.s);
    st.s = st.s * corr + 1.0f;
    st.m = x;
  } else {
    float e = __expf(x - st.m);
    st.s += e;
    st.t += (x - st.m) * e;
  }
  if (x > st.amax) {   // strict: within a thread indices only ascend
    st.amax = x;
    st.aidx = idx;
  }
}

__device__ __forceinline__ GateState merge(const GateState& a,
                                           const GateState& b) {
  GateState r;
  r.m = fmaxf(a.m, b.m);
  float ca = __expf(a.m - r.m), cb = __expf(b.m - r.m);
  r.s = a.s * ca + b.s * cb;
  r.t = ca * (a.t + (a.m - r.m) * a.s) + cb * (b.t + (b.m - r.m) * b.s);
  if (b.amax > a.amax || (b.amax == a.amax && b.aidx < a.aidx)) {
    r.amax = b.amax;
    r.aidx = b.aidx;
  } else {
    r.amax = a.amax;
    r.aidx = a.aidx;
  }
  return r;
}

__device__ __forceinline__ GateState shfl_down(const GateState& st, int off) {
  GateState o;
  o.m = __shfl_down_sync(0xffffffffu, st.m, off);
  o.s = __shfl_down_sync(0xffffffffu, st.s, off);
  o.t = __shfl_down_sync(0xffffffffu, st.t, off);
  o.amax = __shfl_down_sync(0xffffffffu, st.amax, off);
  o.aidx = __shfl_down_sync(0xffffffffu, st.aidx, off);
  return o;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ logits, long long vocab,
            float* __restrict__ conf, float* __restrict__ ent,
            int* __restrict__ argmax, float* __restrict__ logz) {
  const long long row = blockIdx.x;
  const T* x = logits + row * vocab;
  GateState st{kNeg, 0.0f, 0.0f, kNeg, 0};
  if constexpr (kVec4) {
    // f32 rows with vocab % 4 == 0: 16-byte loads, 4 ascending indices
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = vocab / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 v = __ldg(x4 + i);
      int base = static_cast<int>(i * 4);
      push(st, v.x, base);
      push(st, v.y, base + 1);
      push(st, v.z, base + 2);
      push(st, v.w, base + 3);
    }
  } else {
    for (long long i = threadIdx.x; i < vocab; i += kThreads) {
      push(st, to_f32(x[i]), static_cast<int>(i));
    }
  }
  for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));

  __shared__ GateState warp_st[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_st[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = warp_st[lane];          // kThreads / 32 == 32 warps
    for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));
    if (lane == 0) {
      float lz = st.m + logf(st.s);
      conf[row] = expf(st.amax - lz);
      ent[row] = logf(st.s) - st.t / st.s;
      argmax[row] = st.aidx;
      logz[row] = lz;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int confidence_gate(const void* logits, long long rows,
                               long long vocab, int dtype, float* conf,
                               float* ent, int* argmax, float* logz,
                               void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(rows)), block(kThreads);
  if (dtype == 0) {
    const float* x = static_cast<const float*>(logits);
    bool vec = vocab % 4 == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (vec)
      gate_kernel<float, true><<<grid, block, 0, s>>>(x, vocab, conf, ent,
                                                      argmax, logz);
    else
      gate_kernel<float, false><<<grid, block, 0, s>>>(x, vocab, conf, ent,
                                                       argmax, logz);
  } else if (dtype == 1) {
    gate_kernel<__nv_bfloat16, false><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(logits), vocab, conf, ent, argmax,
        logz);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
