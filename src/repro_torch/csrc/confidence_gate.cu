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
// What bounds it on this card: bytes.  Each logit is read once (4 bytes,
// 2 in bf16) and costs a handful of operations, far below the H100's ~20
// f32 operations per byte of HBM bandwidth.  The main path reads [8, V]
// rows, V = 262144, 200064, 65536 or 49155: 8 rows alone would fill 8 of
// the 132 SMs, and one SM cannot stream a row at the card's rate.
//
// Design: grid (R, S).  The S blocks of a row split its vocab into
// slices whose boundaries sit on the 16-byte grid past the row's aligned
// head (the host's plan_gate_splits picks S and the slice length from
// the shapes and the SM count: about four blocks an SM, one full wave).
// A block's 256 threads stream their slice with 16-byte loads (4 f32 or
// 8 bf16 values), kUnroll of them in flight per thread, after a scalar
// head up to the first 16-byte address and before a scalar tail, so any
// row vectorises.  Each thread keeps an online-softmax state (m, S, T,
// amax, aidx) and pushes the values of one load at once (one rescale
// onto their max, then independent exponentials); the block merges its
// threads' states through warp shuffles and shared memory with the
// rescaling rule
//   m = max(m1, m2),  S = S1 e^{m1-m} + S2 e^{m2-m},
//   T = e^{m1-m} (T1 + (m1-m) S1) + e^{m2-m} (T2 + (m2-m) S2),
// the argmax keeping the smaller index on a tie.  With one split the
// block writes the outputs.  Otherwise it writes its partial to the
// workspace [R, S] and bumps the row's counter with one acquire-release
// atom.inc (it wraps back to 0, so the counters need no reset).  One
// warp of the row's last block reads the S partials at once and merges
// them in a fixed order (lane l folds splits l, l + 32, ... in turn,
// then the warp's shuffle tree, earlier splits always on the left), so
// the result does not depend on which block ends last, and writes the
// outputs.  No float is merged by an atomic.  What is left over the
// bytes is latency: the load round trip, then the atomic's and the
// partials' round trips to L2 in the last block.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // 16-byte loads in flight per thread
constexpr float kNeg = -1e30f;     // the TPU kernel's "empty" sentinel

struct GateState {
  float m, s, t, amax;
  int aidx;
};

__device__ __forceinline__ GateState empty_state() {
  return GateState{kNeg, 0.0f, 0.0f, kNeg, 0};
}

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

// The block's states merged by a fixed tree (lower threads on the left),
// the result in thread 0.
__device__ GateState block_merge(GateState st) {
  __shared__ GateState warp_st[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));
  if (lane == 0) warp_st[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < kWarps ? warp_st[lane] : empty_state();
    for (int off = 16; off > 0; off >>= 1) st = merge(st, shfl_down(st, off));
  }
  return st;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// K values of ascending indices idx.. pushed at once: one rescale onto
// their max, then K independent exponentials (a scalar push per value
// would chain each exponential behind the last one's compare).
template <int K>
__device__ __forceinline__ void push_vec(GateState& st, const float (&v)[K],
                                         int idx) {
  float mx = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j) mx = fmaxf(mx, v[j]);
  if (mx > st.m) {
    float corr = __expf(st.m - mx);
    st.t = corr * (st.t + (st.m - mx) * st.s);
    st.s *= corr;
    st.m = mx;
  }
  float s = 0.0f, t = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float d = v[j] - st.m, e = __expf(d);
    s += e;
    t += d * e;
  }
  st.s += s;
  st.t += t;
  if (mx > st.amax) {   // strict: within a thread indices only ascend
    int first = K - 1;
#pragma unroll
    for (int j = K - 1; j >= 0; --j)
      if (v[j] == mx) first = j;
    st.amax = mx;
    st.aidx = idx + first;
  }
}

// One 16-byte load's values, in ascending index order.
__device__ __forceinline__ void push16(GateState& st, uint4 v, int idx,
                                       const float*) {
  const float f[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                      __uint_as_float(v.z), __uint_as_float(v.w)};
  push_vec<4>(st, f, idx);
}
__device__ __forceinline__ void push16(GateState& st, uint4 v, int idx,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // little endian: the low half is the lower index
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
  push_vec<8>(st, f, idx);
}

__device__ __forceinline__ void write_out(const GateState& st, long long row,
                                          float* conf, float* ent,
                                          int* argmax, float* logz) {
  float lz = st.m + logf(st.s);
  conf[row] = expf(st.amax - lz);
  ent[row] = logf(st.s) - st.t / st.s;
  argmax[row] = st.aidx;
  logz[row] = lz;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const T* __restrict__ logits, int vocab, int chunk,
            float* __restrict__ conf, float* __restrict__ ent,
            int* __restrict__ argmax, float* __restrict__ logz,
            float4* __restrict__ part, int* __restrict__ part_idx,
            unsigned* __restrict__ count) {
  constexpr int kVec = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const int split = blockIdx.y, splits = gridDim.y;
  const T* x = logits + row * static_cast<long long>(vocab);
  // the row's head: elements before its first 16-byte address
  const int head = min(vocab, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) / sizeof(T)));
  const long long start = head + static_cast<long long>(split) * chunk;
  const int lo = split == 0 ? 0 : static_cast<int>(min(start, 1LL * vocab));
  const int hi = split == splits - 1
                     ? vocab
                     : static_cast<int>(min(start + chunk, 1LL * vocab));
  const int body = split == 0 ? min(head, hi) : lo;   // 16-byte aligned
  const int nvec = (hi - body) / kVec;
  const int tail = body + nvec * kVec;

  GateState st = empty_state();
  // a thread's indices ascend: head, then its vectors, then the tail
  for (int i = lo + threadIdx.x; i < body; i += kThreads)
    push(st, to_f32(x[i]), i);
  const uint4* xv = reinterpret_cast<const uint4*>(x + body);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kUnroll * kThreads) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < nvec) v[u] = __ldg(xv + v0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + u * kThreads < nvec)
        push16(st, v[u], body + (v0 + u * kThreads) * kVec, x);
  }
  for (int i = tail + threadIdx.x; i < hi; i += kThreads)
    push(st, to_f32(x[i]), i);

  st = block_merge(st);
  if (splits == 1) {
    if (threadIdx.x == 0) write_out(st, row, conf, ent, argmax, logz);
    return;
  }
  __shared__ bool last;
  const long long slot = row * splits;
  if (threadIdx.x == 0) {
    part[slot + split] = make_float4(st.m, st.s, st.t, st.amax);
    part_idx[slot + split] = st.aidx;
    // release: the partial is visible before the count moves; acquire:
    // the last block sees every partial counted before it
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(prev)
                 : "l"(count + row), "r"(splits - 1)
                 : "memory");
    last = prev == unsigned(splits - 1);
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  // the row's last block, one warp: lane l reads splits l, l + 32, ...
  // (all at once, past L1) and merges them in that order, then the
  // warp's shuffle tree
  constexpr int kFold = kThreads / 32;
  float4 f[kFold];
  int fi[kFold];
#pragma unroll
  for (int u = 0; u < kFold; ++u) {
    const int j = threadIdx.x + 32 * u;
    if (j < splits) {
      f[u] = __ldcg(part + slot + j);
      fi[u] = __ldcg(part_idx + slot + j);
    }
  }
  GateState p = empty_state();
#pragma unroll
  for (int u = 0; u < kFold; ++u)
    if (threadIdx.x + 32 * u < splits)
      p = merge(p, GateState{f[u].x, f[u].y, f[u].z, f[u].w, fi[u]});
  for (int off = 16; off > 0; off >>= 1) p = merge(p, shfl_down(p, off));
  if (threadIdx.x == 0) write_out(p, row, conf, ent, argmax, logz);
}

template <typename T>
int launch(const void* logits, long long rows, int vocab, int splits,
           int chunk, float* conf, float* ent, int* argmax, float* logz,
           void* part, int* part_idx, unsigned* count, cudaStream_t s) {
  dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(splits));
  gate_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(logits), vocab, chunk, conf, ent, argmax, logz,
      static_cast<float4*>(part), part_idx, count);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [rows, vocab] (dtype: 0 = float32, 1 = bfloat16), split into
// `splits` slices of `chunk` elements past each row's aligned head (a
// multiple of 16 bytes; the last slice takes the rest).  With splits > 1:
// part [rows * splits] float4 and part_idx [rows * splits] int32 as
// workspace, count [rows] zero on entry and left zero.  Returns
// cudaGetLastError().
extern "C" int confidence_gate(const void* logits, long long rows,
                               long long vocab, int dtype, int splits,
                               long long chunk, float* conf, float* ent,
                               int* argmax, float* logz, void* part,
                               int* part_idx, unsigned* count, void* stream) {
  if (rows <= 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  if (vocab <= 0 || vocab >= (1LL << 31) || rows >= (1LL << 31) ||
      splits < 1 || splits > kThreads || chunk <= 0 ||
      (splits > 1 && (chunk * elem % 16 != 0 || !part || !part_idx ||
                      !count)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v = static_cast<int>(vocab);
  const int c = static_cast<int>(chunk < vocab ? chunk : vocab);  // 1 split
  if (dtype == 0)
    return launch<float>(logits, rows, v, splits, c, conf, ent, argmax,
                         logz, part, part_idx, count, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, rows, v, splits, c, conf, ent,
                                 argmax, logz, part, part_idx, count, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
