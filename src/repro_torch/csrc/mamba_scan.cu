// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba_scan.py::mamba_scan (Pallas:
// grid (B, d tiles of 512, time chunks of 128) with time innermost, the
// [d_tile, n] state in VMEM scratch carried across the sequential chunks,
// each chunk stepped by a fori_loop).  Same recurrence per (b, channel c),
// from h = 0, all in f32:
//
//   h_t[c, :] = exp(dt_t[c] A[c, :]) ⊙ h_{t-1}[c, :] + dt_t[c] x_t[c] B_t
//   y_t[c]    = h_t[c, :] · C_t
//
//   x, dt [B, T, d] f32; B_t, C_t [B, T, n] f32; A [d, n] f32
//   y     [B, T, d] f32
//   h_out [B, d, n] f32: the state after the last step, which the TPU
//         kernel drops and the model's prefill keeps as its decode cache
//
// What bounds it on this card: bytes and the special function units,
// about equally at n = 16.  Per (b, t, channel) the scan reads x and dt
// and writes y (12 bytes) and does about 7 n f32 operations, below the
// f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 operations a byte; its n
// exponentials go to the SFU, 16 a clock per SM.
//
// Design: one block of kThreads threads per (batch row, group of kThreads
// channels); thread c owns channel c and keeps its n state values and its
// row of A, pre-scaled by log2 e, in registers (n is a template parameter:
// 8 or 16), so a step needs no barrier and its n exponentials are one
// ex2.approx each.  The inputs of kTC steps (the block's [kTC, kThreads]
// tiles of x and dt, row-strided, and the row's contiguous [kTC, n] B_t
// and C_t) are staged in shared memory by cp.async, two chunks deep: the
// copy of chunk k + 1 is issued before chunk k is stepped, so the loads
// are in flight while the serial chain runs, and each chunk costs one
// cp.async.wait_group and one barrier.  y goes straight to global memory
// (coalesced across the block's channels).  A ragged last channel group
// is zero-filled and masked; d not a multiple of 4 copies x and dt 4 bytes
// at a time; T = 0 writes a zero state.  The chunked (parallel-in-time)
// form of the scan is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;       // channels per block
constexpr int kTC = 32;            // steps per staged chunk
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros where !in
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N>
struct Stage {
  float x[kTC * kThreads];
  float dt[kTC * kThreads];
  float b[kTC * N];
  float c[kTC * N];
};

// Issue the copies of one chunk: `steps` steps from (b, t0) into `st`.
template <int N, bool kVec>
__device__ __forceinline__ void stage_chunk(
    Stage<N>& st, const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ Bt, const float* __restrict__ Ct,
    long long t_row, int steps, int c0, int d) {
  const float* gb = Bt + t_row * N;
  const float* gc = Ct + t_row * N;
  for (int e = threadIdx.x * 4; e < steps * N; e += kThreads * 4) {
    cp16(st.b + e, gb + e, true);
    cp16(st.c + e, gc + e, true);
  }
  constexpr int kPer = kVec ? 4 : 1;           // floats per copy
  constexpr int kRow = kThreads / kPer;        // copies per step
  for (int e = threadIdx.x; e < steps * kRow; e += kThreads) {
    const int s = e / kRow, j = (e % kRow) * kPer;
    const bool in = c0 + j < d;
    const long long off = (t_row + s) * d + (in ? c0 + j : 0);
    if constexpr (kVec) {
      cp16(st.x + s * kThreads + j, x + off, in);
      cp16(st.dt + s * kThreads + j, dt + off, in);
    } else {
      cp4(st.x + s * kThreads + j, x + off, in);
      cp4(st.dt + s * kThreads + j, dt + off, in);
    }
  }
  cp_commit();
}

template <int N, bool kVec>
__global__ void __launch_bounds__(kThreads)
mamba_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ Bt, const float* __restrict__ Ct,
             const float* __restrict__ A, float* __restrict__ y,
             float* __restrict__ h_out, int T, int d) {
  __shared__ __align__(16) Stage<N> stage[2];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kThreads;
  const int c = c0 + threadIdx.x;
  const bool live = c < d;

  float a2[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a2[i] = live ? A[static_cast<long long>(c) * N + i] * kLog2e : 0.0f;
    h[i] = 0.0f;
  }

  const long long row = static_cast<long long>(b) * T;   // (b, t=0)
  const int chunks = (T + kTC - 1) / kTC;
  if (chunks > 0)
    stage_chunk<N, kVec>(stage[0], x, dt, Bt, Ct, row, min(kTC, T), c0, d);
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kTC;
    const int steps = min(kTC, T - t0);
    cp_wait_all();        // chunk k, the only copy in flight, has landed
    __syncthreads();      // ... for every thread; chunk k-1 is read
    if (k + 1 < chunks)   // into the buffer chunk k-1 used
      stage_chunk<N, kVec>(stage[(k + 1) & 1], x, dt, Bt, Ct,
                           row + t0 + kTC, min(kTC, T - t0 - kTC), c0, d);
    if (!live) continue;
    const Stage<N>& st = stage[k & 1];
    float* yo = y + (row + t0) * d + c;
#pragma unroll 4
    for (int s = 0; s < steps; ++s) {
      const float dv = st.dt[s * kThreads + threadIdx.x];
      const float dx = dv * st.x[s * kThreads + threadIdx.x];
      const float4* b4 = reinterpret_cast<const float4*>(st.b + s * N);
      const float4* c4 = reinterpret_cast<const float4*>(st.c + s * N);
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * q + j;
          h[i] = ex2(dv * a2[i]) * h[i] + dx * bv[j];
          acc += h[i] * cv[j];
        }
      }
      yo[static_cast<long long>(s) * d] = acc;
    }
  }
  if (!live) return;
  float* ho = h_out + (static_cast<long long>(b) * d + c) * N;
#pragma unroll
  for (int i = 0; i < N; ++i) ho[i] = h[i];
}

template <int N>
int launch(const float* x, const float* dt, const float* Bt, const float* Ct,
           const float* A, float* y, float* h_out, int B, int T, int d,
           cudaStream_t s) {
  dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
            static_cast<unsigned>(B));
  if (d % 4 == 0)
    mamba_kernel<N, true><<<grid, kThreads, 0, s>>>(x, dt, Bt, Ct, A, y,
                                                    h_out, T, d);
  else
    mamba_kernel<N, false><<<grid, kThreads, 0, s>>>(x, dt, Bt, Ct, A, y,
                                                     h_out, T, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers f32 and contiguous: x, dt [B, T, d], B_t, C_t [B, T, n],
// A [d, n], y [B, T, d], h_out [B, d, n]; x, dt, B_t and C_t start on a
// 16-byte boundary (cp.async).  n must be 8 or 16.  T = 0 writes a zero
// state.  Returns cudaGetLastError().
extern "C" int mamba_scan(const float* x, const float* dt, const float* Bt,
                          const float* Ct, const float* A, float* y,
                          float* h_out, int B, int T, int d, int n,
                          void* stream) {
  if (B <= 0 || d <= 0) return 0;
  if (T < 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:
      return launch<8>(x, dt, Bt, Ct, A, y, h_out, B, T, d, s);
    case 16:
      return launch<16>(x, dt, Bt, Ct, A, y, h_out, B, T, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
