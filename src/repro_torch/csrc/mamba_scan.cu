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
// What bounds it on this card: bytes.  Per (b, t, channel) the scan reads
// x and dt and writes y (12 bytes) and does about 7 n f32 operations (n
// exponentials among them): at n = 16, some 9 operations per byte, below
// the f32 ridge of 67 TFLOP/s / 3.35 TB/s = 20.  The n exponentials per
// (b, t, channel) go to the SFU (16 a clock per SM), a second limit about
// as tight as the bytes at n = 16.
//
// Design: one block of 128 threads per (batch row, group of 128
// channels); thread c owns channel c and keeps its n state values and
// its row of A in registers (n is a template parameter: 8 or 16), so
// a step needs no barrier.  B_t and C_t of a chunk of 64 steps are
// staged in shared memory (one coalesced load of the row's contiguous
// [64, n] slices, then broadcast reads) with one barrier per chunk.  x and
// dt are read, and y written, across the block's channels (coalesced),
// 8 steps at a time into registers so that their loads are in flight
// together ahead of the serial chain of state updates.  A ragged last
// channel group is masked; T = 0 writes a zero state.  The chunked
// (parallel-in-time) form of the scan is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // channels per block
constexpr int kTC = 64;            // steps whose B_t, C_t are staged
constexpr int kSub = 8;            // steps whose x, dt sit in registers

template <int N>
__global__ void __launch_bounds__(kThreads)
mamba_kernel(const float* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ Bt, const float* __restrict__ Ct,
             const float* __restrict__ A, float* __restrict__ y,
             float* __restrict__ h_out, int T, int d) {
  __shared__ float bs[kTC * N];
  __shared__ float cs[kTC * N];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < d;

  float a[N], h[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = live ? A[static_cast<long long>(c) * N + i] : 0.0f;
    h[i] = 0.0f;
  }

  const long long row = static_cast<long long>(b) * T;   // (b, t=0)
  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int steps = min(kTC, T - t0);
    __syncthreads();                  // the last chunk's readers are done
    const long long g = (row + t0) * N;
    for (int e = threadIdx.x; e < steps * N; e += kThreads) {
      bs[e] = Bt[g + e];
      cs[e] = Ct[g + e];
    }
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < steps; s0 += kSub) {
      float xv[kSub], dv[kSub], yv[kSub];
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const long long off = (row + t0 + s0 + k) * d + c;
        const bool in = s0 + k < steps;
        xv[k] = in ? x[off] : 0.0f;
        dv[k] = in ? dt[off] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        yv[k] = 0.0f;
        if (s0 + k < steps) {         // past the chunk: state unchanged
          const float* bk = bs + (s0 + k) * N;
          const float* ck = cs + (s0 + k) * N;
          const float dx = dv[k] * xv[k];
          float acc = 0.0f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            h[i] = __expf(dv[k] * a[i]) * h[i] + dx * bk[i];
            acc += h[i] * ck[i];
          }
          yv[k] = acc;
        }
      }
#pragma unroll
      for (int k = 0; k < kSub; ++k)
        if (s0 + k < steps) y[(row + t0 + s0 + k) * d + c] = yv[k];
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
  mamba_kernel<N><<<grid, kThreads, 0, s>>>(x, dt, Bt, Ct, A, y, h_out, T,
                                            d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers f32 and contiguous: x, dt [B, T, d], B_t, C_t [B, T, n],
// A [d, n], y [B, T, d], h_out [B, d, n].  n must be 8 or 16.  T = 0
// writes a zero state.  Returns cudaGetLastError().
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
