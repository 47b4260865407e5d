// RWKV-6 WKV scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (Pallas:
// grid (B, H, time chunks of 128) with time innermost, the hd x hd state
// in VMEM scratch carried across the sequential chunks, each chunk stepped
// exactly by a fori_loop of rank-1 updates).  Same recurrence per (b, h),
// from S = 0, all in f32:
//
//   y_t = r_t · (S + u ⊙ k_t v_tᵀ)        (a row vector over value index j)
//   S   ← diag(w_t) S + k_t v_tᵀ          (S[i][j]: key index i, value j)
//
//   r, k, v, w [B, H, T, hd] f32, u [H, hd] f32
//   y          [B, H, T, hd] f32
//   s_out      [B, H, hd, hd] f32: the state after the last step, which
//              the TPU kernel drops and the model's prefill keeps as its
//              decode cache
//
// What bounds it on this card: bytes, and the serial time loop.  Each
// step reads four hd-vectors and writes one per (b, h) and does about
// 5 hd^2 operations, some 4 operations per byte at hd = 64 — below the
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.  The steps of one head are a
// chain, so a head's time is T steps of a few hundred cycles each.
//
// Design: one block per (b, h) with hd threads; thread j owns value
// column j of the state, S[:, j], in hd registers (hd is a template
// parameter: 32, 64 or 128), so a step needs no barrier.  The inputs of a
// chunk of 32 steps are staged in shared memory (coalesced loads, then
// broadcast reads of r_t, k_t and w_t).  y_t[j] is taken as
// sum_i r_t[i] S[i][j] + v_t[j] c_t with c_t = sum_i r_t[i] u[i] k_t[i],
// one scalar per step computed once per chunk: the same terms as the
// TPU kernel's sum, grouped differently.  Splitting a head's columns over
// more blocks (more SMs busy at small B·H) and the chunked-parallel form
// of the recurrence are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTC = 32;            // steps staged per chunk (<= hd)

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kTC * HD + HD + kTC);
}

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int H, int T) {
  extern __shared__ float smem[];
  float* rs = smem;                 // [kTC][HD]
  float* ks = rs + kTC * HD;
  float* ws = ks + kTC * HD;
  float* vs = ws + kTC * HD;
  float* us = vs + kTC * HD;        // [HD]
  float* cs = us + HD;              // [kTC]: sum_i r u k per staged step

  const int j = threadIdx.x;
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const long long base = bh * T * HD;
  us[j] = u[h * HD + j];

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += kTC) {
    const int n = min(kTC, T - t0);
    __syncthreads();                // the last chunk's readers are done
    const long long g = base + static_cast<long long>(t0) * HD;
    for (int e = j; e < n * HD; e += HD) {
      rs[e] = r[g + e];
      ks[e] = k[g + e];
      ws[e] = w[g + e];
      vs[e] = v[g + e];
    }
    __syncthreads();
    if (j < n) {
      float c = 0.0f;
      for (int i = 0; i < HD; ++i)
        c += rs[j * HD + i] * us[i] * ks[j * HD + i];
      cs[j] = c;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float* rt = rs + t * HD;
      const float* kt = ks + t * HD;
      const float* wt = ws + t * HD;
      const float vj = vs[t * HD + j];
      float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        y0 += rt[i] * S[i];
        y1 += rt[i + 1] * S[i + 1];
        y2 += rt[i + 2] * S[i + 2];
        y3 += rt[i + 3] * S[i + 3];
        S[i] = wt[i] * S[i] + kt[i] * vj;
        S[i + 1] = wt[i + 1] * S[i + 1] + kt[i + 1] * vj;
        S[i + 2] = wt[i + 2] * S[i + 2] + kt[i + 2] * vj;
        S[i + 3] = wt[i + 3] * S[i + 3] + kt[i + 3] * vj;
      }
      y[g + static_cast<long long>(t) * HD + j] =
          (y0 + y1) + (y2 + y3) + vj * cs[t];
    }
  }
  float* so = s_out + bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) so[i * HD + j] = S[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* s_out, int B, int H, int T,
           cudaStream_t s) {
  auto kern = wkv_kernel<HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(B * H), HD, smem, s>>>(r, k, v, w, u, y,
                                                      s_out, H, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers f32 and contiguous: r, k, v, w [B, H, T, hd], u [H, hd],
// y [B, H, T, hd], s_out [B, H, hd, hd].  hd must be 32, 64 or 128.  T = 0
// writes a zero state.  Returns cudaGetLastError().
extern "C" int rwkv6_scan(const float* r, const float* k, const float* v,
                          const float* w, const float* u, float* y,
                          float* s_out, int B, int H, int T, int hd,
                          void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(r, k, v, w, u, y, s_out, B, H, T, s);
    case 64:
      return launch<64>(r, k, v, w, u, y, s_out, B, H, T, s);
    case 128:
      return launch<128>(r, k, v, w, u, y, s_out, B, H, T, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
