// Device code shared by paged_attention.cu, mixed_attention.cu and
// ragged_attention.cu: one query position of one KV head attends its
// row's pages, with the row's visible pages spread over the block's warps.
//
// Each block holds the G query heads of one (query position, KV head).
// The visible pages run from max(0, pos - window + 1) / bs to pos / bs;
// page j goes to warp j mod kWarps, so the warps walk their pages at the
// same time instead of the block walking them one after another.  A warp
// keeps its own online-softmax state (m, l, acc[G, hd]) in shared memory,
// its lanes split hd (lane owns d = lane + 32 c), and it needs no block
// barrier inside the walk.  At the end the warps' states merge with the
// rescaling rule: M = max_w m_w, L = sum_w l_w exp(m_w - M), out = sum_w
// acc_w exp(m_w - M) / max(L, 1e-30).
//
// Scale order of the TPU kernels (repro/kernels/paged_attention.py,
// mixed_attention.py): s = (q.k) / sqrt(hd) * k_scale, masked keys at
// -1e30 and e = 0 for them, l += sum(e) before e *= v_scale, then
// acc += e . v.  int8 pools are read at one byte an element and
// dequantized through those two scales.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunks = 8;          // hd / 32 <= 8, so hd <= 256
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Shared memory of one block: q [G, hd], then per warp acc [G, hd],
// m [G], l [G] and the page's scores / probabilities [G, bs].
inline size_t smem_bytes(int G, int hd, int bs) {
  const size_t gh = static_cast<size_t>(G) * hd;
  return sizeof(float) *
         (gh + kWarps * (gh + 2 * static_cast<size_t>(G) +
                         static_cast<size_t>(G) * bs));
}

template <typename QT>
__device__ void write_zeros(QT* o, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) store(o + i, 0.0f);
}

// The block's G query heads `qt` [G, hd] at absolute position `pos` attend
// KV head h of the keys at positions [max(0, pos - window + 1), pos]
// (window <= 0: [0, pos]) through page-table row `prow` [P]; the result
// [G, hd] goes to `o`.  Every thread of the block calls it.
template <typename QT, typename KT>
__device__ void attend(const QT* __restrict__ qt, const KT* __restrict__ kp,
                       const KT* __restrict__ vp,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ prow, int P, int pos, int KV,
                       int h, int G, int hd, int bs, int window, float scale,
                       QT* __restrict__ o, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int GH = G * hd, nc = hd >> 5;
  float* q_s = smem;
  float* acc_all = q_s + GH;
  float* m_all = acc_all + kWarps * GH;
  float* l_all = m_all + kWarps * G;
  float* p_all = l_all + kWarps * G;
  float* acc = acc_all + warp * GH;
  float* m = m_all + warp * G;
  float* l = l_all + warp * G;
  float* p = p_all + warp * G * bs;

  for (int i = tid; i < GH; i += kThreads) q_s[i] = to_f32(qt[i]);
  for (int i = lane; i < GH; i += 32) acc[i] = 0.0f;
  for (int g = lane; g < G; g += 32) {
    m[g] = kNeg;
    l[g] = 0.0f;
  }
  __syncthreads();

  const int lo_key = window > 0 ? max(pos - window + 1, 0) : 0;
  const int lo_page = lo_key / bs;
  const int hi_page = min(pos / bs, P - 1);
  for (int j = lo_page + warp; j <= hi_page; j += kWarps) {
    const long long blk = prow[j];
    // scores of the page's bs keys for the G heads; lanes split hd
    for (int r = 0; r < bs; ++r) {
      const long long tok = blk * bs + r;
      const KT* krow = kp + (tok * KV + h) * hd;
      float kr[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        kr[c] = c < nc ? to_f32(krow[lane + 32 * c]) : 0.0f;
      const int key = j * bs + r;
      const bool live = key <= pos && key >= lo_key;
      const float ks = ksc != nullptr ? ksc[tok * KV + h] : 1.0f;
      for (int g = 0; g < G; ++g) {
        const float* qg = q_s + g * hd + lane;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          if (c < nc) dot += qg[32 * c] * kr[c];
        dot = warp_sum(dot);
        if (lane == 0) p[g * bs + r] = live ? dot * scale * ks : kNeg;
      }
    }
    __syncwarp();
    // online-softmax step of each head over the page
    for (int g = 0; g < G; ++g) {
      float mx = kNeg;
      for (int r = lane; r < bs; r += 32) mx = fmaxf(mx, p[g * bs + r]);
      mx = warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);
      const float corr = expf(m_old - m_new);
      float sum = 0.0f;
      for (int r = lane; r < bs; r += 32) {
        const int key = j * bs + r;
        const bool live = key <= pos && key >= lo_key;
        float e = live ? expf(p[g * bs + r] - m_new) : 0.0f;
        sum += e;
        if (vsc != nullptr) e *= vsc[(blk * bs + r) * KV + h];
        p[g * bs + r] = e;
      }
      sum = warp_sum(sum);
      __syncwarp();                    // every lane has read m[g], l[g]
      if (lane == 0) {
        m[g] = m_new;
        l[g] = l[g] * corr + sum;
      }
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        if (c < nc) acc[g * hd + lane + 32 * c] *= corr;
    }
    __syncwarp();
    // acc += e . v
    for (int r = 0; r < bs; ++r) {
      const KT* vrow = vp + ((blk * bs + r) * KV + h) * hd;
      float vr[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c)
        vr[c] = c < nc ? to_f32(vrow[lane + 32 * c]) : 0.0f;
      for (int g = 0; g < G; ++g) {
        const float e = p[g * bs + r];
        float* ag = acc + g * hd + lane;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          if (c < nc) ag[32 * c] += e * vr[c];
      }
    }
    __syncwarp();                      // the next page overwrites p
  }
  __syncthreads();

  // merge the warps' states
  for (int i = tid; i < GH; i += kThreads) {
    const int g = i / hd;
    float M = kNeg;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_all[w * G + g]);
    float L = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_all[w * G + g] - M);
      L += l_all[w * G + g] * f;
      a += acc_all[w * GH + i] * f;
    }
    store(o + i, a / fmaxf(L, 1e-30f));
  }
}

// Raise the kernel's dynamic shared-memory limit where the block needs
// more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace paged
