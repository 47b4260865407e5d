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
// What bounds it on this card: bytes, and beside them the f32 issue rate
// and the shared-memory pipe.  Each step reads four hd-vectors and writes
// one per (b, h) and does 3 hd^2 f32 operations on the state (r·S,
// w ⊙ S, + k vᵀ): about 4 operations per byte at hd = 64, below the
// ridge of 67 TFLOP/s / 3.35 TB/s = 20, but scalar FMAs with no tensor
// core to take them, so at rwkv6-3b's prefill they take about as long as
// the bytes.  Every state value needs r_t[i], k_t[i] and w_t[i] of its row
// each step, and the shared-memory pipe hands an SM 128 bytes a clock (a
// warp's 16-byte load takes 4 of them however few addresses it has): a
// thread that owns a column of the state loads 3 values for every 3 FMAs,
// and the pipe, not the FMAs, sets the time (about 1200 clocks a step at
// rwkv6-3b's shape on an H100).
//
// Design: a thread owns an 8 x 4 tile of the state — 8 rows of a strip by
// 4 value columns, in 32 registers — so each r, k, w value it loads
// serves 4 columns: per step 3 float4 loads per 4 rows and 4 scalar loads
// of v against 96 FMAs.  A warp holds hd / 8 strips (NQ threads) of
// 32 / NQ groups of 4 columns; a block is one (b, h) (4 warps at
// hd = 64, 16 at 128, 1 at 32), so the staged inputs serve every warp of
// the head and grid x is B·H (320 blocks, 1280 warps at rwkv6-3b's
// [8, 40, 640, 64], about 10 warps an SM).  A column's NQ partial sums of
// y_t[j] are combined by a butterfly reduce-scatter over the lane bits
// (xor 1 and 2: 2 + 1 shuffles, then plain sums over the strip bits
// above), after which one lane of each column holds its total.  A
// thread's local column c is column c ^ x of its group, x the bit reverse
// of its low lane bits, so each round keeps the thread's first half and
// sends the second, with no select.  The inputs of a chunk of 16 steps
// are staged in shared memory by 16-byte cp.async, double-buffered (chunk
// c + 1 loads while chunk c is stepped), r, k and w with each strip's
// float4s interleaved (float4 m of strip q at slot m * NQ + q, so a
// quarter warp's loads are 128 contiguous bytes) and each step's row
// padded by 8 floats; a step's operands are loaded while the previous
// step computes.  y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] c_t with c_t =
// sum_i r_t[i] u[i] k_t[i], one scalar per step computed once per chunk
// by the block: the same terms as the TPU kernel's sum, grouped
// differently.  The chunked-parallel (matrix) form of the recurrence is
// later work: products of w over a chunk underflow f32 without log-space
// care.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"       // the cp.async helpers

namespace {

using tf32::cp16;
using tf32::cp_commit;
using tf32::cp_wait;

constexpr int kTC = 16;            // steps staged per chunk
constexpr unsigned kAll = 0xffffffffu;

template <int HD>
struct Geom {
  static constexpr int kSR = 8;                     // state rows a thread
  static constexpr int kCJ = 4;                     // value columns a thread
  static constexpr int kNQ = HD / kSR;              // strips a column
  static constexpr int kColsW = 32 / kNQ * kCJ;     // value columns a warp
  static constexpr int kThreads = 32 * HD / kColsW; // a block is one head
  static constexpr int kNM = kSR / 4;               // float4s of a strip
  static constexpr int kSlots = HD / 4;             // float4s of a vector
  static constexpr int kRS = HD + 8;                // a staged step's row
  static constexpr int kRK = kTC * kRS;             // r, k or w of a chunk
  static constexpr int kBuf = 3 * kRK + kTC * HD;
  static constexpr size_t kSmem = sizeof(float) * (2 * kBuf + HD + kTC);
  static_assert(kNQ >= kCJ && 32 % kNQ == 0 && (kCJ & (kCJ - 1)) == 0 &&
                    kThreads % kTC == 0 && kThreads / kTC <= 32,
                "a column's strips within a warp, at least kCJ of them");
  // slot of global float4 g (elements 4g .. 4g + 3) of a staged vector:
  // float4 g % kNM of strip g / kNM
  static __device__ __forceinline__ int slot(int g) {
    return (g % kNM) * kNQ + g / kNM;
  }
};

// chunk t0's r, k, w (strips interleaved) and v into one buffer; steps
// past T zero-filled
template <int HD>
__device__ __forceinline__ void load_chunk(float* buf, const float* r,
                                           const float* k, const float* v,
                                           const float* w, long long base,
                                           int t0, int T) {
  using Gm = Geom<HD>;
  for (int e = threadIdx.x; e < kTC * Gm::kSlots; e += Gm::kThreads) {
    const int s = e / Gm::kSlots, g = e % Gm::kSlots;
    const bool in = t0 + s < T;
    const long long off =
        in ? base + static_cast<long long>(t0 + s) * HD + 4 * g : base;
    const int d = s * Gm::kRS + 4 * Gm::slot(g);
    cp16(buf + d, r + off, in);
    cp16(buf + Gm::kRK + d, k + off, in);
    cp16(buf + 2 * Gm::kRK + d, w + off, in);
    cp16(buf + 3 * Gm::kRK + s * HD + 4 * g, v + off, in);
  }
}

// one step's operands of a thread: r, k, w of its strip, v of its columns
template <int HD>
struct Ops {
  float4 r[Geom<HD>::kNM], k[Geom<HD>::kNM], w[Geom<HD>::kNM];
  float v[Geom<HD>::kCJ];
};

template <int HD>
__device__ __forceinline__ void load_ops(Ops<HD>& o, const float* buf,
                                         int t, int q, int vcol, int x) {
  using Gm = Geom<HD>;
  const float4* r4 = reinterpret_cast<const float4*>(buf + t * Gm::kRS) + q;
  const float4* k4 =
      reinterpret_cast<const float4*>(buf + Gm::kRK + t * Gm::kRS) + q;
  const float4* w4 =
      reinterpret_cast<const float4*>(buf + 2 * Gm::kRK + t * Gm::kRS) + q;
#pragma unroll
  for (int m = 0; m < Gm::kNM; ++m) {
    o.r[m] = r4[m * Gm::kNQ];
    o.k[m] = k4[m * Gm::kNQ];
    o.w[m] = w4[m * Gm::kNQ];
  }
  const float* vs = buf + 3 * Gm::kRK + t * HD + vcol;
#pragma unroll
  for (int c = 0; c < Gm::kCJ; ++c) o.v[c] = vs[c ^ x];
}

__device__ __forceinline__ float at(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// one step of the thread's tile, S <- w S + k v; returns y_t of column x
// of its group, summed over the column's strips (cz = c_t on strip 0, 0
// on the others, so v c_t is added once)
template <int HD>
__device__ __forceinline__ float step(
    float (&S)[Geom<HD>::kSR][Geom<HD>::kCJ], const Ops<HD>& o, float cz) {
  using Gm = Geom<HD>;
  constexpr int CJ = Gm::kCJ;
  float p[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) p[c] = o.v[c] * cz;
#pragma unroll
  for (int m = 0; m < Gm::kNM; ++m) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * m + e;
      const float ri = at(o.r[m], e), ki = at(o.k[m], e),
                  wi = at(o.w[m], e);
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        p[c] += ri * S[i][c];
        S[i][c] = wi * S[i][c] + ki * o.v[c];
      }
    }
  }
  // butterfly reduce-scatter over lane bits 0 .. log2(CJ) - 1: keep the
  // first half of the local columns, send the second; then plain sums
  // over the strip bits above
#pragma unroll
  for (int half = CJ / 2, bit = 1; half >= 1; half /= 2, bit *= 2)
#pragma unroll
    for (int c = 0; c < half; ++c)
      p[c] += __shfl_xor_sync(kAll, p[c + half], bit);
#pragma unroll
  for (int bit = CJ; bit < Gm::kNQ; bit *= 2)
    p[0] += __shfl_xor_sync(kAll, p[0], bit);
  return p[0];
}

// local column c of a lane is column c ^ x of its group: x is the bit
// reverse of the lane's low log2(CJ) bits, so lane bit b (round b of the
// reduce-scatter) picks column bit log2(CJ) - 1 - b
template <int CJ>
__device__ __forceinline__ int column_mask(int lane) {
  int x = 0;
#pragma unroll
  for (int b = 1, c = CJ / 2; c >= 1; b *= 2, c /= 2)
    if (lane & b) x |= c;
  return x;
}

template <int HD>
__global__ void __launch_bounds__(Geom<HD>::kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int H, int T) {
  using Gm = Geom<HD>;
  constexpr int SR = Gm::kSR, CJ = Gm::kCJ;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* us = smem + 2 * Gm::kBuf;       // [HD], strips interleaved
  float* cs = us + HD;                   // [kTC]: c_t of the chunk's steps

  const int tid = threadIdx.x, lane = tid & 31;
  const int q = lane % Gm::kNQ;          // this thread's strip
  // its columns: CJ of the warp's kColsW
  const int vcol = (tid >> 5) * Gm::kColsW + CJ * (lane / Gm::kNQ);
  const int x = column_mask<CJ>(lane);
  const long long bh = blockIdx.x;
  const int h = static_cast<int>(bh % H);
  const long long base = bh * T * HD;

  if (T > 0) load_chunk<HD>(smem, r, k, v, w, base, 0, T);
  cp_commit();
  for (int i = tid; i < HD; i += Gm::kThreads)
    us[4 * Gm::slot(i / 4) + i % 4] = u[h * HD + i];

  float S[SR][CJ];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) S[i][c] = 0.0f;

  const int nchunks = (T + kTC - 1) / kTC;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int t0 = ch * kTC, n = min(kTC, T - t0);
    const float* buf = smem + (ch & 1) * Gm::kBuf;
    cp_wait<0>();
    // chunk ch is in for every thread, and every thread is done with
    // chunk ch - 1, whose buffer chunk ch + 1 takes, and with cs
    __syncthreads();
    if (ch + 1 < nchunks)
      load_chunk<HD>(smem + ((ch + 1) & 1) * Gm::kBuf, r, k, v, w, base,
                     t0 + kTC, T);
    cp_commit();
    {
      // c_t: kPer threads a step, each over every kPer-th float4 of
      // r ⊙ u ⊙ k
      constexpr int kPer = Gm::kThreads / kTC;
      const int s = tid / kPer, p = tid % kPer;
      const float4* r4 = reinterpret_cast<const float4*>(buf + s * Gm::kRS);
      const float4* k4 =
          reinterpret_cast<const float4*>(buf + Gm::kRK + s * Gm::kRS);
      const float4* u4 = reinterpret_cast<const float4*>(us);
      float acc = 0.0f;
      for (int g = p; g < Gm::kSlots; g += kPer) {
        const float4 a = r4[g], b = u4[g], d = k4[g];
        acc += a.x * b.x * d.x + a.y * b.y * d.y + a.z * b.z * d.z +
               a.w * b.w * d.w;
      }
#pragma unroll
      for (int m = 1; m < kPer; m *= 2)
        acc += __shfl_xor_sync(kAll, acc, m);
      if (p == 0) cs[s] = acc;
    }
    __syncthreads();

    // steps in pairs, each step's operands loading while the one before
    // computes; a pair is one block of code, so the compiler can overlap
    // the first step's shuffles with the second's FMAs
    float* yo = y + base + static_cast<long long>(t0) * HD + vcol + x;
    const bool first = q == 0;           // strip 0 adds v c_t
    const bool writes = q < CJ;          // one lane of a column stores
    Ops<HD> a, b;
    load_ops<HD>(a, buf, 0, q, vcol, x);
    int t = 0;
    for (; t + 1 < n; t += 2) {
      load_ops<HD>(b, buf, t + 1, q, vcol, x);
      const float y0 = step<HD>(S, a, first ? cs[t] : 0.0f);
      load_ops<HD>(a, buf, min(t + 2, n - 1), q, vcol, x);
      const float y1 = step<HD>(S, b, first ? cs[t + 1] : 0.0f);
      if (writes) {
        yo[static_cast<long long>(t) * HD] = y0;
        yo[static_cast<long long>(t + 1) * HD] = y1;
      }
    }
    if (t < n) {
      const float y0 = step<HD>(S, a, first ? cs[t] : 0.0f);
      if (writes) yo[static_cast<long long>(t) * HD] = y0;
    }
  }
  // rows q * SR + i, columns vcol + (c ^ x)
  float* so = s_out + bh * HD * HD + static_cast<long long>(q) * SR * HD +
              vcol;
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int c = 0; c < CJ; ++c) so[i * HD + (c ^ x)] = S[i][c];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* y, float* s_out, int B, int H, int T,
           cudaStream_t s) {
  auto kern = wkv_kernel<HD>;
  const size_t smem = Geom<HD>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(B * H), Geom<HD>::kThreads, smem, s>>>(
      r, k, v, w, u, y, s_out, H, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers f32 and contiguous, r, k, v and w 16-byte aligned:
// r, k, v, w [B, H, T, hd], u [H, hd], y [B, H, T, hd], s_out
// [B, H, hd, hd].  hd must be 32, 64 or 128.  T = 0 writes a zero state.
// Returns cudaGetLastError().
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
