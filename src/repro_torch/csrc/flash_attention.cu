// Dense flash attention for Hopper (sm_90a): causal / sliding-window GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas: grid (batch, q heads, q tiles, kv tiles) with the KV sweep
// innermost, tiles of 128 x 128 and the online-softmax accumulators in
// VMEM scratch carried across the sequential KV sweep).  Same contract:
//
//   q   [B, H, S, d]   f32 | bf16
//   k/v [B, KV, T, d]  q's dtype, H % KV == 0 (query head h reads KV head
//                      h / (H / KV))
//   out [B, H, S, d]   q's dtype
//
// scale = 1/sqrt(d), applied to each q.k dot; the mask is on raw indices:
// kpos <= qpos (causal), kpos > qpos - window (window > 0).  Rows are
// normalised by max(l, 1e-30); masked scores are -1e30, as in the TPU
// kernel.
//
// What bounds it on this card: operations.  A (query, key) pair costs 4d
// f32 operations per query head against 2d key/value elements read once
// per KV head, so at the prefill's S = T = 640 the work is far above the
// ridge of 67 TFLOP/s / 3.35 TB/s = 20 operations per byte.
//
// Design: the TPU's sequential KV sweep becomes a loop inside one block
// per (q tile of 32 queries, head, batch row), 128 threads.  The block's
// Q tile and each 32-key K/V tile sit in shared memory as f32, read back
// as 16-byte vectors: Q and K rows padded to d + 4 floats, so the four
// threads of a query row, reading four different keys, hit different
// banks.  d is a template parameter (32, 64, 128 or 256), which sizes the
// shared memory (104 KB at d = 256, where 64-row f32 tiles of Q, K and V
// would take 192 KB) and keeps each thread's d/4 accumulators in
// registers.  Thread t owns query row t / 4 and, within each key tile,
// keys t % 4 + 4i (8 scores) and the 4-column groups 16m + 4(t % 4) of
// the output: the four threads of a row merge their score maxima and
// sums with two shuffles and pass probabilities through a shared-memory
// row their warp alone writes and reads.  Key tiles that no query of the
// block can see (past the causal diagonal, or before the window) are
// skipped.  f32 on CUDA cores; tensor-core tiles (wgmma) are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;            // queries per block
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr int kKeysPerThread = kBK / 4;
constexpr int kPS = kBK + 4;       // probability row stride (floats)
constexpr float kNeg = -1e30f;

// four consecutive elements as f32 (16- or 8-byte aligned loads)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 4) + kBK * (D + 4) + kBK * D +
                          kBQ * kPS);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int KV,
             int S, int Tk, int causal, int window, float scale) {
  constexpr int D4 = D / 4;                // float4 groups per row
  constexpr int NG = D / 16;               // column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][D + 4]
  float* ks = qs + kBQ * (D + 4);                // [kBK][D + 4]
  float* vs = ks + kBK * (D + 4);                // [kBK][D]
  float* ps = vs + kBK * D;                      // [kBQ][kPS]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + (static_cast<long long>(b) * H + h) * S * D;
  const T* kb = k + (static_cast<long long>(b) * KV + kvh) * Tk * D;
  const T* vb = v + (static_cast<long long>(b) * KV + kvh) * Tk * D;

  for (int e = tid; e < kBQ * D4; e += kThreads) {
    const int r = e / D4, c = (e % D4) * 4;
    store4(qs + r * (D + 4) + c,
           q0 + r < S ? load4(qb + static_cast<long long>(q0 + r) * D + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f));
  }

  const int row = tid >> 2;               // this thread's query row
  const int sub = tid & 3;
  const int qpos = q0 + row;
  const float* qrow = qs + row * (D + 4);
  float* prow = ps + row * kPS;
  float m = kNeg, l = 0.0f;
  float4 acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the key tiles some query of this block can see
  const int q_last = min(S, q0 + kBQ) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo -= lo % kBK;

  for (int t0 = lo; t0 < hi; t0 += kBK) {
    __syncthreads();                      // the last tile's readers are done
    for (int e = tid; e < kBK * D4; e += kThreads) {
      const int j = e / D4, c = (e % D4) * 4;
      const bool in = t0 + j < Tk;
      const long long g = static_cast<long long>(t0 + j) * D + c;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(ks + j * (D + 4) + c, in ? load4(kb + g) : z);
      store4(vs + j * D + c, in ? load4(vb + g) : z);
    }
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) s[i] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
      const float4 qc = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
      for (int i = 0; i < kKeysPerThread; ++i) {
        const float4 kc = *reinterpret_cast<const float4*>(
            ks + (sub + 4 * i) * (D + 4) + c);
        s[i] += qc.x * kc.x + qc.y * kc.y + qc.z * kc.z + qc.w * kc.w;
      }
    }
    float mt = kNeg;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const int kpos = t0 + sub + 4 * i;
      bool ok = qpos < S && kpos < Tk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      s[i] = ok ? s[i] * scale : kNeg;
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.0f;
#pragma unroll
    for (int i = 0; i < kKeysPerThread; ++i) {
      const float p = expf(s[i] - m_new);
      ls += p;
      prow[sub + 4 * i] = p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * corr + ls;
    m = m_new;
    __syncwarp();                         // a row's four threads share a warp
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g].x *= corr;
      acc[g].y *= corr;
      acc[g].z *= corr;
      acc[g].w *= corr;
    }
    const float* vcol = vs + 4 * sub;
    for (int j = 0; j < kBK; j += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vcol + (j + jj) * D;
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * g);
          acc[g].x += pj[jj] * vv.x;
          acc[g].y += pj[jj] * vv.y;
          acc[g].z += pj[jj] * vv.z;
          acc[g].w += pj[jj] * vv.w;
        }
      }
    }
    __syncwarp();                         // prow is rewritten next tile
  }

  if (qpos < S) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * H + h) * S + qpos) * D +
              4 * sub;
#pragma unroll
    for (int g = 0; g < NG; ++g)
      store4(orow + 16 * g,
             make_float4(acc[g].x / denom, acc[g].y / denom,
                         acc[g].z / denom, acc[g].w / denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int Tk, int causal, int window,
           cudaStream_t s) {
  auto kern = flash_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(H), static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KV, S, Tk, causal,
      window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               int B, int H, int KV, int S, int Tk, int causal, int window,
               cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, KV, S, Tk, causal, window, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KV, S, Tk, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KV, S, Tk, causal, window,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, out, B, H, KV, S, Tk, causal, window,
                            s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike), every
// pointer 16-byte aligned.  d must be 32, 64, 128 or 256; H % KV == 0;
// T >= 1.  window <= 0 means no sliding
// window; causal != 0 masks keys after the query.  Returns
// cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KV, int S, int T,
                               int d, int causal, int window, int dtype,
                               void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, out, B, H, KV, S, T, causal, window,
                             s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, B, H, KV, S, T, causal,
                                     window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
