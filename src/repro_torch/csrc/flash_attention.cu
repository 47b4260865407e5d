// Dense flash attention for Hopper (sm_90a): causal / sliding-window GQA
// on the tensor cores.
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
// What bounds it on this card: operations on the tensor cores.  A
// (query, key) pair costs 4d operations per query head against 2d
// key/value elements read once per KV head, so at the prefill's
// S = T = 640 the work sits far above the ridge.  f32 is held to f32
// accuracy by 3xTF32 (tf32_mma.cuh): each operand x splits into two TF32
// values, hi and lo = x - hi rounded, and a product is hi.hi + hi.lo +
// lo.hi (lo.lo, about 2^-22 of it, is dropped), so an f32 product costs 3
// TF32 MMAs: the bound is 3 x operations / 495 TFLOP/s.  A bf16 value is exact in TF32,
// so bf16 takes 1 product for Q.K^T and 2 for P.V (P is f32).
//
// Design (FlashAttention-2's tiling on Ampere's warp-level MMA,
// mma.sync.m16n8k8 tf32 with f32 accumulators):
// - One block of 4 warps owns 64 query rows of one head; each warp owns
//   16 of them and holds their S = Q.K^T strip (16 x BK) and their output
//   (16 x d, d/2 registers a thread) in MMA accumulators.  A row's max and
//   sum merge across the 4 lanes that share it in the C fragment with two
//   shuffles.
// - The C fragment is not the A fragment's layout, so P goes through a
//   16 x BK f32 tile in shared memory that its warp alone writes and reads
//   (__syncwarp).
// - Q stays resident in shared memory; K and V tiles are double-buffered
//   with 16-byte cp.async.cg copies, so tile j+1 loads while tile j is
//   multiplied.  Rows past S or T are zero-filled by the copy's src-size
//   operand (the source clamped to a valid row).  bf16 tiles are staged as
//   bf16 (half the bytes) and widened as fragments are loaded.
// - Rows are padded so fragment loads are free of bank conflicts: Q and K
//   rows by 4 floats (lanes (g, t) of an A or B load hit bank 4g + t), V
//   rows by 8 floats (lanes read V[t][g]: bank 8t + g), P rows by 4
//   floats; bf16 rows by 8 elements (conflict-free too, two lanes to a
//   word).
// - Tiles: BK = 32 keys at d >= 128 (d = 256 f32: Q 65 KB + two K and two
//   V buffers 131 KB + P 9 KB = 205 KB, 1 block per SM; d = 128: 109 KB,
//   2 blocks per SM), BK = 64 at d <= 64.  At d = 256 each thread holds
//   128 output accumulators; __launch_bounds__(128, 1) leaves it up to
//   255 registers.
// - blockIdx.x walks the q tiles from the last (the longest under a
//   causal mask) to the first, every (head, batch row) of a tile before
//   the next tile.  Key tiles no query of the block can see are skipped;
//   a warp skips the MMAs of a tile none of its rows can see; the masks
//   are applied only on tiles that cross the diagonal, the window's edge
//   or T.  A row that sees no key of a tile it computes keeps m = -1e30
//   there, and the next tile's correction exp(m - m_new) wipes that
//   tile's sum.
// TMA, wgmma and warp specialisation are the next step for this kernel.
#include <limits.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

using tf32::cp16;
using tf32::cp_commit;
using tf32::cp_wait;
using tf32::load_a;
using tf32::mma;
using tf32::split;
using tf32::store2;
using tf32::widen;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;    // queries per block, 16 per warp
constexpr float kNeg = -1e30f;

// shared-memory geometry for element type T at head width D (strides in
// elements of T, the P tile's in floats)
template <typename T, int D>
struct Tiles {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBK = D <= 64 ? 64 : 32;
  static constexpr int kQK = D + (kF32 ? 4 : 8);   // Q and K row stride
  static constexpr int kVS = D + 8;                // V row stride
  static constexpr int kPS = kBK + 4;              // P row stride
  static constexpr size_t kQ = sizeof(T) * kBQ * kQK;
  static constexpr size_t kK = sizeof(T) * kBK * kQK;
  static constexpr size_t kV = sizeof(T) * kBK * kVS;
  static constexpr size_t kP = sizeof(float) * 16 * kPS;
  static constexpr size_t kSmem = kQ + 2 * (kK + kV) + kWarps * kP;
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  static_assert(kQ % 16 == 0 && kK % 16 == 0 && kV % 16 == 0 &&
                    kQK * sizeof(T) % 16 == 0 && kVS * sizeof(T) % 16 == 0,
                "cp.async needs 16-byte aligned rows");
};

// rows [row0, row0 + ROWS) of a [n, D] head into a shared tile of row
// stride STRIDE, rows at or past n zero-filled
template <typename T, int D, int ROWS, int STRIDE>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0,
                                          int n) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = D / kPer;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * kPer;
    const int gr = row0 + r;
    cp16(dst + r * STRIDE + c,
         src + static_cast<long long>(min(gr, n - 1)) * D + c, gr < n);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D >= 256 ? 1 : 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int B, int H,
             int KV, int S, int Tk, int causal, int window, float scale) {
  using G = Tiles<T, D>;
  constexpr int BK = G::kBK;
  constexpr int NS = BK / 8;      // key n-tiles of S
  constexpr int NO = D / 8;       // column n-tiles of O
  constexpr int NG = NO % 4 == 0 ? 4 : 2;   // O n-tiles multiplied together
  static_assert(NO % NG == 0, "D / 8 must be even");
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);             // [kBQ][kQK]
  T* ks = qs + kBQ * G::kQK;                       // [2][BK][kQK]
  T* vs = ks + 2 * BK * G::kQK;                    // [2][BK][kVS]
  float* ps = reinterpret_cast<float*>(vs + 2 * BK * G::kVS);

  const int nq = (S + kBQ - 1) / kBQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x) / (H * B)) * kBQ;
  const int h = hb % H, b = hb / H;
  const int kvh = h / (H / KV);
  const T* qb = q + (static_cast<long long>(b) * H + h) * S * D;
  const T* kb = k + (static_cast<long long>(b) * KV + kvh) * Tk * D;
  const T* vb = v + (static_cast<long long>(b) * KV + kvh) * Tk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;          // this warp's first query
  const int w_last = min(S, wq0 + 16) - 1;
  float* pw = ps + warp * 16 * G::kPS;     // this warp's P tile

  // the key tiles some query of this block can see
  const int q_last = min(S, q0 + kBQ) - 1;
  const int hi = causal ? min(Tk, q_last + 1) : Tk;
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo -= lo % BK;
  const int ntiles = lo < hi ? (hi - lo + BK - 1) / BK : 0;

  load_rows<T, D, kBQ, G::kQK>(qs, qb, q0, S);
  if (ntiles > 0) {
    load_rows<T, D, BK, G::kQK>(ks, kb, lo, Tk);
    load_rows<T, D, BK, G::kVS>(vs, vb, lo, Tk);
  }
  cp_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;  // rows g, g + 8

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = lo + j * BK;
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_rows<T, D, BK, G::kQK>(ks + nb * BK * G::kQK, kb, t0 + BK, Tk);
      load_rows<T, D, BK, G::kVS>(vs + nb * BK * G::kVS, vb, t0 + BK, Tk);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const bool sees = wq0 < S && (!causal || t0 <= w_last) &&
                      (window <= 0 || t0 + BK - 1 > wq0 - window);
    if (sees) {
      const T* kt = ks + (j & 1) * BK * G::kQK;
      const T* vt = vs + (j & 1) * BK * G::kVS;

      // S = Q . K^T for this warp's 16 rows
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const T* qa = qs + (16 * warp + g) * G::kQK + t;
      const T* kbf = kt + g * G::kQK + t;
#pragma unroll 2
      for (int c = 0; c < D; c += 8) {
        uint32_t ah[4], al[4];
        load_a<G::kF32>(qa + c, G::kQK, ah, al);
        uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const T* p = kbf + n * 8 * G::kQK + c;
          const float x0 = widen(p[0]), x1 = widen(p[4]);
          if constexpr (G::kF32) {
            split(x0, bh[n][0], bl[n][0]);
            split(x1, bh[n][1], bl[n][1]);
          } else {
            bh[n][0] = __float_as_uint(x0);
            bh[n][1] = __float_as_uint(x1);
          }
        }
        if constexpr (G::kF32) {
#pragma unroll
          for (int n = 0; n < NS; ++n) mma(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
          for (int n = 0; n < NS; ++n) mma(s[n], ah, bl[n][0], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) mma(s[n], ah, bh[n][0], bh[n][1]);
      }

      // scale, mask where the tile crosses the diagonal, the window's
      // edge or T, and take the online softmax step
      const bool masked = (causal && t0 + BK - 1 > wq0) ||
                          (window > 0 && t0 <= w_last - window) ||
                          t0 + BK > Tk;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale;
          if (masked) {
            const int kpos = t0 + n * 8 + 2 * t + (e & 1);
            const int qpos = wq0 + g + (e >> 1) * 8;
            const bool ok = kpos < Tk && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            x = ok ? x : kNeg;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float p0 = expf(s[n][0] - mn0), p1 = expf(s[n][1] - mn0);
        const float p2 = expf(s[n][2] - mn1), p3 = expf(s[n][3] - mn1);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        *reinterpret_cast<float2*>(pw + g * G::kPS + n * 8 + 2 * t) =
            make_float2(p0, p1);
        *reinterpret_cast<float2*>(pw + (g + 8) * G::kPS + n * 8 + 2 * t) =
            make_float2(p2, p3);
      }
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
      ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
      ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      __syncwarp();                       // P is written

      // O += P . V, NG column n-tiles at a time so that consecutive MMAs
      // feed different accumulators
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ah[4], al[4];
        load_a<true>(pw + g * G::kPS + kk + t, G::kPS, ah, al);
        const T* vr = vt + (kk + t) * G::kVS + g;
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const float x0 = widen(vr[(n0 + i) * 8]);
            const float x1 = widen(vr[4 * G::kVS + (n0 + i) * 8]);
            if constexpr (G::kF32) {
              split(x0, bh[i][0], bl[i][0]);
              split(x1, bh[i][1], bl[i][1]);
            } else {
              bh[i][0] = __float_as_uint(x0);
              bh[i][1] = __float_as_uint(x1);
            }
          }
#pragma unroll
          for (int i = 0; i < NG; ++i) mma(o[n0 + i], al, bh[i][0], bh[i][1]);
          if constexpr (G::kF32) {
#pragma unroll
            for (int i = 0; i < NG; ++i)
              mma(o[n0 + i], ah, bl[i][0], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < NG; ++i) mma(o[n0 + i], ah, bh[i][0], bh[i][1]);
        }
      }
      __syncwarp();                       // P is rewritten next tile
    }
    __syncthreads();                      // buffer j & 1 is refilled next
  }
  cp_wait<0>();

  const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
  const int r0 = wq0 + g, r1 = wq0 + g + 8;
  T* ob = out + (static_cast<long long>(b) * H + h) * S * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (r0 < S)
      store2(ob + static_cast<long long>(r0) * D + n * 8, o[n][0] * i0,
             o[n][1] * i0);
    if (r1 < S)
      store2(ob + static_cast<long long>(r1) * D + n * 8, o[n][2] * i1,
             o[n][3] * i1);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, int Tk, int causal, int window,
           cudaStream_t s) {
  auto kern = flash_kernel<T, D>;
  const size_t smem = Tiles<T, D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks =
      static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), B, H, KV, S, Tk,
      causal, window, 1.0f / sqrtf(static_cast<float>(D)));
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
    case 112:
      return launch<T, 112>(q, k, v, out, B, H, KV, S, Tk, causal, window,
                            s);
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
// pointer 16-byte aligned.  d must be 32, 64, 112, 128 or 256; H % KV == 0;
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
