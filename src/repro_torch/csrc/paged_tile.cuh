// The paged attention tile body for Hopper (sm_90a), shared by
// ragged_attention.cu and paged_attention.cu: one block of 4 warps
// attends one work item — a tile of query tokens of one row, one KV head,
// one range of the row's visible K/V tiles — on the tensor cores.
//
// Contract of both kernels (the TPU kernels' scale order, repro/kernels/
// ragged_attention.py and paged_attention.py): s = (q.k) / sqrt(hd) *
// k_scale; masked keys at -1e30 with e = 0; l += sum(e) before
// e *= v_scale; acc += e . v; out = acc / max(l, 1e-30).  Pools are
// [N, bs, KV, hd] f32 | bf16 | int8 (+ k/v scales [N, bs, KV]), reached
// through a page-table row [P]; q and out are [slots, KV, G, hd].
//
// What bounds it on this card: on a prefill chunk, operations on the
// tensor cores — the tokens of a chunk read the same pages, so at phi4's
// 8 rows x 64 tokens there are ~59 f32 operations a byte, and each f32
// product costs 3 TF32 products (hi.hi + hi.lo + lo.hi, tf32_mma.cuh):
// 3 x operations / 495 TFLOP/s.  On a decode tick (one token a row) every
// key serves one token: bytes, at 3.35 TB/s.
//
// Design, and what each choice does about that:
// - MMA rows are (token, query head) pairs, row = token * G + g, so each
//   K/V tile serves every head and token of the item: a block holds
//   BT = 64 / G tokens (16 at gemma3's G = 4, 21 at phi4's G = 3), and
//   one page read feeds BT tokens instead of one.
// - S = Q.K^T and P.V on mma.sync.m16n8k8 TF32 with f32 accumulators, as
//   flash_attention.cu: f32 operands take the 3xTF32 split; bf16 and int8
//   values are exact in TF32 and take none (kSplitQ, kSplitKV below), so
//   bf16 x bf16 is 1 product for S, int8 pools with f32 q 2.
// - K/V tiles are BK consecutive key positions (32 at hd >= 128, 64
//   below; 2 or 4 pages of 16), each key row found through the page-table
//   row, which the block reads once into shared memory, and copied with
//   16-byte cp.async.cg into a double buffer: tile j + 1 loads while tile
//   j is multiplied.  bf16 and int8 are staged in their own type and
//   widened as fragments load.  Keys outside the item's visible range
//   are zero-filled by the copy (src-size 0).
// - k_scale multiplies S's columns, v_scale P's columns after l has
//   summed them.  Masks are applied only on tiles that cross a row's
//   position, its window's edge or the page table's end; tiles no row of
//   the item can see are never loaded.  A row that has seen no key yet
//   takes e = 0 on a fully masked tile (its max stays -1e30).
// - Two warp layouts over the same loop: with more than 16 live rows
//   (a prefill chunk) each warp owns 16 rows and every key of a tile;
//   with at most 16 (a decode token: G rows) the 4 warps share those rows
//   and each multiplies its own quarter of every tile's keys, then the
//   four online-softmax states merge through shared memory — a decode
//   token's work spreads over the block instead of one warp.
// - Pages split across blocks (grid z): a block takes a contiguous share
//   of the item's visible K/V tiles and, with more than one split, writes
//   its unnormalised (m, l, acc) to a workspace that merge_splits()
//   combines in a fixed order (M = max m_s, L = sum l_s e^(m_s - M),
//   out = sum acc_s e^(m_s - M) / max(L, 1e-30)): no atomics, so results
//   are the same run to run.  The launcher sizes the split count
//   (paged_attention.py::plan_page_splits); with one split the body
//   writes the output itself.
// TMA, wgmma and moving mixed_attention.cu onto this body are the next
// steps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace ptile {

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
constexpr int kRows = 16 * kWarps;       // MMA rows of a block
constexpr float kNeg = -1e30f;
constexpr size_t kMaxSmem = 232448;      // 227 KB a block may use

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared-memory geometry for q type QT, pool type KT at head width D
// (strides in elements; every row 16-byte aligned for cp.async and padded
// so fragment loads are free of bank conflicts, as in flash_attention.cu)
template <typename QT, typename KT, int D>
struct Geom {
  static constexpr bool kSplitQ = sizeof(QT) == 4;
  static constexpr bool kSplitKV = sizeof(KT) == 4;
  static constexpr bool kScaled = sizeof(KT) == 1;
  static constexpr int kBK = D <= 64 ? 64 : 32;
  static constexpr int kQS = D + 16 / static_cast<int>(sizeof(QT));
  static constexpr int kKS = D + 16 / static_cast<int>(sizeof(KT));
  static constexpr int kVS = D + (sizeof(KT) == 1 ? 16 : 8);
  static constexpr int kOS = D + 8;      // the decode layout's merge rows
  static constexpr size_t kQ = sizeof(QT) * kRows * kQS;
  static constexpr size_t kK = sizeof(KT) * kBK * kKS;
  static constexpr size_t kV = sizeof(KT) * kBK * kVS;
  static constexpr size_t kTiles = kQ + 2 * (kK + kV);
  // after the loop the decode layout reuses the tiles' space for its four
  // warps' (acc [16, D], m [16], l [16])
  static constexpr size_t kMerge = sizeof(float) * kWarps * 16 * (kOS + 2);
  static constexpr size_t kRegion = kTiles > kMerge ? kTiles : kMerge;
  static constexpr size_t kP = sizeof(float) * kWarps * 16 * (kBK + 4);
  static constexpr size_t kScales = sizeof(float) * 4 * kBK;
  static size_t smem(int P) {
    return kRegion + kP + kScales + sizeof(int) * ((P + 3) & ~3);
  }
  static_assert(kQ % 16 == 0 && kK % 16 == 0 && kV % 16 == 0 &&
                    kQS * sizeof(QT) % 16 == 0 &&
                    kKS * sizeof(KT) % 16 == 0 && kVS * sizeof(KT) % 16 == 0,
                "cp.async needs 16-byte aligned rows");
};

template <typename QT, typename KT>
struct Args {
  const QT* q;
  const KT* kp;
  const KT* vp;
  const float* ksc;         // int8 pools only
  const float* vsc;
  const int* pt;            // [rows, P]
  QT* out;
  float* ws_acc;            // [splits, slots, KV, G, D] when splits > 1
  float* ws_ml;             // [splits, slots, KV, G, 2]
  int slots, KV, G, P, bs, window, splits;
  float scale;
};

// One work item: ntok tokens of page-table row `row`, in q/out slots
// [slot0, slot0 + ntok), at positions [pos0, pos0 + ntok).
struct Item {
  int row, slot0, ntok, pos0;
};

// K/V rows of the BK keys from t0 into one buffer (and their scales),
// keys outside [lo_key, hi_key] zero-filled
template <typename KT, int D, int BK, int KS, int VS>
__device__ __forceinline__ void load_kv(KT* kd, KT* vd, float* kscd,
                                        float* vscd, const KT* kp,
                                        const KT* vp, const float* ksc,
                                        const float* vsc, const int* pt_s,
                                        int t0, int lo_key, int hi_key,
                                        int h, int KV, int bs) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(KT));
  constexpr int kCh = D / kPer;
  for (int e = threadIdx.x; e < BK * kCh; e += kThreads) {
    const int r = e / kCh, c = (e % kCh) * kPer;
    const int key = t0 + r;
    const bool in = key >= lo_key && key <= hi_key;
    long long off = 0;
    if (in) {
      const int pg = key / bs;
      off = ((static_cast<long long>(pt_s[pg]) * bs + (key - pg * bs)) * KV +
             h) * D + c;
    }
    cp16(kd + r * KS + c, kp + off, in);
    cp16(vd + r * VS + c, vp + off, in);
  }
  if constexpr (sizeof(KT) == 1) {
    for (int r = threadIdx.x; r < BK; r += kThreads) {
      const int key = t0 + r;
      float a = 0.0f, b = 0.0f;
      if (key >= lo_key && key <= hi_key) {
        const int pg = key / bs;
        const long long tok =
            (static_cast<long long>(pt_s[pg]) * bs + (key - pg * bs)) * KV + h;
        a = ksc[tok];
        b = vsc[tok];
      }
      kscd[r] = a;
      vscd[r] = b;
    }
  }
}

// q/out row of MMA row r of the item: ((slot * KV + h) * G + g)
__device__ __forceinline__ long long out_row(const Item& it, int r, int G,
                                             int KV, int h) {
  const int tk = r / G;
  return (static_cast<long long>(it.slot0 + tk) * KV + h) * G + (r - tk * G);
}

// The item's attention for KV head blockIdx.y over split blockIdx.z of its
// visible K/V tiles.  kKW = 1: each warp owns 16 rows and every key of a
// tile; kKW = 4: the warps share rows 0-15 and each takes a quarter of a
// tile's keys.  Every thread of the block calls it.
template <typename QT, typename KT, int D, int kKW>
__device__ __forceinline__ void attend(const Args<QT, KT>& a, const Item& it,
                                       char* smem) {
  using Gm = Geom<QT, KT, D>;
  constexpr int BK = Gm::kBK;
  constexpr int BKW = BK / kKW;   // keys of a tile one warp multiplies
  constexpr int NS = BKW / 8;     // key n-tiles of S
  constexpr int NA = NS >= 4 ? 1 : 4 / NS;   // S's partial sums
  constexpr int NO = D / 8;       // column n-tiles of O
  constexpr int NG = 4;           // O n-tiles multiplied together
  constexpr int PS = BKW + 4;     // P row stride
  QT* qs = reinterpret_cast<QT*>(smem);                       // [64][kQS]
  KT* ks = reinterpret_cast<KT*>(smem + Gm::kQ);              // [2][BK][kKS]
  KT* vs = reinterpret_cast<KT*>(smem + Gm::kQ + 2 * Gm::kK); // [2][BK][kVS]
  float* ps = reinterpret_cast<float*>(smem + Gm::kRegion);
  float* ksc_s = ps + kWarps * 16 * (BK + 4);                 // [2][BK]
  float* vsc_s = ksc_s + 2 * BK;                              // [2][BK]
  int* pt_s = reinterpret_cast<int*>(vsc_s + 2 * BK);         // [P]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, part = blockIdx.z;
  const int G = a.G, KV = a.KV, bs = a.bs, window = a.window;
  const int nlive = it.ntok * G;
  const int pbs = a.P * bs;

  const int* prow = a.pt + static_cast<long long>(it.row) * a.P;
  for (int i = tid; i < a.P; i += kThreads) pt_s[i] = prow[i];
  {
    constexpr int kPer = 16 / static_cast<int>(sizeof(QT));
    constexpr int kCh = D / kPer;
    constexpr int nq = kKW == 1 ? kRows : 16;
    for (int e = tid; e < nq * kCh; e += kThreads) {
      const int r = e / kCh, c = (e % kCh) * kPer;
      const bool in = r < nlive;
      const QT* src = in ? a.q + out_row(it, r, G, KV, h) * D + c : a.q;
      cp16(qs + r * Gm::kQS + c, src, in);
    }
  }

  // the item's visible keys, its K/V tiles, and this split's share
  const int first = it.pos0, last = it.pos0 + it.ntok - 1;
  const int lo_key = window > 0 ? max(0, first - window + 1) : 0;
  const int hi_key = min(last, pbs - 1);
  int j0 = 0, ntiles = 0;
  if (hi_key >= lo_key) {
    const int lo_t = lo_key / BK, n = hi_key / BK - lo_t + 1;
    const int per = (n + a.splits - 1) / a.splits;
    j0 = lo_t + part * per;
    ntiles = max(0, min(lo_t + n, j0 + per) - j0);
  }
  __syncthreads();                       // pt_s
  if (ntiles > 0)
    load_kv<KT, D, BK, Gm::kKS, Gm::kVS>(ks, vs, ksc_s, vsc_s, a.kp, a.vp,
                                         a.ksc, a.vsc, pt_s, j0 * BK,
                                         lo_key, hi_key, h, KV, bs);
  cp_commit();

  const int rg = kKW == 1 ? warp : 0;    // this warp's 16-row group
  const int kw = kKW == 1 ? 0 : warp;    // its key slice of every tile
  const int r0 = 16 * rg + g, r1 = r0 + 8;
  const int p0 = first + r0 / G, p1 = first + r1 / G;
  const bool live = 16 * rg < nlive;
  const int wp_first = first + (16 * rg) / G;
  const int wp_last = first + min(16 * rg + 15, nlive - 1) / G;
  float* pw = ps + warp * 16 * PS;

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.0f, l1 = 0.0f;  // rows r0, r1

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = (j0 + j) * BK;
    if (j + 1 < ntiles) {
      const int nb = (j + 1) & 1;
      load_kv<KT, D, BK, Gm::kKS, Gm::kVS>(
          ks + nb * BK * Gm::kKS, vs + nb * BK * Gm::kVS, ksc_s + nb * BK,
          vsc_s + nb * BK, a.kp, a.vp, a.ksc, a.vsc, pt_s, t0 + BK, lo_key,
          hi_key, h, KV, bs);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    const int wk0 = t0 + kw * BKW, wk1 = wk0 + BKW - 1;
    const bool sees = live && wk0 <= wp_last && wk0 < pbs &&
                      (window <= 0 || wk1 > wp_first - window);
    if (sees) {
      const int buf = j & 1;
      const KT* kt = ks + (buf * BK + kw * BKW) * Gm::kKS;
      const KT* vt = vs + (buf * BK + kw * BKW) * Gm::kVS;
      const float* kscale = ksc_s + buf * BK + kw * BKW;
      const float* vscale = vsc_s + buf * BK + kw * BKW;

      // S = Q . K^T for this warp's 16 rows and BKW keys, in NA partial
      // sums over alternating 8-wide depth steps, so that 4 accumulator
      // chains run side by side however few key n-tiles the warp has
      float s[NA][NS][4];
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
          s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
      const QT* qa = qs + (16 * rg + g) * Gm::kQS + t;
      const KT* kb = kt + g * Gm::kKS + t;
#pragma unroll 2
      for (int c0 = 0; c0 < D; c0 += 8 * NA) {
#pragma unroll
        for (int i = 0; i < NA; ++i) {
          const int c = c0 + 8 * i;
          uint32_t ah[4], al[4];
          load_a<Gm::kSplitQ>(qa + c, Gm::kQS, ah, al);
          uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const KT* p = kb + n * 8 * Gm::kKS + c;
            const float x0 = widen(p[0]), x1 = widen(p[4]);
            if constexpr (Gm::kSplitKV) {
              split(x0, bh[n][0], bl[n][0]);
              split(x1, bh[n][1], bl[n][1]);
            } else {
              bh[n][0] = __float_as_uint(x0);
              bh[n][1] = __float_as_uint(x1);
            }
          }
          if constexpr (Gm::kSplitQ) {
#pragma unroll
            for (int n = 0; n < NS; ++n)
              mma(s[i][n], al, bh[n][0], bh[n][1]);
          }
          if constexpr (Gm::kSplitKV) {
#pragma unroll
            for (int n = 0; n < NS; ++n)
              mma(s[i][n], ah, bl[n][0], bl[n][1]);
          }
#pragma unroll
          for (int n = 0; n < NS; ++n) mma(s[i][n], ah, bh[n][0], bh[n][1]);
        }
      }
#pragma unroll
      for (int i = 1; i < NA; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][n][e] += s[i][n][e];

      // scale (and k_scale), mask where the slice crosses a row's position,
      // its window's edge or the page table's end, online softmax step
      const bool masked = wk1 > wp_first ||
                          (window > 0 && wk0 <= wp_last - window) ||
                          wk1 >= pbs;
      float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * t + (e & 1);
          float x = s[0][n][e] * a.scale;
          if constexpr (Gm::kScaled) x *= kscale[col];
          if (masked) {
            const int key = wk0 + col;
            const int p = (e >> 1) ? p1 : p0;
            const bool ok = key <= p && key < pbs &&
                            (window <= 0 || key > p - window);
            x = ok ? x : kNeg;
          }
          s[0][n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[0][n][0], s[0][n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[0][n][2], s[0][n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      // a row whose keys are all masked so far keeps e = 0
      const float b0 = mn0 == kNeg ? 0.0f : mn0;
      const float b1 = mn1 == kNeg ? 0.0f : mn1;
      float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float e0 = expf(s[0][n][0] - b0), e1 = expf(s[0][n][1] - b0);
        float e2 = expf(s[0][n][2] - b1), e3 = expf(s[0][n][3] - b1);
        ls0 += e0 + e1;
        ls1 += e2 + e3;
        if constexpr (Gm::kScaled) {
          const float v0 = vscale[n * 8 + 2 * t];
          const float v1 = vscale[n * 8 + 2 * t + 1];
          e0 *= v0;
          e1 *= v1;
          e2 *= v0;
          e3 *= v1;
        }
        *reinterpret_cast<float2*>(pw + g * PS + n * 8 + 2 * t) =
            make_float2(e0, e1);
        *reinterpret_cast<float2*>(pw + (g + 8) * PS + n * 8 + 2 * t) =
            make_float2(e2, e3);
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

      // O += P . V, NG column n-tiles at a time
#pragma unroll
      for (int kk = 0; kk < BKW; kk += 8) {
        uint32_t ah[4], al[4];
        load_a<true>(pw + g * PS + kk + t, PS, ah, al);
        const KT* vr = vt + (kk + t) * Gm::kVS + g;
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += NG) {
          uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            const float x0 = widen(vr[(n0 + i) * 8]);
            const float x1 = widen(vr[4 * Gm::kVS + (n0 + i) * 8]);
            if constexpr (Gm::kSplitKV) {
              split(x0, bh[i][0], bl[i][0]);
              split(x1, bh[i][1], bl[i][1]);
            } else {
              bh[i][0] = __float_as_uint(x0);
              bh[i][1] = __float_as_uint(x1);
            }
          }
#pragma unroll
          for (int i = 0; i < NG; ++i) mma(o[n0 + i], al, bh[i][0], bh[i][1]);
          if constexpr (Gm::kSplitKV) {
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

  const long long rows_all = static_cast<long long>(a.slots) * KV * G;
  if constexpr (kKW == 1) {
    // each warp writes its own rows from the C fragments
    if (!live) return;
    const float i0 = 1.0f / fmaxf(l0, 1e-30f), i1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= nlive) continue;
      const long long orow = out_row(it, r, G, KV, h);
      if (a.splits == 1) {
        const float inv = half ? i1 : i0;
        QT* dst = a.out + orow * D + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          store2(dst + n * 8, o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
      } else {
        const long long wrow = part * rows_all + orow;
        float* dst = a.ws_acc + wrow * D + 2 * t;
#pragma unroll
        for (int n = 0; n < NO; ++n)
          store2(dst + n * 8, o[n][2 * half], o[n][2 * half + 1]);
        if (t == 0) {
          a.ws_ml[2 * wrow] = half ? m1 : m0;
          a.ws_ml[2 * wrow + 1] = half ? l1 : l0;
        }
      }
    }
  } else {
    // the four warps' states of rows 0-15 merge through shared memory
    __syncthreads();                      // every warp is done with the tiles
    constexpr int OS = Gm::kOS;
    float* os = reinterpret_cast<float*>(smem);     // [4][16][OS]
    float* ms = os + kWarps * 16 * OS;              // [4][16]
    float* lsum = ms + kWarps * 16;                 // [4][16]
    float* ow = os + warp * 16 * OS + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      store2(ow + g * OS + n * 8, o[n][0], o[n][1]);
      store2(ow + (g + 8) * OS + n * 8, o[n][2], o[n][3]);
    }
    if (t == 0) {
      ms[warp * 16 + g] = m0;
      ms[warp * 16 + g + 8] = m1;
      lsum[warp * 16 + g] = l0;
      lsum[warp * 16 + g + 8] = l1;
    }
    __syncthreads();
    for (int i = tid; i < nlive * D; i += kThreads) {
      const int r = i / D, col = i % D;
      float M = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ms[w * 16 + r]);
      float L = 0.0f, acc = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(ms[w * 16 + r] - M);
        L += lsum[w * 16 + r] * f;
        acc += os[(w * 16 + r) * OS + col] * f;
      }
      const long long orow = out_row(it, r, G, KV, h);
      if (a.splits == 1) {
        store1(a.out + orow * D + col, acc / fmaxf(L, 1e-30f));
      } else {
        const long long wrow = part * rows_all + orow;
        a.ws_acc[wrow * D + col] = acc;
        if (col == 0) {
          a.ws_ml[2 * wrow] = M;
          a.ws_ml[2 * wrow + 1] = L;
        }
      }
    }
  }
}

// The item in the layout its live rows need: the decode layout for at
// most 16 live rows, the prefill layout above.
template <typename QT, typename KT, int D>
__device__ __forceinline__ void attend_item(const Args<QT, KT>& a,
                                            const Item& it, char* smem) {
  if (it.ntok * a.G <= 16)
    attend<QT, KT, D, kWarps>(a, it, smem);
  else
    attend<QT, KT, D, 1>(a, it, smem);
}

// out row r < live_rows (of `rows` per split) from the splits' (m, l,
// acc) in split order; one thread per output element
template <typename QT>
__device__ __forceinline__ void merge_splits(const float* __restrict__ acc,
                                             const float* __restrict__ ml,
                                             QT* __restrict__ out,
                                             long long rows,
                                             long long live_rows, int D,
                                             int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= live_rows * D) return;
  const long long r = i / D;
  float M = kNeg;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[2 * (s * rows + r)]);
  float L = 0.0f, a = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float f = expf(ml[2 * (s * rows + r)] - M);
    L += ml[2 * (s * rows + r) + 1] * f;
    a += acc[s * rows * D + i] * f;
  }
  store1(out + i, a / fmaxf(L, 1e-30f));
}

constexpr int kMergeThreads = 256;

inline unsigned merge_blocks(long long rows, int D) {
  return static_cast<unsigned>((rows * D + kMergeThreads - 1) /
                               kMergeThreads);
}

// f(QT{}, KT{}, std::integral_constant<int, D>{}) for the runtime q and
// pool dtypes (0 f32, 1 bf16; pools also 2 int8) and head width
template <typename QT, typename KT, typename F>
int by_hd(int hd, F& f) {
  switch (hd) {
    case 32: return f(QT{}, KT{}, std::integral_constant<int, 32>{});
    case 64: return f(QT{}, KT{}, std::integral_constant<int, 64>{});
    case 128: return f(QT{}, KT{}, std::integral_constant<int, 128>{});
    case 256: return f(QT{}, KT{}, std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename QT, typename F>
int by_kv(int kv_dtype, int hd, F& f) {
  switch (kv_dtype) {
    case 0: return by_hd<QT, float>(hd, f);
    case 1: return by_hd<QT, __nv_bfloat16>(hd, f);
    case 2: return by_hd<QT, int8_t>(hd, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F>
int dispatch(int q_dtype, int kv_dtype, int hd, F f) {
  if (q_dtype == 0) return by_kv<float>(kv_dtype, hd, f);
  if (q_dtype == 1) return by_kv<__nv_bfloat16>(kv_dtype, hd, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Set the kernel's shared-memory limit and check the block fits.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ptile
