// Tensor-core helpers shared by flash_attention.cu and paged_tile.cuh:
// the 3xTF32 split of an f32 value, the mma.sync.m16n8k8 TF32 product,
// 16-byte cp.async copies (rwkv6_scan.cu uses these too), and the
// A-fragment load of a 16 x 8 tile.
//
// 3xTF32: each f32 operand x splits into two TF32 values, hi and lo =
// x - hi rounded (split() below), and a product is hi.hi + hi.lo + lo.hi
// (lo.lo, about 2^-22 of it, is dropped), which keeps f32 accuracy on the
// TF32 tensor cores.  A bf16 or int8 value (|x| <= 127) is exact in TF32
// and needs no lo term.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// x = hi + lo in two TF32 values, both rounded to nearest.  hi is
// Veltkamp's split at 13 bits (c = x * (2^13 + 1), hi = c - (c - x): the
// top 11 significant bits, in plain f32 operations that keep a NaN a NaN,
// which cvt.rna.tf32.f32 does too but in a longer sequence on sm_90a);
// lo = x - hi is exact and finite unless x is not, and is rounded on its
// bits (ties away from zero).  The _rn intrinsics keep the compiler from
// fusing the split into an FMA.  |x| must stay below 4e34.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = (__float_as_uint(__fsub_rn(x, h)) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c += a . b over one 16 x 8 x 8 tile
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; zeros when !in (src-size 0)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A fragment of a 16 x 8 row-major tile at p (row stride ld) for lane
// (g, t): rows g and g + 8, columns t and t + 4; hi and lo terms
template <bool kSplit, typename E>
__device__ __forceinline__ void load_a(const E* p, int ld, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float x[4] = {widen(p[0]), widen(p[8 * ld]), widen(p[4]),
                      widen(p[8 * ld + 4])};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kSplit) {
      split(x[i], hi[i], lo[i]);
    } else {
      hi[i] = __float_as_uint(x[i]);
    }
  }
}

}  // namespace tf32
