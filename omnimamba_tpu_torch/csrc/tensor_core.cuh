// Helpers of the hand-written tensor-core kernels (K1's and K5's bf16
// paths, K7, K4's products): cp.async copies, ldmatrix, mma.sync m16n8k16 on
// bf16 operands with fp32 sums, bf16 packing, int8 widened to bf16, and the
// choice among the tile shapes K1 and K5 are built for.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace omt {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 8 (or 4) bytes global -> shared; with ok false the bytes are zeros
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {  // all but the newest N groups have landed
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(saddr(p)) : "memory");
}
__device__ __forceinline__ void ldsm2t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(saddr(p)) : "memory");
}
// d += a (16 x 16) b (16 x 8), bf16 operands, fp32 sums (HMMA.16816.F32.BF16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {  // round to bf16, lo in the low half
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float lo16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// four int8 values (low byte first) as four bf16, exactly: byte v + 128 under
// the exponent of 2^23 is the fp32 2^23 + 128 + v, minus 2^23 + 128 gives v; an
// integer of magnitude <= 128 has zero low 16 bits in fp32, so its high half
// is its bf16
__device__ __forceinline__ void widen4(uint32_t v, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = v ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// ldmatrix .x4 addresses for lane l of a 16 x 16 tile at `base` (row stride `ld`),
// its four 8 x 8 matrices taken down the first eight columns, then down the
// second: an A operand (m, k) from (m, k) storage, or a pair of n8 B operands
// (k, n) from (k, n) storage with .trans
__device__ __forceinline__ const bf16* quads_down(const bf16* base, int ld, int l) {
  return base + (l & 15) * ld + (l >> 4) * 8;
}
// ... taken across the first eight rows, then across the second: an A operand
// (m, k) from (k, m) storage with .trans, or a pair of n8 B operands (k, n)
// from (n, k) storage
__device__ __forceinline__ const bf16* quads_across(const bf16* base, int ld, int l) {
  return base + ((l & 7) + (l >> 4) * 8) * ld + ((l >> 3) & 1) * 8;
}

// Calls f with the first tile shape (kPM, kNM) of `Tiles` that holds head dim
// P and state dim N, as a Tiles<kPM, kNM>{}, and returns true; false if none
// does. P is zero-padded to kPM and N to kNM, and rows are copied in pieces
// of four bf16, so P must be a multiple of 4.
template <template <int, int> class Tiles, class F>
bool with_tiles(int P, int N, F&& f) {
  if (P % 4 != 0) return false;
  if (P <= 64 && N <= 128)
    f(Tiles<64, 128>{});
  else if (P <= 128 && N <= 128)
    f(Tiles<128, 128>{});
  else if (P <= 64 && N <= 256)
    f(Tiles<64, 256>{});
  else
    return false;
  return true;
}

}  // namespace tc
}  // namespace omt
