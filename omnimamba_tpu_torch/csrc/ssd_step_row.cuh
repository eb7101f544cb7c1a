// One row of the one-token SSM update, shared by the step kernel
// (ssd_step.cu) and the whole-model decode step (decode_fused.cu), so the
// update exists once:
//
//   s'[n] = s[n] * decay + dtx * B[n]      (stored in place, rounded to ST)
//   returns sum_n s'[n] * C[n]             (from the unrounded s')
//
// One warp walks the N elements of the row, a lane holding 4 consecutive n
// per access (16 bytes of an fp32 state, 8 of a bf16 one), and reduces over n
// with shuffles; every lane returns the sum. `row` must be aligned to the
// access size and N a multiple of 4. Bs and Cs hold N floats each, 16-byte
// aligned (shared memory).
#pragma once

#include "common.cuh"

namespace omt {

template <typename ST>
__device__ __forceinline__ float ssd_step_row(ST* __restrict__ row, const float* __restrict__ Bs,
                                              const float* __restrict__ Cs, float decay,
                                              float dtx, int N, int lane) {
  float acc = 0.0f;
  for (int n = lane * 4; n < N; n += 128) {
    float4 s = load4(row + n);
    const float4 bq = load4(Bs + n);
    const float4 cq = load4(Cs + n);
    s.x = s.x * decay + dtx * bq.x;
    s.y = s.y * decay + dtx * bq.y;
    s.z = s.z * decay + dtx * bq.z;
    s.w = s.w * decay + dtx * bq.w;
    acc += s.x * cq.x + s.y * cq.y + s.z * cq.z + s.w * cq.w;
    store4(row + n, s);
  }
  return warp_sum(acc);
}

// The same update on a scaled-int8 row (`q` int8 with one fp32 `scale`, the
// value being q * scale), for N <= 128 * kQ8Chunks: every lane keeps its
// part of s' in registers, y is summed from the unrounded s', then the row is
// requantized in place with a new scale amax|s'| / 127 + 1e-20 and
// round-half-to-even (as jnp.round), the JAX package's quantize_ssm_state.
constexpr int kQ8Chunks = 4;

__device__ __forceinline__ float ssd_step_row_q8(int8_t* __restrict__ q, float* __restrict__ scale,
                                                 const float* __restrict__ Bs,
                                                 const float* __restrict__ Cs, float decay,
                                                 float dtx, int N, int lane) {
  const float old = *scale;
  float4 s[kQ8Chunks];
  float acc = 0.0f, amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kQ8Chunks; ++j) {
    const int n = lane * 4 + 128 * j;
    if (n >= N) break;
    const char4 c = *reinterpret_cast<const char4*>(q + n);
    const float4 bq = load4(Bs + n);
    const float4 cq = load4(Cs + n);
    float4 v = make_float4(static_cast<float>(c.x) * old, static_cast<float>(c.y) * old,
                           static_cast<float>(c.z) * old, static_cast<float>(c.w) * old);
    v.x = v.x * decay + dtx * bq.x;
    v.y = v.y * decay + dtx * bq.y;
    v.z = v.z * decay + dtx * bq.z;
    v.w = v.w * decay + dtx * bq.w;
    acc += v.x * cq.x + v.y * cq.y + v.z * cq.z + v.w * cq.w;
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    s[j] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float ns = amax / 127.0f + 1e-20f;
#pragma unroll
  for (int j = 0; j < kQ8Chunks; ++j) {
    const int n = lane * 4 + 128 * j;
    if (n >= N) break;
    char4 c;
    c.x = static_cast<signed char>(__float2int_rn(s[j].x / ns));
    c.y = static_cast<signed char>(__float2int_rn(s[j].y / ns));
    c.z = static_cast<signed char>(__float2int_rn(s[j].z / ns));
    c.w = static_cast<signed char>(__float2int_rn(s[j].w / ns));
    *reinterpret_cast<char4*>(q + n) = c;
  }
  __syncwarp();  // every lane has read the old scale
  if (lane == 0) *scale = ns;
  return warp_sum(acc);
}

}  // namespace omt
