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

}  // namespace omt
