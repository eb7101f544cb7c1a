// Check of the K2 int8 tile kernel's requantize arithmetic (tools/ablation.py
// k2-q8): for every fp32 a with |a| <= 128 b, at each divisor b given, the
// tile kernel's q8_round(q8_div(a, -b, q8_recip(b))) against the parent
// kernel's __float2int_rn(a / b), low byte against low byte. Built with
// -I omnimamba_tpu_torch/csrc so that the helpers are the shipped ones.
#include "ssd_step.cu"

namespace {

__global__ void q8_div_check_kernel(const float* __restrict__ bs,
                                    unsigned long long* __restrict__ bad,
                                    unsigned int* __restrict__ first) {
  const float b = bs[blockIdx.y];
  const float rb = omt::q8_recip(b);
  const uint32_t top = __float_as_uint(128.0f * b);  // every magnitude up to 128 b
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u <= top; u += gridDim.x * blockDim.x) {
#pragma unroll
    for (uint32_t sign = 0; sign < 2; ++sign) {
      const float a = __uint_as_float(u | (sign << 31));
      const uint32_t fast = omt::q8_round(omt::q8_div(a, -b, rb)) & 0xffu;
      const uint32_t ref = static_cast<uint32_t>(__float2int_rn(a / b)) & 0xffu;
      if (fast != ref && atomicAdd(bad + blockIdx.y, 1ull) == 0) first[blockIdx.y] = __float_as_uint(a);
    }
  }
}

}  // namespace

// bad[i] counts the a that disagree at bs[i], first[i] holds the bits of one
// of them; both zeroed by the caller. Returns the cudaError_t of the launch.
extern "C" int omt_q8_div_check(const float* bs, int nb, unsigned long long* bad,
                                unsigned int* first, void* stream) {
  q8_div_check_kernel<<<dim3(1024, nb), 256, 0, static_cast<cudaStream_t>(stream)>>>(bs, bad, first);
  return static_cast<int>(cudaGetLastError());
}
