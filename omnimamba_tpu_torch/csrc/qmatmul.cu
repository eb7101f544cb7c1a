// int8 weight-only matrix product (K7):
//
//   out[m, o] = (sum_k x[m, k] * q[k, o]) * s[o]      q: (K, O)    layout of a linear kernel
//   out[m, o] = (sum_k x[m, k] * q[o, k]) * s[o]      q: (O, K)    the weight-tied head's table
//
// x is fp32 or bf16, q int8, s fp32 (one scale per output channel); the sums
// are fp32, the scale multiplies the accumulator, the result is cast to the
// output type. Replaces the TPU kernel `_qmm_kernel` / `qmatmul_pallas` of
// omnimamba_tpu/ops/quant_pallas.py.
//
// What bounds it on an H100: at decode (tens of rows) the weight bytes, which
// int8 halves against bf16 (the 1.3B head's 16384 x 2048 table is 33.6 MB: 10 us
// at 3.35 TB/s); at prefill (thousands of rows) the operations (a 3456-row
// in_proj is 120 GFLOP: 0.12 ms of bf16 tensor-core time). The design is K4's
// bf16 product (decode_fused.cu) with the weight tile landing as int8:
//   - bf16 activations on whole tiles (K and O multiples of 64, 16-byte aligned
//     rows): a block of 8 warps takes MT * 16 rows x 64 columns; the int8 weight
//     tile (64 x 64, 4 KB, half of K4's bf16 stage) and the activation tile of
//     each k step are copied into a four-stage ring with 16-byte cp.async, three
//     k steps ahead. wmma has no int8 x bf16 product, so each landed weight tile
//     is widened to bf16 in shared memory (exact: |q| <= 127) behind one
//     __syncthreads, then warp w multiplies columns 16 (w % 4) .. + 15 over the
//     k half w / 4 (m16n16k16, fp32 sums); the two halves are added, lower k
//     first. The transposed table needs no transposed copy: its (O, K) tile is
//     loaded as a column-major matrix_b.
//   - fp32 activations, and edges that are not whole tiles (O = 139, K = 24,
//     any M), take fp32 multiply-adds over shared-memory tiles.
// In both, a row's sum over k runs in an order that does not depend on M, so a
// row gives the same bits in any batch.
#include <cuda_pipeline.h>
#include <mma.h>

#include "common.cuh"

namespace omt {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// tensor-core path: bf16 activations, whole tiles
// ---------------------------------------------------------------------------

constexpr int kQThreads = 256, kQBN = 64, kQBK = 64, kQStages = 4;
constexpr int kQLdQ = kQBK + 16;  // bytes of an int8 tile row in a stage: rows stay 16-byte aligned
constexpr int kQLdB = kQBN + 8;   // bf16 elements of a widened tile row
constexpr int kQLdA = kQBK + 8;   // bf16 elements of an activation tile row
constexpr int kQLdC = kQBN + 4;   // floats
static_assert(kQThreads == 64 * 4, "one 16-byte chunk of the int8 tile per thread");

template <int MT>
struct QTile {
  static constexpr int kWBytes = 64 * kQLdQ;
  static constexpr int kStageBytes = kWBytes + MT * 16 * kQLdA * 2;
  static constexpr int kWideOffset = kQStages * kStageBytes;
  static constexpr int kPipeBytes = kWideOffset + 64 * kQLdB * 2;
  static constexpr int kCHalf = MT * 16 * kQLdC;  // floats: C of one k half
  static constexpr int kBytes = kPipeBytes > 2 * kCHalf * 4 ? kPipeBytes : 2 * kCHalf * 4;
  static_assert(kWBytes % 32 == 0 && kStageBytes % 32 == 0, "wmma needs 32-byte alignment");
};

// The int8 weight tile at (k0, n0) and the activation rows m0 .. m0 + MT*16 - 1
// at k0 into one stage. Rows past M are read from row M - 1 and never written.
template <int MT, bool TRANS>
__device__ __forceinline__ void qmm_copy_tile(const bf16* __restrict__ x,
                                              const int8_t* __restrict__ q, int M, int K, int O,
                                              int m0, int n0, int k0, unsigned char* stage) {
  const int tid = threadIdx.x;
  {
    const int row = tid >> 2, ch = (tid & 3) * 16;  // row: k for (K, O), o for (O, K)
    const int8_t* src = TRANS ? q + static_cast<size_t>(n0 + row) * K + k0 + ch
                              : q + static_cast<size_t>(k0 + row) * O + n0 + ch;
    __pipeline_memcpy_async(stage + row * kQLdQ + ch, src, 16);
  }
  bf16* As = reinterpret_cast<bf16*>(stage + QTile<MT>::kWBytes);
#pragma unroll
  for (int c = tid; c < MT * 16 * (kQBK / 8); c += kQThreads) {
    const int row = c / (kQBK / 8), ch = (c % (kQBK / 8)) * 8;
    __pipeline_memcpy_async(As + row * kQLdA + ch,
                            x + static_cast<size_t>(min(m0 + row, M - 1)) * K + k0 + ch, 16);
  }
}

// the landed int8 tile of `stage`, widened to bf16 in `wide` (same row order)
__device__ __forceinline__ void qmm_widen(const unsigned char* stage, bf16* wide) {
  const int row = threadIdx.x >> 2, c16 = (threadIdx.x & 3) * 16;
  const int4 raw = *reinterpret_cast<const int4*>(stage + row * kQLdQ + c16);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) bf16 v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = __float2bfloat16_rn(static_cast<float>(b[i]));
  uint4* dst = reinterpret_cast<uint4*>(wide + row * kQLdB + c16);
  dst[0] = reinterpret_cast<const uint4*>(v)[0];
  dst[1] = reinterpret_cast<const uint4*>(v)[1];
}

template <int MT, bool TRANS, typename OT>
__global__ void __launch_bounds__(kQThreads)
qmm_tc_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, OT* __restrict__ out, int M, int K, int O) {
  extern __shared__ __align__(128) unsigned char qsmem[];
  namespace wmma = nvcuda::wmma;
  using Tile = QTile<MT>;
  const int n0 = blockIdx.x * kQBN;
  const int m0 = blockIdx.y * MT * 16;
  const int warp_n = (threadIdx.x >> 5) & 3;
  const int warp_k = threadIdx.x >> 7;
  const int ntiles = K / kQBK;
  bf16* wide = reinterpret_cast<bf16*>(qsmem + Tile::kWideOffset);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int t = 0; t < kQStages - 1; ++t) {
    if (t < ntiles)
      qmm_copy_tile<MT, TRANS>(x, q, M, K, O, m0, n0, t * kQBK, qsmem + t * Tile::kStageBytes);
    __pipeline_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    __pipeline_wait_prior(kQStages - 2);  // this thread's copies of tile t have landed
    __syncthreads();  // everyone's have, and everyone is done with tile t - 1 and `wide`
    const int ahead = t + kQStages - 1;  // goes into the stage tile t - 1 used
    if (ahead < ntiles)
      qmm_copy_tile<MT, TRANS>(x, q, M, K, O, m0, n0, ahead * kQBK,
                               qsmem + (ahead % kQStages) * Tile::kStageBytes);
    __pipeline_commit();

    const unsigned char* stage = qsmem + (t % kQStages) * Tile::kStageBytes;
    qmm_widen(stage, wide);
    __syncthreads();
    const bf16* As = reinterpret_cast<const bf16*>(stage + Tile::kWBytes);
#pragma unroll
    for (int k16 = 0; k16 < kQBK / 2; k16 += 16) {
      const int kk = warp_k * (kQBK / 2) + k16;
      if constexpr (TRANS) {
        // wide holds [o][k]: element (k, o) at o * ld + k, a column-major B
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, wide + warp_n * 16 * kQLdB + kk, kQLdB);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, As + i * 16 * kQLdA + kk, kQLdA);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, wide + kk * kQLdB + warp_n * 16, kQLdB);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, As + i * 16 * kQLdA + kk, kQLdA);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();  // the ring is free: reuse it for C
  float* Cs = reinterpret_cast<float*>(qsmem) + warp_k * Tile::kCHalf;
#pragma unroll
  for (int i = 0; i < MT; ++i)
    wmma::store_matrix_sync(Cs + i * 16 * kQLdC + warp_n * 16, acc[i], kQLdC, wmma::mem_row_major);
  __syncthreads();

  const float* C0 = reinterpret_cast<const float*>(qsmem);
  for (int e = threadIdx.x; e < MT * 16 * (kQBN / 4); e += kQThreads) {
    const int row = e / (kQBN / 4), c4 = (e % (kQBN / 4)) * 4;
    if (m0 + row >= M) continue;
    const float4 lo = load4(C0 + row * kQLdC + c4);
    const float4 hi = load4(C0 + Tile::kCHalf + row * kQLdC + c4);
    const float4 sc = load4(s + n0 + c4);
    store4(out + static_cast<size_t>(m0 + row) * O + n0 + c4,
           make_float4((lo.x + hi.x) * sc.x, (lo.y + hi.y) * sc.y, (lo.z + hi.z) * sc.z,
                       (lo.w + hi.w) * sc.w));
  }
}

template <int MT, bool TRANS, typename OT>
cudaError_t launch_qmm_tc(const void* x, const int8_t* q, const float* s, void* out, int M, int K,
                          int O, cudaStream_t stream) {
  const size_t smem = QTile<MT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(qmm_tc_kernel<MT, TRANS, OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(O / kQBN, (M + MT * 16 - 1) / (MT * 16));
  qmm_tc_kernel<MT, TRANS, OT><<<grid, kQThreads, smem, stream>>>(
      static_cast<const bf16*>(x), q, s, static_cast<OT*>(out), M, K, O);
  return cudaGetLastError();
}

// rows per block follow M: 16, 32, 48 or 64
template <bool TRANS, typename OT>
cudaError_t launch_qmm_tc_rows(const void* x, const int8_t* q, const float* s, void* out, int M,
                               int K, int O, cudaStream_t stream) {
  if (M <= 16) return launch_qmm_tc<1, TRANS, OT>(x, q, s, out, M, K, O, stream);
  if (M <= 32) return launch_qmm_tc<2, TRANS, OT>(x, q, s, out, M, K, O, stream);
  if (M <= 48) return launch_qmm_tc<3, TRANS, OT>(x, q, s, out, M, K, O, stream);
  return launch_qmm_tc<4, TRANS, OT>(x, q, s, out, M, K, O, stream);
}

// ---------------------------------------------------------------------------
// multiply-add path: fp32 activations and shapes that are not whole tiles
// ---------------------------------------------------------------------------
// 128 threads take a 16 x 64 tile; a thread owns 2 rows x 4 columns and sums
// over k in k order. Elements past M, K or O read as zero.

constexpr int kFM = 16, kFN = 64, kFK = 32, kFThreads = 128;

template <typename XT, typename OT>
__global__ void __launch_bounds__(kFThreads)
qmm_fma_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ s,
               OT* __restrict__ out, int M, int K, int O, int transpose) {
  __shared__ float As[kFK][kFM + 1];  // [k][m]
  __shared__ __align__(16) float Ws[kFK][kFN];  // [k][n]
  const int n0 = blockIdx.x * kFN;
  const int m0 = blockIdx.y * kFM;
  const int tx = threadIdx.x % (kFN / 4);  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / (kFN / 4);  // rows 2 ty, 2 ty + 1
  float acc[2][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int e = threadIdx.x; e < kFM * kFK; e += kFThreads) {
      const int m = e / kFK, k = e % kFK;  // neighbouring threads read neighbouring k
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_float(x[static_cast<size_t>(gm) * K + gk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kFK * kFN; e += kFThreads) {
      int k, n;
      if (transpose) {  // q[o][k]: neighbouring threads read neighbouring k
        n = e / kFK;
        k = e % kFK;
      } else {  // q[k][o]: neighbouring threads read neighbouring o
        k = e / kFN;
        n = e % kFN;
      }
      const int gk = k0 + k, gn = n0 + n;
      float v = 0.0f;
      if (gk < K && gn < O)
        v = static_cast<float>(q[transpose ? static_cast<size_t>(gn) * K + gk
                                           : static_cast<size_t>(gk) * O + gn]);
      Ws[k][n] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFK; ++kk) {
      const float a0 = As[kk][2 * ty], a1 = As[kk][2 * ty + 1];
      const float4 w = *reinterpret_cast<const float4*>(&Ws[kk][4 * tx]);
      acc[0][0] += a0 * w.x; acc[0][1] += a0 * w.y; acc[0][2] += a0 * w.z; acc[0][3] += a0 * w.w;
      acc[1][0] += a1 * w.x; acc[1][1] += a1 * w.y; acc[1][2] += a1 * w.z; acc[1][3] += a1 * w.w;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 2 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < O) out[static_cast<size_t>(row) * O + col] = from_float<OT>(acc[i][j] * s[col]);
    }
  }
}

template <typename XT, typename OT>
cudaError_t launch_qmm_fma(const void* x, const int8_t* q, const float* s, void* out, int M,
                           int K, int O, int transpose, cudaStream_t stream) {
  const dim3 grid((O + kFN - 1) / kFN, (M + kFM - 1) / kFM);
  qmm_fma_kernel<XT, OT><<<grid, kFThreads, 0, stream>>>(
      static_cast<const XT*>(x), q, s, static_cast<OT*>(out), M, K, O, transpose);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t run_qmatmul(const void* x, const int8_t* q, const float* s, void* out, int M, int K,
                        int O, int transpose, int x_dtype, bool whole, cudaStream_t stream) {
  if (x_dtype == kBF16 && whole)
    return transpose ? launch_qmm_tc_rows<true, OT>(x, q, s, out, M, K, O, stream)
                     : launch_qmm_tc_rows<false, OT>(x, q, s, out, M, K, O, stream);
  if (x_dtype == kBF16) return launch_qmm_fma<bf16, OT>(x, q, s, out, M, K, O, transpose, stream);
  if (x_dtype == kF32) return launch_qmm_fma<float, OT>(x, q, s, out, M, K, O, transpose, stream);
  return cudaErrorInvalidValue;
}

}  // namespace omt

// out (M, O) = (x (M, K) @ q) * s, q (K, O) int8, or (O, K) when transpose != 0;
// s (O,) fp32. x, q, s and out are contiguous; x_dtype and out_dtype are fp32 or
// bf16 codes. Everything is enqueued on `stream`. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int omt_qmatmul(const void* x, const void* q, const float* s, void* out, int M, int K,
                           int O, int transpose, int x_dtype, int out_dtype, void* stream) {
  using namespace omt;
  if (M < 1 || K < 1 || O < 1 || (M + kFM - 1) / kFM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool whole = aligned && K % kQBK == 0 && O % kQBN == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == kF32) return run_qmatmul<float>(x, qi, s, out, M, K, O, transpose, x_dtype, whole, st);
  if (out_dtype == kBF16)
    return run_qmatmul<__nv_bfloat16>(x, qi, s, out, M, K, O, transpose, x_dtype, whole, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
