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
// in_proj is 120 GFLOP: 0.12 ms of bf16 tensor-core time). Three paths:
//   - bf16 activations on whole tiles (K and O multiples of 64, 16-byte aligned
//     rows), fewer than m_tile rows (decode): K4's bf16 product (decode_fused.cu)
//     with the weight tile landing as int8. A block of 8 warps takes MT * 16
//     rows x 64 columns; the int8 weight tile (64 x 64, 4 KB, half of K4's bf16
//     stage) and the activation tile of each k step are copied into a four-stage
//     ring with 16-byte cp.async, three k steps ahead. wmma has no int8 x bf16
//     product, so each landed weight tile is widened to bf16 in shared memory
//     (exact: |q| <= 127) behind one __syncthreads, then warp w multiplies
//     columns 16 (w % 4) .. + 15 over the k half w / 4 (m16n16k16, fp32 sums).
//     The transposed table needs no transposed copy: its (O, K) tile is loaded
//     as a column-major matrix_b. Few blocks, each short of work: bound by the
//     latency of its loads, not by the bytes.
//   - the same on m_tile rows or more (prefill), bound by the operations: a
//     block of 8 warps takes 128 rows x 128 columns, so each activation byte
//     is read from L2 by a quarter as many blocks as with 64-column tiles and
//     each weight byte by half as many. A six-stage cp.async ring holds the
//     int8 tile (8 KB) and the activation tile (16 KB) of each k step; the int8
//     tile of step t + 1 is widened to bf16 during step t into the other half of
//     a double buffer, so a k step needs one __syncthreads. Warp w multiplies a
//     64 x 64 sub-tile over the k half w / 4 with operands from ldmatrix (.trans
//     for the (K, O) layout, none for (O, K)) and mma.sync m16n8k16; the rows of
//     a tile are padded so that ldmatrix has no bank conflicts. A step's copies
//     and widening are issued in eight pieces between its products. On an
//     H100 the ldmatrix loads and mma.sync products alone take 0.33 ms of the
//     3456-row in_proj's 0.47 (370 TFLOP/s, against 989 for wgmma), the
//     widening 0.10 and the copies 0.05 (tools/k7_prefill_ablation.py).
//   - fp32 activations, and edges that are not whole tiles (O = 139, K = 24,
//     any M), take fp32 multiply-adds over shared-memory tiles.
// The two tensor-core paths sum in one order: for every 64-wide k tile, k in
// [0, 32) goes into an accumulator `lo` and k in [32, 64) into `hi`, each as two
// k16 products in k order (a wmma m16n16k16 is two m16n8k16 products over the
// same k16); then out = (lo + hi) * s. So a row gives the same bits in any
// batch and through either path, and the fp32 path too sums in an order that
// does not depend on M.
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
// tensor-core path for many rows: bf16 activations, whole tiles, M >= m_tile
// ---------------------------------------------------------------------------

constexpr int kWM = 128, kWN = 128, kWK = 64, kWStages = 6, kWThreads = 256;
constexpr int kWLdA = kWK + 8;                     // bf16 elements of an activation tile row (144 bytes)
constexpr int kWQBytes = kWK * kWN;                // the int8 tile, 64 x 128 or 128 x 64, unpadded
constexpr int kWStageBytes = kWQBytes + kWM * kWLdA * 2;
constexpr int kWWideElems = kWN * (kWK + 8);       // a widened tile: 64 x (128 + 8) or 128 x (64 + 8)
constexpr int kWLdC = kWN + 8;                     // floats of a row of C in the epilogue
constexpr int kWBytes = kWStages * kWStageBytes + 2 * kWWideElems * 2;
static_assert(kWK * (kWN + 8) <= kWWideElems, "the (K, O) widened tile fits its buffer");
static_assert(kWM * kWLdC * 4 <= kWStages * kWStageBytes, "C of the hi half fits in the ring");
static_assert(kWStageBytes % 128 == 0 && kWQBytes % 128 == 0, "16-byte aligned tile rows");
// a thread's share of a k step's side work: 16-byte copies of the int8 tile and
// of the activation tile, 8-byte chunks of the int8 tile to widen
constexpr int kWCopiesQ = kWQBytes / 16 / kWThreads, kWCopies = kWCopiesQ + kWM * kWK / 8 / kWThreads;
constexpr int kWWidens = kWQBytes / 8 / kWThreads;

// Measurement only: tools/k7_prefill_ablation.py builds this file with
// OMT_QMM_WIDE_SKIP = 1 (no widening), 2 (no copies) or 3 (neither) to time what
// is left of the 128-row path; its results are then wrong. The library has 0.
#ifndef OMT_QMM_WIDE_SKIP
#define OMT_QMM_WIDE_SKIP 0
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(  // no side effects: the compiler may place the products among other work
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Copy i of this thread's kWCopies for the stage of k step k0: the int8 weight
// tile at (k0, n0), then the activation rows m0 .. m0 + 127. Rows past M are
// read from row M - 1, columns past O (the second half of the last column tile
// when O / 64 is odd) from the last 16 columns; neither is written.
template <bool TRANS>
__device__ __forceinline__ void qmm_wide_copy(int i, const bf16* __restrict__ x,
                                              const int8_t* __restrict__ q, int M, int K, int O,
                                              int m0, int n0, int k0, unsigned char* stage) {
  if (i < kWCopiesQ) {
    const int c = threadIdx.x + i * kWThreads;  // 16-byte chunk of the tile, at stage + 16 c
    const int8_t* src;
    if constexpr (TRANS) {  // 128 rows (o) x 64 bytes (k)
      src = q + static_cast<size_t>(min(n0 + (c >> 2), O - 1)) * K + k0 + (c & 3) * 16;
    } else {  // 64 rows (k) x 128 bytes (o)
      src = q + static_cast<size_t>(k0 + (c >> 3)) * O + min(n0 + (c & 7) * 16, O - 16);
    }
    cp_async16(stage + c * 16, src);
  } else {
    const int c = threadIdx.x + (i - kWCopiesQ) * kWThreads;
    const int row = c / (kWK / 8), col = (c % (kWK / 8)) * 8;
    cp_async16(reinterpret_cast<bf16*>(stage + kWQBytes) + row * kWLdA + col,
               x + static_cast<size_t>(min(m0 + row, M - 1)) * K + k0 + col);
  }
}

// Chunk i of this thread's kWWidens: 8 bytes of the landed int8 tile of
// `stage`, widened to bf16 in `wide` (same row order, rows padded by 8 elements)
template <bool TRANS>
__device__ __forceinline__ void qmm_wide_widen(int i, const unsigned char* stage, bf16* wide) {
  constexpr int kRowBytes = TRANS ? kWK : kWN;
  const int c = threadIdx.x + i * kWThreads;
  const int row = c / (kRowBytes / 8), col = (c % (kRowBytes / 8)) * 8;
  const uint2 raw = *reinterpret_cast<const uint2*>(stage + c * 8);
  uint4 v;
  widen4(raw.x, v.x, v.y);
  widen4(raw.y, v.z, v.w);
  *reinterpret_cast<uint4*>(wide + row * (kRowBytes + 8) + col) = v;
}

__device__ __forceinline__ void store_16_bytes(float* p, const float* c) {
  reinterpret_cast<float4*>(p)[0] = reinterpret_cast<const float4*>(c)[0];
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_16_bytes(bf16* p, const float* c) {
  const float4 a = reinterpret_cast<const float4*>(c)[0];
  const float4 b = reinterpret_cast<const float4*>(c)[1];
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2_bits(a.x, a.y), bf16x2_bits(a.z, a.w),
                                            bf16x2_bits(b.x, b.y), bf16x2_bits(b.z, b.w));
}

template <bool TRANS, typename OT>
__global__ void __launch_bounds__(kWThreads, 1)
qmm_wide_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                const float* __restrict__ s, OT* __restrict__ out, int M, int K, int O) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  constexpr int kLdB = TRANS ? kWK + 8 : kWN + 8;  // bf16 elements of a widened tile row
  const int n0 = blockIdx.x * kWN, m0 = blockIdx.y * kWM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kh = warp >> 2;                // k half of every tile: 0 = lo, 1 = hi
  const int wm = ((warp >> 1) & 1) * 64;   // the warp's 64 x 64 sub-tile
  const int wn = (warp & 1) * 64;
  const int ntiles = K / kWK;
  bf16* wide = reinterpret_cast<bf16*>(wsmem + kWStages * kWStageBytes);

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int t = 0; t < kWStages - 1; ++t) {
    if (t < ntiles) {
#pragma unroll
      for (int i = 0; i < kWCopies; ++i)
        qmm_wide_copy<TRANS>(i, x, q, M, K, O, m0, n0, t * kWK, wsmem + t * kWStageBytes);
    }
    cp_async_commit();
  }
  cp_async_wait<kWStages - 2>();  // this thread's copies of tile 0 have landed
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWWidens; ++i) qmm_wide_widen<TRANS>(i, wsmem, wide);

  // ldmatrix addresses: lane l gives row l % 16 (A, the (K, O) B) or row
  // l % 8 + 8 (l / 16) (the (O, K) B) of its 8 x 8 matrix
  const uint32_t a_off = ((wm + (lane & 15)) * kWLdA + (lane >> 4) * 8) * 2;
  const uint32_t b_off =
      TRANS ? ((wn + (lane & 7) + (lane >> 4) * 8) * kLdB + ((lane >> 3) & 1) * 8) * 2
            : ((lane & 15) * kLdB + wn + (lane >> 4) * 8) * 2;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kWStages - 3>();  // this thread's copies of tile t + 1 have landed
    // everyone's have, tile t is widened, and step t - 1 is done with the stage
    // and the widened buffer that this step refills
    __syncthreads();
    const int ahead = t + kWStages - 1;  // copied into the stage that tile t - 1 used
    const bool copy = !(OMT_QMM_WIDE_SKIP & 2) && ahead < ntiles;
    const bool widen = !(OMT_QMM_WIDE_SKIP & 1) && t + 1 < ntiles;
    unsigned char* ahead_stage = wsmem + (ahead % kWStages) * kWStageBytes;
    const unsigned char* next_stage = wsmem + ((t + 1) % kWStages) * kWStageBytes;
    bf16* next_wide = wide + ((t + 1) & 1) * kWWideElems;
    const uint32_t a_base = smem_addr(wsmem + (t % kWStages) * kWStageBytes + kWQBytes) + a_off;
    const uint32_t b_base = smem_addr(wide + (t & 1) * kWWideElems) + b_off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the two k16 steps of this warp's k half
      const int kk = kh * (kWK / 2) + h * 16;
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldsm_x4(a[i], a_base + (i * 16 * kWLdA + kk) * 2);
      if constexpr (TRANS)
        ldsm_x4(b[0], b_base + kk * 2);
      else
        ldsm_x4_trans(b[0], b_base + kk * kLdB * 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // n8 tiles 2 j and 2 j + 1; the next pair's B is loaded first
        if (j < 3) {
          if constexpr (TRANS)
            ldsm_x4(b[(j + 1) & 1], b_base + ((j + 1) * 16 * kLdB + kk) * 2);
          else
            ldsm_x4_trans(b[(j + 1) & 1], b_base + (kk * kLdB + (j + 1) * 16) * 2);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * j], a[i], b[j & 1][0], b[j & 1][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[j & 1][2], b[j & 1][3]);
        }
        // an eighth of the step's copies and widening behind each 8 products,
        // so that the tensor cores are not idle while they are issued
        constexpr int kPieces = 8;
        const int p = h * 4 + j;
        if (copy) {
#pragma unroll
          for (int i = p * kWCopies / kPieces; i < (p + 1) * kWCopies / kPieces; ++i)
            qmm_wide_copy<TRANS>(i, x, q, M, K, O, m0, n0, ahead * kWK, ahead_stage);
        }
        if (widen) {
#pragma unroll
          for (int i = p * kWWidens / kPieces; i < (p + 1) * kWWidens / kPieces; ++i)
            qmm_wide_widen<TRANS>(i, next_stage, next_wide);
        }
      }
    }
    cp_async_commit();
  }

  // epilogue: the hi warps leave their sums in the ring, the lo warps add them
  // to theirs and scale, then all threads store the tile with 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
  float* C = reinterpret_cast<float*>(wsmem);
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // the accumulator layout of m16n8k16
  if (kh == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* p = C + (wm + i * 16 + g) * kWLdC + wn + j * 8 + c2;
        *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * kWLdC) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
  }
  __syncthreads();
  if (kh == 0 && n0 + wn < O) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 sc = *reinterpret_cast<const float2*>(s + n0 + wn + j * 8 + c2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2* p = reinterpret_cast<float2*>(C + (wm + i * 16 + g) * kWLdC + wn + j * 8 + c2);
        const float2 h0 = p[0], h1 = p[4 * kWLdC];
        p[0] = make_float2((acc[i][j][0] + h0.x) * sc.x, (acc[i][j][1] + h0.y) * sc.y);
        p[4 * kWLdC] = make_float2((acc[i][j][2] + h1.x) * sc.x, (acc[i][j][3] + h1.y) * sc.y);
      }
    }
  }
  __syncthreads();
  constexpr int kPer = 16 / sizeof(OT), kChunks = kWN / kPer;  // output elements a 16-byte store
  for (int e = threadIdx.x; e < kWM * kChunks; e += kWThreads) {
    const int row = e / kChunks, col = (e % kChunks) * kPer;
    if (m0 + row < M && n0 + col < O)
      store_16_bytes(out + static_cast<size_t>(m0 + row) * O + n0 + col, C + row * kWLdC + col);
  }
}

template <bool TRANS, typename OT>
cudaError_t launch_qmm_wide(const void* x, const int8_t* q, const float* s, void* out, int M, int K,
                            int O, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(qmm_wide_kernel<TRANS, OT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((O + kWN - 1) / kWN, (M + kWM - 1) / kWM);
  qmm_wide_kernel<TRANS, OT><<<grid, kWThreads, kWBytes, stream>>>(
      static_cast<const bf16*>(x), q, s, static_cast<OT*>(out), M, K, O);
  return cudaGetLastError();
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
                        int O, int transpose, int x_dtype, bool whole, int m_tile,
                        cudaStream_t stream) {
  if (x_dtype == kBF16 && whole && M >= m_tile)
    return transpose ? launch_qmm_wide<true, OT>(x, q, s, out, M, K, O, stream)
                     : launch_qmm_wide<false, OT>(x, q, s, out, M, K, O, stream);
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
// bf16 codes. bf16 activations on whole tiles take the 128-row tiles from
// m_tile rows on. Everything is enqueued on `stream`. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int omt_qmatmul(const void* x, const void* q, const float* s, void* out, int M, int K,
                           int O, int transpose, int x_dtype, int out_dtype, int m_tile,
                           void* stream) {
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
  if (out_dtype == kF32) return run_qmatmul<float>(x, qi, s, out, M, K, O, transpose, x_dtype, whole, m_tile, st);
  if (out_dtype == kBF16)
    return run_qmatmul<__nv_bfloat16>(x, qi, s, out, M, K, O, transpose, x_dtype, whole, m_tile,
                                      st);
  return static_cast<int>(cudaErrorInvalidValue);
}
