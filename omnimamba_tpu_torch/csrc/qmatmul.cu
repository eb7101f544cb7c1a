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
//     rows), fewer than m_tile rows (decode), bound by the weight bytes: a
//     cluster of two blocks for each tile of 32, 64 or 128 columns (chosen
//     from O alone) and up to 64 rows. The two blocks run the two k chains of
//     the order below, lo and hi, each over all of K, so the card gets twice
//     as many blocks as column tiles with no partial sums in device memory
//     and one launch. A producer warp streams the block's half of each int8
//     tile and activation tile into a ring with TMA copies and mbarriers;
//     the consumer warps widen the int8 tile in registers (ldmatrix.trans of
//     byte pairs for (K, O), 32-bit loads for (O, K)) into mma.sync m16n8k16.
//     Rank 1 pushes its fp32 sums into rank 0's shared memory; rank 0 adds,
//     scales and stores. On an H100 the 48-row step in_proj takes about 13 us
//     against 5.5 for its bytes: the launch, the stage handshakes and the
//     epilogue take about 5 of them, the widening and the products about 7
//     (tools/ablation.py k7-decode).
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
//     widening 0.10 and the copies 0.05 (tools/ablation.py k7-prefill).
//   - fp32 activations, and edges that are not whole tiles (O = 139, K = 24,
//     any M), take fp32 multiply-adds over shared-memory tiles.
// The two tensor-core paths sum in one order: for every 64-wide k tile, k in
// [0, 32) goes into an accumulator `lo` and k in [32, 64) into `hi`, each as two
// k16 products in k order, one mma.sync m16n8k16 (HMMA.16816.F32.BF16) each,
// with the tiles in k order; then out = (lo + hi) * s. A sum does not depend
// on the row's or column's place within an m16 or n8 tile. So a row gives the
// same bits in any batch and through either path (chip_smoke.py asserts it),
// and the fp32 path too sums in an order that does not depend on M.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"
#include "tma.cuh"

namespace omt {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using tc::widen4;

// the tensor-core paths take whole tiles: K and O multiples of these
constexpr int kQBN = 64, kQBK = 64;

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

// Measurement only: tools/ablation.py k7-prefill builds this file with
// OMT_QMM_WIDE_SKIP = 1 (no widening), 2 (no copies) or 3 (neither) to time what
// is left of the 128-row path; its results are then wrong. The library has 0.
#ifndef OMT_QMM_WIDE_SKIP
#define OMT_QMM_WIDE_SKIP 0
#endif

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
// tensor-core path for few rows: bf16 activations, whole tiles, M < m_tile
// ---------------------------------------------------------------------------
// The two k chains of the order above, lo and hi, run in the two blocks of a
// cluster (rank 0 takes k in [0, 32) of every 64-wide k tile, rank 1 [32, 64)),
// each over all of K: twice the blocks of a column tiling, and no partial sums
// in device memory. A block takes up to 64 rows (MT m16 tiles) and BN columns
// (32, 64 or 128, from O alone), 16 a consumer warp, or one m16 tile and 16
// columns a warp where 32 columns leave a block its SM to itself. A producer
// warp copies the block's half of each activation tile and int8 weight tile
// with one TMA copy each (swizzled, so the loads below have no bank conflicts)
// into a ring of stages of kS k tiles: a stage's `full` mbarrier counts its
// bytes, its `empty` mbarrier the consumer warps that are done with it, so no
// block-wide barrier stands in the k loop. The launch is a programmatic
// dependent of the kernel ahead in the stream: the blocks set up while it
// finishes and read nothing before it is done. The int8 tile is widened in registers: for
// (K, O) an ldmatrix.trans of byte pairs gives a thread two k rows of columns
// 2g and 2g + 1, which become the B operands of two n8 tiles (the even and the
// odd columns of the warp's 16); for (O, K) two 32-bit loads give a thread the
// k pairs 2c and 2c + 8 of its column. At the end rank 1 pushes its sums into
// rank 0's shared memory through the cluster and arrives on an mbarrier there;
// rank 0 adds, scales and stores.

// Measurement only: tools/ablation.py k7-decode builds this file with
// OMT_QMM_PAIR_SKIP = 1 (no activation copies), 2 (no weight copies), 4 (no
// widening and no products) or a sum of them, to time what is left of the
// decode path, whose results are then wrong, or 8 (the launch alone). The
// library has 0.
#ifndef OMT_QMM_PAIR_SKIP
#define OMT_QMM_PAIR_SKIP 0
#endif

// the column tile follows O, never M: the widest of 128, 64 and 32 columns that
// divides O and still gives 128 column tiles, else 32
constexpr int pair_columns(int O) {
  return O % 128 == 0 && O / 128 >= 128 ? 128 : O / 64 >= 128 ? 64 : 32;
}

// consumer warps of a block: 16 columns and all rows each, or for 32 columns
// (the few-column-tile shapes, one block an SM) 16 columns and one m16 tile each,
// so that every sub-partition of the SM has a warp
constexpr int pair_warps(int MT, int BN) { return BN == 32 ? 2 * MT : BN / 16; }
// threads of a block: the consumer warps and the producer warp
constexpr int pair_threads(int MT, int BN) { return 32 * (pair_warps(MT, BN) + 1); }

template <int MT, int BN, bool TRANS>
struct PairTile {
  static constexpr bool kTrans = TRANS;
  static constexpr int kWarps = pair_warps(MT, BN), kThreads = pair_threads(MT, BN);
  static constexpr int kColWarps = BN / 16;           // warps side by side along the columns
  static constexpr int kWM = MT / (kWarps / kColWarps);  // m16 tiles a warp
  // k tiles a stage and bytes of the ring: a block of 32 columns has its SM to
  // itself (O / 32 column tiles fill the card once), the wider ones share it
  // with two more
  static constexpr int kS = BN == 32 ? 8 : 4;
  static constexpr int kRing = BN == 32 ? 131072 : 65536;
  static constexpr int kABytes = MT * 16 * 64;  // a k tile's activations: 16 MT rows x 32 bf16
  static constexpr int kQBytes = 32 * BN;       // a k tile's weights: 32 k x BN int8
  static constexpr int kStageBytes = kS * (kABytes + kQBytes);
  static constexpr int kRingStages = kRing / kStageBytes;
  static constexpr int kStages = kRingStages < 3 ? 3 : kRingStages > 8 ? 8 : kRingStages;
  static constexpr int kAcc = kWM * 2 * 4;  // accumulator floats of a thread
  // rank 1's sums, pushed into rank 0 as the threads hold them
  static constexpr int kSumsBytes = kWarps * kAcc * 32 * 4;
  static constexpr int kBytes = kStages * kStageBytes + kSumsBytes + 1024;  // + the ring's alignment
  // every tile a multiple of 1 KB: the swizzle of a TMA copy follows the
  // address bits, so a tile starts where its pattern starts
  static_assert(kABytes % 1024 == 0 && kQBytes % 1024 == 0, "1 KB aligned tiles");
  static_assert(kWM * (kWarps / kColWarps) == MT, "the warps split the m16 tiles evenly");
};

template <typename OT>
__device__ __forceinline__ void store_2(OT* p, float a, float b);
template <>
__device__ __forceinline__ void store_2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = bf16x2_bits(a, b);
}

// N k tiles of a landed stage (from its activation tile a_tile and its weight
// tile q_tile on) into the accumulators of this warp's P::kWM m16 tiles, in k
// order: for each tile, the two k16 steps of this block's k half. a_off, b_off
// are this lane's offsets in a tile (swizzle and the warp's rows and columns
// included).
template <typename P, int N>
__device__ __forceinline__ void pair_tiles(float (&acc)[P::kWM][2][4], const unsigned char* a_tile,
                                           const unsigned char* q_tile, const uint32_t (&a_off)[2],
                                           uint32_t b_off, uint32_t pair_sel) {
  constexpr bool TRANS = P::kTrans;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    uint32_t b[2][2][2];  // [k16 step][n8 tile][b0, b1]
    const unsigned char* q = q_tile + u * P::kQBytes;
    if constexpr (TRANS) {
      // (O, K): row 16 cw + 8 j + g holds 32 bytes of k; b_off is the offset of
      // the words of k 2c and 2c + 8 in row 16 cw + g, whose bit 7 is the row's
      // swizzle of the 16-byte chunk
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* p = q + b_off + j * 8 * 32 + ((h * 16) ^ ((b_off >> 3) & 16));
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + 8);
          widen4(__byte_perm(w0, w1, pair_sel), b[h][j][0], b[h][j][1]);
        }
    } else {
      // r[i]: k rows 8 i + 2c, 8 i + 2c + 1 of columns 2g, 2g + 1 (bytes 0-1, 2-3)
      uint32_t r[4];
      ldsm_x4_trans(r, smem_addr(q) + b_off);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        widen4(__byte_perm(r[i], 0u, 0x3120), b[i >> 1][0][i & 1], b[i >> 1][1][i & 1]);
    }
    const uint32_t a = smem_addr(a_tile) + u * P::kABytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the two k16 steps of this block's k half, in k order
      uint32_t af[P::kWM][4];
#pragma unroll
      for (int i = 0; i < P::kWM; ++i) ldsm_x4(af[i], a + i * 16 * 64 + a_off[h]);
#pragma unroll
      for (int i = 0; i < P::kWM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], af[i], b[h][j][0], b[h][j][1]);
    }
  }
}

template <int MT, int BN, bool TRANS, typename OT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(pair_threads(MT, BN))
qmm_pair_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
                const float* __restrict__ s, OT* __restrict__ out, int M, int K, int O) {
  using P = PairTile<MT, BN, TRANS>;
  if (OMT_QMM_PAIR_SKIP & 8) return;
  extern __shared__ unsigned char psmem_raw[];
  __shared__ __align__(8) uint64_t full[P::kStages], empty[P::kStages], sums_full;
  unsigned char* psmem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(psmem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* sums = reinterpret_cast<float*>(psmem + P::kStages * P::kStageBytes);
  const uint32_t rank = cluster_ctarank();
  const int kh = rank & 1;  // 0: the lo chain, 1: the hi chain
  const int n0 = (blockIdx.x >> 1) * BN, m0 = blockIdx.y * MT * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = K / kQBK, nstages = (ntiles + P::kS - 1) / P::kS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P::kWarps);
    }
    mbar_init(&sums_full, P::kWarps * 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // this block's barriers are set
  // and rank 0's are, for rank 1, once it has waited on this arrival (just
  // before it pushes its sums)
  cluster_arrive_relaxed();

  // the consumer warp's columns 16 cw .. 16 cw + 15 and m16 tiles wi kWM .. of the block
  const int cw = warp % P::kColWarps, wi = warp / P::kColWarps;
  float acc[P::kWM][2][4];  // [m16 tile][n8 tile][mma.sync accumulator]
#pragma unroll
  for (int i = 0; i < P::kWM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  if (warp == P::kWarps) {
    // the producer: stage st into its slot once the slot's last stage is done
    // with, its weight tiles and activation tiles; the first once the kernel
    // ahead in the stream is done (it may have written any input)
    if (lane == 0) {
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&xmap);
      grid_dependency_wait();
      for (int st = 0; st < nstages; ++st) {
        const int slot = st % P::kStages, t0 = st * P::kS, n = min(P::kS, ntiles - t0);
        if (st >= P::kStages) mbar_wait(&empty[slot], (st / P::kStages - 1) & 1);
        unsigned char* stage = psmem + slot * P::kStageBytes;
        mbar_arrive_expect_tx(&full[slot], n * ((OMT_QMM_PAIR_SKIP & 1 ? 0 : P::kABytes) +
                                                (OMT_QMM_PAIR_SKIP & 2 ? 0 : P::kQBytes)));
        for (int u = 0; u < n; ++u) {
          const int k = (t0 + u) * kQBK + kh * 32;
          if (!(OMT_QMM_PAIR_SKIP & 2)) {
            if constexpr (TRANS)
              tma_load(stage + P::kS * P::kABytes + u * P::kQBytes, &qmap, k, n0, &full[slot]);
            else
              tma_load(stage + P::kS * P::kABytes + u * P::kQBytes, &qmap, n0, k, &full[slot]);
          }
          if (!(OMT_QMM_PAIR_SKIP & 1))
            tma_load(stage + u * P::kABytes, &xmap, k, m0, &full[slot]);
        }
      }
    }
    cluster_wait();
  } else {
    // this lane's offsets, swizzle included (a tile's row r, 16-byte chunk j lies
    // at chunk j ^ (bits 7.. of r x row bytes)): A by ldmatrix, row l % 16 of the
    // warp's first m16 tile and chunk 2 h + l / 16 of a 64-byte row; B of (K, O)
    // by ldmatrix.trans, row l and chunk cw of a BN-byte row; B of (O, K), row
    // 16 cw + g of 32 bytes, the words of k 2c and 2c + 8 (the chunk's swizzle
    // bit rides in bit 7)
    uint32_t a_off[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      a_off[h] = wi * P::kWM * 16 * 64 + (lane & 15) * 64 +
                 (((2 * h + (lane >> 4)) ^ ((lane >> 1) & 3)) << 4);
    uint32_t b_off;
    if constexpr (TRANS)
      b_off = (cw * 16 + (lane >> 2)) * 32 + (lane & 2) * 2;
    else
      b_off = lane * BN + ((cw ^ ((lane * BN / 128) & (BN / 16 - 1))) << 4);
    const uint32_t pair_sel = (lane & 1) ? 0x7632u : 0x5410u;

    for (int st = 0; st < nstages; ++st) {
      const int slot = st % P::kStages;
      mbar_wait(&full[slot], (st / P::kStages) & 1);
      const unsigned char* a_tile = psmem + slot * P::kStageBytes;
      const unsigned char* q_tile = a_tile + P::kS * P::kABytes;
      if (!(OMT_QMM_PAIR_SKIP & 4)) {
        const int n = min(P::kS, ntiles - st * P::kS);
        if (n == P::kS) {
          pair_tiles<P, P::kS>(acc, a_tile, q_tile, a_off, b_off, pair_sel);
        } else {  // the last stage of a K that is not a multiple of kS tiles
          for (int u = 0; u < n; ++u)
            pair_tiles<P, 1>(acc, a_tile + u * P::kABytes, q_tile + u * P::kQBytes, a_off, b_off,
                             pair_sel);
        }
      }
      __syncwarp();  // the warp is done with the stage
      if (lane == 0) mbar_arrive(&empty[slot]);
    }

    // rank 1 pushes its sums into rank 0's, laid out as the threads hold them;
    // each thread's arrival on rank 0's sums_full releases its stores
    const int at = warp * P::kAcc * 32 + lane;
    cluster_wait();
    if (kh == 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* peer = cluster.map_shared_rank(sums, rank - 1) + at;
#pragma unroll
      for (int i = 0; i < P::kWM; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) peer[((i * 2 + j) * 4 + e) * 32] = acc[i][j][e];
      mbar_arrive_remote(&sums_full, rank - 1);
    } else {  // out = (lo + hi) * s, once the kernel ahead in the stream is done with out
      grid_dependency_wait();
      mbar_wait(&sums_full, 0);
      const int g = lane >> 2, c = lane & 3;
#pragma unroll
      for (int i = 0; i < P::kWM; ++i) {
        float v[2][4];  // [n8 tile][accumulator]: lo + hi
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) v[j][e] = acc[i][j][e] + sums[at + ((i * 2 + j) * 4 + e) * 32];
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // rows g and g + 8 of the m16 tile
          const int row = m0 + (wi * P::kWM + i) * 16 + half * 8 + g;
          if (row >= M) continue;
          OT* dst = out + static_cast<size_t>(row) * O;
          if constexpr (TRANS) {  // n8 tile j: columns 8 j + 2c, 8 j + 2c + 1
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = n0 + cw * 16 + j * 8 + 2 * c;
              const float2 sc = *reinterpret_cast<const float2*>(s + col);
              store_2(dst + col, v[j][2 * half] * sc.x, v[j][2 * half + 1] * sc.y);
            }
          } else {  // the even and the odd n8 tile: columns 4c .. 4c + 3
            const int col = n0 + cw * 16 + 4 * c;
            const float4 sc = load4(s + col);
            store4(dst + col, make_float4(v[0][2 * half] * sc.x, v[1][2 * half] * sc.y,
                                          v[0][2 * half + 1] * sc.z, v[1][2 * half + 1] * sc.w));
          }
        }
      }
    }
  }
}

template <int MT, int BN, bool TRANS, typename OT>
cudaError_t launch_qmm_pair(const void* x, const int8_t* q, const float* s, void* out, int M, int K,
                            int O, cudaStream_t stream) {
  using P = PairTile<MT, BN, TRANS>;
  CUtensorMap xmap, qmap;  // rows past M read as zeros
  if (!encode_tile_map(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, MT * 16, 32) ||
      !(TRANS ? encode_tile_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, O, K, BN, 32)
              : encode_tile_map(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, O, 32, BN)))
    return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      qmm_pair_kernel<MT, BN, TRANS, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  if (attr != cudaSuccess) return attr;
  // programmatic dependent launch: the blocks set up while the kernel ahead in
  // the stream finishes; they read nothing before it is done
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * (O / BN), (M + MT * 16 - 1) / (MT * 16));
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = P::kBytes;
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmm_pair_kernel<MT, BN, TRANS, OT>, xmap, qmap, s,
                                             static_cast<OT*>(out), M, K, O);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a block follow M: 16, 32, 48 or 64
constexpr int pair_m16_tiles(int M) { return M <= 16 ? 1 : M <= 32 ? 2 : M <= 48 ? 3 : 4; }

template <int MT, typename F>
cudaError_t with_pair_columns(int O, F&& f) {
  using MTc = std::integral_constant<int, MT>;
  switch (pair_columns(O)) {
    case 128: return f(MTc(), std::integral_constant<int, 128>());
    case 64: return f(MTc(), std::integral_constant<int, 64>());
    default: return f(MTc(), std::integral_constant<int, 32>());
  }
}

// f(MT, BN), the m16 tiles and the columns of a block for (M, O) as constants
template <typename F>
cudaError_t with_pair_tile(int M, int O, F&& f) {
  switch (pair_m16_tiles(M)) {
    case 1: return with_pair_columns<1>(O, f);
    case 2: return with_pair_columns<2>(O, f);
    case 3: return with_pair_columns<3>(O, f);
    default: return with_pair_columns<4>(O, f);
  }
}

template <bool TRANS, typename OT>
cudaError_t launch_qmm_pair_tile(const void* x, const int8_t* q, const float* s, void* out, int M,
                                 int K, int O, cudaStream_t stream) {
  return with_pair_tile(M, O, [&](auto mt, auto bn) {
    return launch_qmm_pair<decltype(mt)::value, decltype(bn)::value, TRANS, OT>(x, q, s, out, M, K,
                                                                             O, stream);
  });
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
    return transpose ? launch_qmm_pair_tile<true, OT>(x, q, s, out, M, K, O, stream)
                     : launch_qmm_pair_tile<false, OT>(x, q, s, out, M, K, O, stream);
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

// The launch that the decode path (bf16 activations on whole tiles, fewer than
// m_tile rows) makes for M rows and O columns: plan = {blocks a cluster,
// columns a block, rows a block, threads a block, k tiles a stage, ring
// stages, shared bytes a block}. Returns 0, or cudaErrorInvalidValue for shapes that are not whole.
extern "C" int omt_qmatmul_pair_plan(int M, int O, int transpose, int* plan) {
  using namespace omt;
  if (M < 1 || O < 1 || O % kQBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto fill = [&](auto mt, auto bn, auto tr) {
    using P = PairTile<decltype(mt)::value, decltype(bn)::value, decltype(tr)::value>;
    const int v[7] = {2, decltype(bn)::value, decltype(mt)::value * 16, P::kThreads,
                      P::kS, P::kStages, P::kBytes};
    for (int i = 0; i < 7; ++i) plan[i] = v[i];
    return cudaSuccess;
  };
  return static_cast<int>(with_pair_tile(M, O, [&](auto mt, auto bn) {
    return transpose ? fill(mt, bn, std::true_type()) : fill(mt, bn, std::false_type());
  }));
}
