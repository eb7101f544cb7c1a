// One decode token through every layer of the Mamba-2 stack, as ONE call.
//
// Replaces the TPU kernel `_fused_decode_kernel` / `fused_decode_step` of
// omnimamba_tpu/ops/decode_fused.py. Per layer it computes
//
//   res  = h + res (fp32);  hn = RMSNorm(res) * w, rounded to the io type
//   [z | x B C | dt] = hn @ W_in + scaling * (hn @ A_lora) @ B_lora      (fp32)
//   (an int8 {q, scale} W_in or W_out: (hn @ q) * scale, the scale on the fp32 product)
//   x B C = silu(conv shift register step), window rolled in place
//   dt    = softplus(dt + dt_bias)
//   s'    = s * exp(dt * -exp(A_log)) + (dt * x) outer B, in place;  y = s' C + D x
//   yf    = y * silu(z)
//   h     = ((yf * w_gn rounded to io) @ W_out) * rsqrt(mean(yf^2) + eps), rounded to io
//
// and returns the last h and the fp32 residual. The TPU kernel walks a
// sequential (layer, head tile) grid on one core with the (B, d) streams in its
// on-chip memory. Here 132 SMs must share each layer's weights and state, and
// a layer cannot start before the one before it has finished, so the exported
// function `omt_fused_decode_step` enqueues, per layer, four kernels on the
// caller's stream (stream order is the device-wide ordering point between the
// phases), and one more after the last layer. There is no host synchronisation
// and no library call between them; the host's part of a token step is this
// one C call. Every phase is a `__global__` wrapper around `__device__` code,
// so a persistent cooperative kernel with grid-wide barriers can take the same
// phases later.
//
//   1. pre-norm      one block per batch row: finishes the previous layer's
//                    out_proj (fixed-order sum of its K splits, times the
//                    row's rstd, rounded to io), adds the residual, norms,
//                    and computes hn @ A_lora. In bf16 on the tensor-core
//                    path, at the shapes prenorm_row_fits takes, it is
//                    launched as a programmatic dependent of the out_proj and
//                    fetches its weights while that runs.
//   2. in_proj       blocks tile rows x (64 columns) of the
//                    (B, d) x (d, 2*d_inner + 2N + H) product, so every weight
//                    byte is read from device memory once; on its finished
//                    columns a block adds the LoRA term and does the conv step
//                    (x|B|C columns) or the softplus (dt columns). With bf16
//                    activations on whole tiles it is launched as a
//                    programmatic dependent of the pre-norm and starts
//                    fetching weights (bf16 or int8) while that runs.
//   3. SSM update    one block per (row, head), which issues the loads of its
//                    whole state tile at once, as a programmatic dependent of
//                    the in_proj that starts while the in_proj runs (tiles
//                    beyond 64 x 128 take the step kernel's row code,
//                    ssd_step_row.cuh); writes yf * w_gn rounded to io and one
//                    partial sum of yf^2 per (row, head).
//   4. out_proj      blocks tile rows x (64 columns) x (K split) of the
//                    (B, d_inner) x (d_inner, d) product into fp32 partials
//                    (d alone has too few columns to fill the card). With
//                    bf16 activations on whole tiles it is launched as a
//                    programmatic dependent of the SSM update and starts
//                    fetching weights (bf16 or int8) while that ends.
//
// Intermediates (hn, hn @ A, z, x|B|C, dt, yf * w_gn, partial sums) live in
// scratch that the caller allocates once: about 1.7 MB at B=48, which stays in the
// 50 MB L2. Weights are read through tables of device pointers, one entry per
// layer and operand, so the per-layer tensors are neither stacked nor copied.
//
// What bounds it on an H100: bytes. The step must move each layer's weights
// once and its state twice (about 7.4 GB at B=48 with a bf16 state at the 1.3B
// width: 2.2 ms at 3.35 TB/s), and its 119 GFLOP are 0.12 ms of bf16
// tensor-core time. So the two products are written by hand twice:
//   - bf16 activations with bf16 weights (the serving case) take tensor-core
//     products (bf16 operands, fp32 sums), which cost nothing beside the
//     weight bytes. The in_proj (34.9 MB of weights a layer at 1.3B, the
//     largest phase) runs its two k chains in the two blocks of a cluster per
//     64 columns: a producer warp streams the weight and activation tiles with
//     TMA copies into a ring of mbarrier-guarded stages (about 64 KB a block,
//     three blocks an SM), the first stages' weights asked for before the
//     pre-norm ends, consumer warps multiply with ldmatrix and mma.sync, the
//     blocks trade halves of their sums through distributed shared memory and
//     each finishes half the rows. The out_proj takes the same design per
//     (64 columns, K split), its first weights asked for before the SSM
//     update ends. Int8 projections take the same two designs with their int8
//     weight tiles widened to bf16 in registers. All sum in one k order, so a
//     row's bits do not depend on B;
//   - fp32 activations and weights, and any shape the tiles do not fit, take
//     fp32 multiply-adds over shared-memory tiles (bf16 x bf16
//     products are exact in fp32, so this is the same arithmetic in another
//     order). It is bound by operations (119 GFLOP at 67 TFLOP/s is 1.8 ms at
//     best).
// With int8 projections (serving) the weight tiles land as int8, half the
// bytes: the multiply-add kernels widen them on the way into shared memory,
// the clusters of both products in registers between ldmatrix and mma.sync;
// the column scale multiplies the fp32 product in the epilogue (before
// in_proj's LoRA term, on each out_proj K-split partial). The other weights
// keep the activation type.
// The state update has a whole (row, head) tile of state in flight per block
// from its first cycles, fetched while the in_proj runs, in the step
// kernel's arithmetic and order; the pre-norm has its weights in registers
// and the loads of its row in flight at once. What keeps the step above its bound is
// recorded in PERF.md, phase by phase; four short kernels a layer leave the
// card partly idle at each boundary.
// All sums are taken in a fixed order (no atomics): a step gives the same bits
// on every run.
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "ssd_step_row.cuh"
#include "tensor_core.cuh"
#include "tma.cuh"

namespace omt {

// rows of the pointer table: table[op * L + layer]
enum K4Op : int {
  kNormW = 0, kInProj, kLoraA, kLoraB, kConvW, kConvB, kDtBias, kALog, kD, kGnW, kOutProj,
  kInScale, kOutScale,  // fp32 column scales of int8 projections
  kNumOps
};

constexpr int kMaxKSplit = 8;

struct K4Args {
  const void* const* tab;  // (kNumOps, L) device pointers, on the device
  int L, B, d, d_inner, H, P, N, W, r, ksplit;
  int vec4;  // every operand of the in_proj epilogue takes 4-element vector accesses
  float lora_scale, norm_eps, gn_eps;
  void* conv_state;      // (L, B, W-1, d_inner + 2N) io type, in place
  void* ssm_state;       // (L, B, H, P, N) fp32 or bf16, in place
  const void* h_in;      // (B, d) io type
  const float* res_in;   // (B, d) or null
  void* h_out;           // (B, d) io type
  float* res;            // (B, d) running fp32 residual = the residual output
  void* hn;              // (B, d) io type
  float* hA;             // (B, r)
  float* z;              // (B, d_inner)
  float* xbc;            // (B, d_inner + 2N)
  float* dt;             // (B, H)
  void* ya;              // (B, d_inner) io type: (yf * w_gn) rounded
  // the gated norm's sums of squares and out_proj's K-split partials: written
  // to sumsq_out (B, H) and part_out (ksplit, B, d), read from sumsq and part.
  // One rank: the same arrays. Under tp (heads cut over `tp` ranks, this rank's
  // H from head h0 of Hdt) the host gathers every rank's block of both between
  // layers: rank q's partials at part + q rank_stride and its sums at sumsq +
  // q rank_stride, so a row's K splits (ksplit tp of them) and heads (H tp)
  // are read in one rank's order (part_at, sumsq_at)
  float* sumsq;
  float* part;
  float* sumsq_out;
  float* part_out;
  int tp;
  long rank_stride;
  int Hdt;  // the dt columns of in_proj: every head of the model
  int h0;   // this rank's first head among them
  // (L + 1) tensor maps in host memory for the pair in_proj, W_in of each
  // layer then hn (omt_fused_decode_in_maps), copied into its launch
  // parameters; null on the other paths
  const CUtensorMap* in_maps;
  // the same for the pair out_proj (bf16 or int8): W_out of each layer then ya
  const CUtensorMap* out_maps;
};

template <typename T>
__device__ __forceinline__ const T* layer_ptr(const K4Args& a, int op, int layer) {
  return static_cast<const T*>(a.tab[op * a.L + layer]);
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// the fp32 partial of K split s (of ksplit tp) of row b: rank s / ksplit's split
__device__ __forceinline__ const float* part_at(const K4Args& a, int s, int b) {
  const int q = s / a.ksplit, sl = s - q * a.ksplit;
  return a.part + static_cast<size_t>(q) * a.rank_stride +
         (static_cast<size_t>(sl) * a.B + b) * a.d;
}

// the sum of yf^2 of row b over head h (of H tp): rank h / H's head h % H
__device__ __forceinline__ float sumsq_at(const K4Args& a, int b, int h) {
  const int q = h / a.H, hl = h - q * a.H;
  return a.sumsq[static_cast<size_t>(q) * a.rank_stride + static_cast<size_t>(b) * a.H + hl];
}

// ---------------------------------------------------------------------------
// phase 1: finish the previous layer's out_proj, residual add, RMSNorm, hn @ A
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 1024;

// rstd of the gated norm of row b, computed by one whole warp: lane l sums the
// (row, head) partials of heads l, l + 32, ... in that order, then the lanes
// are summed by the shuffle tree; every lane returns the value
__device__ __forceinline__ float gated_rstd(const K4Args& a, int b, int lane) {
  float total = 0.0f;
  for (int h = lane; h < a.H * a.tp; h += 32) total += sumsq_at(a, b, h);
  total = warp_sum(total);
  return rsqrtf(total / static_cast<float>(a.d_inner * a.tp) + a.gn_eps);
}

// element i of row b of the layer output: K splits summed in split order
template <typename IO>
__device__ __forceinline__ float finished_out_proj(const K4Args& a, int b, int i, float rstd) {
  float total = 0.0f;
  for (int s = 0; s < a.ksplit * a.tp; ++s) total += part_at(a, s, b)[i];
  return to_float(from_float<IO>(total * rstd));
}

template <typename IO, typename WT>
__global__ void __launch_bounds__(kRowThreads) k4_prenorm_kernel(K4Args a, int layer) {
  extern __shared__ float4 smem4[];
  float* row = reinterpret_cast<float*>(smem4);  // d floats
  __shared__ float scratch[32];
  __shared__ float rstd_prev;

  // the pair in_proj is launched as a programmatic dependent of this kernel:
  // its blocks may start and fetch weights now; they read hn and hn @ A only
  // once this kernel has ended
  grid_launch_dependents();
  const int b = blockIdx.x;
  const int d = a.d;
  float* res = a.res + static_cast<size_t>(b) * d;

  float ss = 0.0f;
  if (layer == 0) {
    const IO* h = static_cast<const IO*>(a.h_in) + static_cast<size_t>(b) * d;
    const float* rin = (a.res_in != nullptr) ? a.res_in + static_cast<size_t>(b) * d : nullptr;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      float v = to_float(h[i]);
      if (rin != nullptr) v += rin[i];
      res[i] = v;
      row[i] = v;
      ss += v * v;
    }
  } else {
    if (threadIdx.x < 32) {
      const float r = gated_rstd(a, b, threadIdx.x);
      if (threadIdx.x == 0) rstd_prev = r;
    }
    __syncthreads();
    const float rstd = rstd_prev;
    for (int i = threadIdx.x; i < d; i += kRowThreads) {
      const float v = finished_out_proj<IO>(a, b, i, rstd) + res[i];
      res[i] = v;
      row[i] = v;
      ss += v * v;
    }
  }
  ss = block_sum(ss, scratch);
  const float rstd = rsqrtf(ss / static_cast<float>(d) + a.norm_eps);

  // each thread re-reads only the row entries it wrote itself
  const WT* w = layer_ptr<WT>(a, kNormW, layer);
  IO* hn = static_cast<IO*>(a.hn) + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += kRowThreads) {
    const IO v = from_float<IO>(row[i] * rstd * to_float(w[i]));
    hn[i] = v;
    row[i] = to_float(v);
  }
  if (a.r > 0) {
    // hn @ A, eight columns of A at a time: a thread multiplies its own row
    // entries with the (contiguous) A rows, so all its loads are independent;
    // lanes, then warps, are summed in a fixed order
    __shared__ float warp_part[kRowThreads / 32][8];
    const WT* A = layer_ptr<WT>(a, kLoraA, layer);  // (d, r)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j0 = 0; j0 < a.r; j0 += 8) {
      float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = threadIdx.x; i < d; i += kRowThreads) {
        const float x = row[i];
        const WT* Ai = A + static_cast<size_t>(i) * a.r + j0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (j0 + jj < a.r) acc[jj] += x * to_float(Ai[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[jj] = warp_sum(acc[jj]);
      __syncthreads();  // warp_part may still be read from the previous eight
      if (lane == 0) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) warp_part[warp][jj] = acc[jj];
      }
      __syncthreads();
      if (threadIdx.x < 8 && j0 + threadIdx.x < a.r) {
        float total = 0.0f;
        for (int w = 0; w < kRowThreads / 32; ++w) total += warp_part[w][threadIdx.x];
        a.hA[static_cast<size_t>(b) * a.r + j0 + threadIdx.x] = total;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// phase 1 for bf16 activations and weights: started while the out_proj ends
// ---------------------------------------------------------------------------
// k4_prenorm_kernel above is an ordinary launch behind the out_proj and walks
// a chain of dependent steps: one warp reduces the gated norm's partial sums,
// a barrier; the K-split partials and the residual; block_sum's two barriers;
// only then the norm weight and LoRA A from device memory, by which time the
// in_proj, which its first instruction let start, streams W_in through the
// same memory; then eight warp trees, two barriers and a serial tail for
// hn @ A. Here the same block of 1,024 threads a row, with the same thread ->
// element map (thread t owns i = t and t + 1,024), is a programmatic
// dependent of the out_proj, whose blocks let it start as they begin. Before
// griddepcontrol.wait a thread reads only what no running kernel writes: its
// norm weights and its rows of A, into registers. After the wait every warp
// reads the row's gated-norm partial sums itself (so no barrier stands before
// the row), beside the thread's K-split partials and residual, all issued
// back to back; nothing is written before the wait. One barrier passes the
// warps' sums of squares, one the warps' sums of hn @ A, whose columns leave
// a warp through one transposing xor tree (9 shuffles where eight warp_sums
// take 40) that forms warp_sum's very sums. The in_proj may start once the
// wait has returned: its weight copies then overlap this kernel's work, not
// the out_proj's (tools/ablation.py k4-prenorm times the other placements).
//
// The arithmetic is k4_prenorm_kernel's, in its order and contraction, written
// out with intrinsics as the parent kernel's SASS shows it: the K splits summed
// in split order, total * rstd rounded to bf16 before the residual add,
// ss = fma(v, v, ss) over a thread's elements in i order, warp_sum's tree,
// then the same tree over the 32 warp totals; rsqrtf(ss / d + eps); hn =
// round((v * rstd) * w); acc = fma(hn, A, acc) in i order, warp_sum's tree,
// the 32 warp sums added in warp order. So every output keeps its bits. The
// launch takes this kernel for d of 1,024 or 2,048, LoRA rank 0 or 8, at most
// 128 heads and 4 K splits (`prenorm_row_fits`: the 1.3B), k4_prenorm_kernel
// for other shapes.

// Measurement only: tools/ablation.py k4-prenorm builds this file with
// OMT_K4_PRE_SKIP set to a sum of 1 (no reads of the out_proj's partials or
// the sums of squares: they read as zeros), 2 (no norm-weight or LoRA A reads:
// the weights read as ones, A as zeros) and 4 (no hn @ A), or to 8 (the launch
// alone), to time what is left of the early pre-norm, whose results are then
// wrong; or to 16 (an ordinary launch, no programmatic dependency), 32 (the
// in_proj may start at the pre-norm's first instruction), 64 (the in_proj may
// start once hn is written) or 256 (the in_proj may start once the row's sum
// of squares is known), which change when work starts and give the shipped
// bits; the out_proj's trigger of the pre-norm is OMT_K4_OUT_SKIP's 1024. The
// library has 0.
#ifndef OMT_K4_PRE_SKIP
#define OMT_K4_PRE_SKIP 0
#endif

constexpr int kPreMaxHeads = 128;   // gated-norm partial sums of a row: 4 a lane
constexpr int kPreMaxKSplit = 4;

__host__ __device__ constexpr bool prenorm_row_fits(int d, int r, int H, int ksplit) {
  return (d == kRowThreads || d == 2 * kRowThreads) && (r == 0 || r == 8) && H <= kPreMaxHeads &&
         ksplit <= kPreMaxKSplit;
}

// The sums over the warp's lanes of each of a lane's R values, by warp_sum's
// xor tree (lane offsets 16, 8, 4, 2, 1), but while more than one value is
// left a lane gives half of them away at each level: where its offset bit is
// set it keeps the upper half and sends the lower, else the other way round.
// Each sum it forms is the sum warp_sum forms at that node (fp32 addition is
// commutative), so the result equals warp_sum of that value. Returns the sum
// of value lane / (32 / R), which lanes (32 / R) c .. (32 / R) (c + 1) - 1 hold.
template <int R>
__device__ __forceinline__ float warp_sum_columns(const float (&v)[R], int lane) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R a power of two up to 32");
  float cur[R];
#pragma unroll
  for (int c = 0; c < R; ++c) cur[c] = v[c];
#pragma unroll
  for (int level = 0; level < 5; ++level) {
    const int off = 16 >> level;
    const int half = (R >> level) / 2;  // values given away at this level; 0 once one is left
    if (half > 0) {
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int c = 0; c < half; ++c) {
        const float mine = up ? cur[c + half] : cur[c];
        const float other = up ? cur[c] : cur[c + half];
        cur[c] = mine + __shfl_xor_sync(0xffffffffu, other, off);
      }
    } else {
      cur[0] += __shfl_xor_sync(0xffffffffu, cur[0], off);
    }
  }
  return cur[0];
}

// E elements a thread (d = 1,024 E), LoRA rank R
template <int E, int R>
__global__ void __launch_bounds__(kRowThreads) k4_prenorm_early_kernel(K4Args a, int layer) {
  using bf16 = __nv_bfloat16;
  constexpr int kWarps = kRowThreads / 32;
  __shared__ float warp_ss[kWarps];
  if (OMT_K4_PRE_SKIP & 8) return;

  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = static_cast<size_t>(b) * (E * kRowThreads);

  // no running kernel writes the layer's weights: they are asked for first
  unsigned short w_raw[E];
  uint4 a_raw[E][R > 0 ? R / 8 : 1];
  {
    const unsigned short* wp =
        reinterpret_cast<const unsigned short*>(layer_ptr<bf16>(a, kNormW, layer));
    const uint4* ap = reinterpret_cast<const uint4*>(layer_ptr<bf16>(a, kLoraA, layer));
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = t + k * kRowThreads;
      w_raw[k] = (OMT_K4_PRE_SKIP & 2) ? 0x3f80 : __ldg(wp + i);  // 0x3f80: bf16 one
#pragma unroll
      for (int q = 0; q < R / 8; ++q)
        a_raw[k][q] = (OMT_K4_PRE_SKIP & 2) ? make_uint4(0, 0, 0, 0)
                                            : __ldg(ap + static_cast<size_t>(i) * (R / 8) + q);
    }
  }
  if (OMT_K4_PRE_SKIP & 32) grid_launch_dependents();
  grid_dependency_wait();  // the out_proj's partials and the sums of squares are visible
  // the in_proj's blocks may start and fetch W_in; they read hn and hn @ A
  // only once this kernel has ended
  if (!(OMT_K4_PRE_SKIP & (32 | 64 | 256))) grid_launch_dependents();

  float* res = a.res + row;
  float v[E];
  if (layer == 0) {
    const bf16* h = static_cast<const bf16*>(a.h_in) + row;
    const float* rin = (a.res_in != nullptr) ? a.res_in + row : nullptr;
    float hv[E], rv[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      hv[k] = to_float(h[t + k * kRowThreads]);
      rv[k] = (rin != nullptr) ? rin[t + k * kRowThreads] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = (rin != nullptr) ? __fadd_rn(hv[k], rv[k]) : hv[k];
  } else {
    // every load of the row goes out before the first use of a loaded value
    constexpr bool kRead = !(OMT_K4_PRE_SKIP & 1);
    float sq[kPreMaxHeads / 32], p[kPreMaxKSplit][E], r0[E];
    const int heads = a.H * a.tp, splits = a.ksplit * a.tp;
#pragma unroll
    for (int j = 0; j < kPreMaxHeads / 32; ++j)
      sq[j] = (kRead && lane + 32 * j < heads) ? sumsq_at(a, b, lane + 32 * j) : 0.0f;
#pragma unroll
    for (int s = 0; s < kPreMaxKSplit; ++s)
#pragma unroll
      for (int k = 0; k < E; ++k)
        p[s][k] = (kRead && s < splits) ? part_at(a, s, b)[t + k * kRowThreads] : 0.0f;
#pragma unroll
    for (int k = 0; k < E; ++k) r0[k] = res[t + k * kRowThreads];

    // gated_rstd: heads lane, lane + 32, ... in that order, then the lanes' tree
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < kPreMaxHeads / 32; ++j)
      if (lane + 32 * j < heads) total = __fadd_rn(total, sq[j]);
    total = warp_sum(total);
    const float rstd_prev = rsqrtf(
        __fadd_rn(__fdiv_rn(total, static_cast<float>(a.d_inner * a.tp)), a.gn_eps));
    // finished_out_proj: the K splits in split order, times rstd, rounded to bf16
#pragma unroll
    for (int k = 0; k < E; ++k) {
      float o = 0.0f;
#pragma unroll
      for (int s = 0; s < kPreMaxKSplit; ++s)
        if (s < splits) o = __fadd_rn(o, p[s][k]);
      v[k] = __fadd_rn(to_float(from_float<bf16>(__fmul_rn(o, rstd_prev))), r0[k]);
    }
  }

  // the row's sum of squares: block_sum's tree, one barrier (warp_ss is fresh)
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    res[t + k * kRowThreads] = v[k];
    ss = __fmaf_rn(v[k], v[k], ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (OMT_K4_PRE_SKIP & 256) grid_launch_dependents();
  ss = warp_sum(warp_ss[lane]);
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(a.d)), a.norm_eps));

  bf16* hn = static_cast<bf16*>(a.hn) + row;
  float x[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float wk = __uint_as_float(static_cast<unsigned int>(w_raw[k]) << 16);
    const bf16 q = __float2bfloat16_rn(__fmul_rn(__fmul_rn(v[k], rstd), wk));
    hn[t + k * kRowThreads] = q;
    x[k] = __bfloat162float(q);
  }
  if (OMT_K4_PRE_SKIP & 64) grid_launch_dependents();

  if constexpr (R > 0) {
    if (OMT_K4_PRE_SKIP & 4) return;
    // hn @ A: a thread's elements in i order, one fma chain a column
    float acc[R];
#pragma unroll
    for (int c = 0; c < R; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < E; ++k)
#pragma unroll
      for (int q = 0; q < R / 8; ++q) {
        const uint32_t u[4] = {a_raw[k][q].x, a_raw[k][q].y, a_raw[k][q].z, a_raw[k][q].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
          acc[8 * q + 2 * e] = __fmaf_rn(x[k], f.x, acc[8 * q + 2 * e]);
          acc[8 * q + 2 * e + 1] = __fmaf_rn(x[k], f.y, acc[8 * q + 2 * e + 1]);
        }
      }
    __shared__ float warp_hA[kWarps][R];
    constexpr int kLanesPerColumn = 32 / R;
    const float col = warp_sum_columns<R>(acc, lane);
    if (lane % kLanesPerColumn == 0) warp_hA[warp][lane / kLanesPerColumn] = col;
    __syncthreads();
    if (t < R) {  // the warps' sums in warp order
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, warp_hA[w][t]);
      a.hA[static_cast<size_t>(b) * R + t] = total;
    }
  }
}

// after the last layer: h_out = the finished out_proj of that layer
template <typename IO>
__global__ void __launch_bounds__(kRowThreads) k4_finish_kernel(K4Args a) {
  __shared__ float rstd_prev;
  const int b = blockIdx.x;
  if (threadIdx.x < 32) {
    const float r = gated_rstd(a, b, threadIdx.x);
    if (threadIdx.x == 0) rstd_prev = r;
  }
  __syncthreads();
  const float rstd = rstd_prev;
  IO* out = static_cast<IO*>(a.h_out) + static_cast<size_t>(b) * a.d;
  for (int i = threadIdx.x; i < a.d; i += kRowThreads)
    out[i] = from_float<IO>(finished_out_proj<IO>(a, b, i, rstd));
}

// ---------------------------------------------------------------------------
// the product of phases 2 and 4: C[m0:m0+16, n0:n0+64] += A[:, k] W[k, :]
// ---------------------------------------------------------------------------
// fp32 multiply-adds over shared-memory tiles. 128 threads; a thread owns a
// 2 x 4 patch of the 16 x 64 tile. The next k tile is fetched into registers
// while the current one is multiplied. Columns past N and k past k_end read
// as zero. The sum over k runs in k order inside one thread.

constexpr int kBM = 16, kBN = 64, kBK = 32, kTM = 2, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 128
constexpr int kAsStride = kBM + 2;  // floats; keeps the float2 reads 8-byte aligned
constexpr int kWLoads = kBK * kBN / 4 / kGemmThreads;  // float4 loads of W per thread: 4
static_assert(kGemmThreads * 4 == kBM * kBK, "one 4-element A load per thread");
static_assert(kWLoads * 4 * kGemmThreads == kBK * kBN, "W tile divides evenly");

// Four consecutive elements as they lie in memory, converted to fp32 only when
// they are stored to shared memory: the loads of a tile are then started back
// to back, with no use of a loaded value (and no branch) between them.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
template <>
struct Raw4<int8_t> {
  using type = char4;
};

__device__ __forceinline__ float4 load_raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ uint2 load_raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ char4 load_raw4(const int8_t* p) {
  return *reinterpret_cast<const char4*>(p);
}
__device__ __forceinline__ float4 raw_to_float4(float4 r) { return r; }
__device__ __forceinline__ float4 raw_to_float4(char4 r) {
  return make_float4(static_cast<float>(r.x), static_cast<float>(r.y), static_cast<float>(r.z),
                     static_cast<float>(r.w));
}
__device__ __forceinline__ float4 raw_to_float4(uint2 r) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ float4 ldg4(const T* p) {
  return raw_to_float4(__ldg(reinterpret_cast<const typename Raw4<T>::type*>(p)));
}

// p[0..3] where in < n of them exist; the rest read as zero
__device__ __forceinline__ float4 load_guarded4(const float* p, int n) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ uint2 load_guarded4(const __nv_bfloat16* p, int n) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned int e[4] = {0u, 0u, 0u, 0u};  // the bits of a bf16 zero are zero
  for (int i = 0; i < 4; ++i)
    if (i < n) e[i] = q[i];
  return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
}
__device__ __forceinline__ char4 load_guarded4(const int8_t* p, int n) {
  char4 v = make_char4(0, 0, 0, 0);
  if (n > 0) v.x = p[0];
  if (n > 1) v.y = p[1];
  if (n > 2) v.z = p[2];
  if (n > 3) v.w = p[3];
  return v;
}

// the column scales s[col .. col + 3] of an int8 projection, zero past n
__device__ __forceinline__ float4 scale4(const float* s, int col, int n) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col < n) v.x = s[col];
  if (col + 1 < n) v.y = s[col + 1];
  if (col + 2 < n) v.z = s[col + 2];
  if (col + 3 < n) v.w = s[col + 3];
  return v;
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

template <typename PW>
constexpr bool kInt8 = std::is_same<PW, int8_t>::value;

// Fetch the (kBM x kBK) A tile and the (kBK x kBN) W tile at k0 into
// registers. A holds rows of io-typed activations with row stride K (the
// normed hidden state for in_proj, the gated and weighted yf for out_proj).
// An interior tile (whole in k and in columns, everything aligned) takes one
// vector load per item; the edge takes guarded element loads. Rows
// past M are read from row M - 1: their results are never written.
template <typename IO, typename WT>
__device__ __forceinline__ void gemm_fetch(const IO* __restrict__ A, int K,
                                           const WT* __restrict__ Wm, int ldw, int M, int N,
                                           int m0, int n0, int k0, int k_end, bool aligned,
                                           typename Raw4<IO>::type& a_reg,
                                           typename Raw4<WT>::type (&w_reg)[kWLoads]) {
  const int tid = threadIdx.x;
  const int a_row = min(m0 + tid / (kBK / 4), M - 1);
  const int a_k = k0 + (tid % (kBK / 4)) * 4;
  if (aligned && k0 + kBK <= k_end && n0 + kBN <= N) {
    a_reg = load_raw4(A + static_cast<size_t>(a_row) * K + a_k);
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int idx = tid + j * kGemmThreads;
      w_reg[j] = load_raw4(Wm + static_cast<size_t>(k0 + idx / (kBN / 4)) * ldw + n0 +
                           (idx % (kBN / 4)) * 4);
    }
  } else {
    a_reg = load_guarded4(A + static_cast<size_t>(a_row) * K + min(a_k, k_end - 1), k_end - a_k);
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int idx = tid + j * kGemmThreads;
      const int gk = k0 + idx / (kBN / 4);
      const int gc = n0 + (idx % (kBN / 4)) * 4;
      const int n = (gk < k_end) ? N - gc : 0;
      w_reg[j] = load_guarded4(
          Wm + static_cast<size_t>(min(gk, k_end - 1)) * ldw + min(gc, N - 1), n);
    }
  }
}

template <typename ARaw, typename WRaw>
__device__ __forceinline__ void gemm_stash(const ARaw& a_reg, const WRaw (&w_reg)[kWLoads],
                                           float* As, float* Ws) {
  const int tid = threadIdx.x;
  const int a_row = tid / (kBK / 4);
  const int a_k = (tid % (kBK / 4)) * 4;
  const float4 av = raw_to_float4(a_reg);
  As[(a_k + 0) * kAsStride + a_row] = av.x;
  As[(a_k + 1) * kAsStride + a_row] = av.y;
  As[(a_k + 2) * kAsStride + a_row] = av.z;
  As[(a_k + 3) * kAsStride + a_row] = av.w;
#pragma unroll
  for (int j = 0; j < kWLoads; ++j) {
    const int idx = tid + j * kGemmThreads;
    store4(Ws + (idx / (kBN / 4)) * kBN + (idx % (kBN / 4)) * 4, raw_to_float4(w_reg[j]));
  }
}

template <typename IO, typename WT>
__device__ __forceinline__ void gemm_tile(const IO* __restrict__ A, int K,
                                          const WT* __restrict__ Wm, int ldw, int M, int N,
                                          int m0, int n0, int k_begin, int k_end,
                                          float (&acc)[kTM][kTN], float* As, float* Ws) {
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  const bool aligned = K % 4 == 0 && ldw % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(A) % (4 * sizeof(IO)) == 0 &&
                       reinterpret_cast<uintptr_t>(Wm) % (4 * sizeof(WT)) == 0;
  typename Raw4<IO>::type a_reg;
  typename Raw4<WT>::type w_reg[kWLoads];

  if (k_begin >= k_end) return;
  gemm_fetch(A, K, Wm, ldw, M, N, m0, n0, k_begin, k_end, aligned, a_reg, w_reg);
  gemm_stash(a_reg, w_reg, As, Ws);
  __syncthreads();
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const bool more = k0 + kBK < k_end;
    if (more) gemm_fetch(A, K, Wm, ldw, M, N, m0, n0, k0 + kBK, k_end, aligned, a_reg, w_reg);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float2 av = *reinterpret_cast<const float2*>(As + kk * kAsStride + ty * kTM);
      const float4 wv = load4(Ws + kk * kBN + tx * kTN);
      acc[0][0] += av.x * wv.x;
      acc[0][1] += av.x * wv.y;
      acc[0][2] += av.x * wv.z;
      acc[0][3] += av.x * wv.w;
      acc[1][0] += av.y * wv.x;
      acc[1][1] += av.y * wv.y;
      acc[1][2] += av.y * wv.z;
      acc[1][3] += av.y * wv.w;
    }
    __syncthreads();  // every thread is done with this tile
    if (more) gemm_stash(a_reg, w_reg, As, Ws);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// phase 2: in_proj + LoRA, then conv step / softplus on the finished columns
// ---------------------------------------------------------------------------

// What follows the product for one finished element (row, col) of in_proj,
// `v` with its LoRA term already added.
template <typename IO, typename WT>
__device__ __forceinline__ void in_proj_place(const K4Args& a, int layer, int row, int col,
                                              float v) {
  const int conv_ch = a.d_inner + 2 * a.N;
  if (col < a.d_inner) {
    a.z[static_cast<size_t>(row) * a.d_inner + col] = v;
  } else if (col < a.d_inner + conv_ch) {
    // shift register: taps oldest first; the newest tap is the raw value
    const int c = col - a.d_inner;
    const int taps = a.W - 1;
    const WT* conv_w = layer_ptr<WT>(a, kConvW, layer);  // (W, conv_ch)
    IO* win = static_cast<IO*>(a.conv_state) +
              (static_cast<size_t>(layer) * a.B + row) * taps * conv_ch + c;
    float y = v * to_float(conv_w[static_cast<size_t>(taps) * conv_ch + c]);
    for (int t = 0; t < taps; ++t) {
      const IO tap = win[static_cast<size_t>(t) * conv_ch];
      y += to_float(tap) * to_float(conv_w[static_cast<size_t>(t) * conv_ch + c]);
      if (t > 0) win[static_cast<size_t>(t - 1) * conv_ch] = tap;
    }
    if (taps > 0) win[static_cast<size_t>(taps - 1) * conv_ch] = from_float<IO>(v);
    y += to_float(layer_ptr<WT>(a, kConvB, layer)[c]);
    a.xbc[static_cast<size_t>(row) * conv_ch + c] = silu(y);
  } else {
    const int hh = col - a.d_inner - conv_ch;
    const float u = v + to_float(layer_ptr<WT>(a, kDtBias, layer)[hh]);
    // softplus, linear above 20 like torch.nn.functional.softplus
    a.dt[static_cast<size_t>(row) * a.Hdt + hh] = (u > 20.0f) ? u : log1pf(expf(u));
  }
}

// acc += s * w and acc += x * w, element by element
__device__ __forceinline__ void axpy4(float4& acc, float s, const float4& w) {
  acc.x += s * w.x; acc.y += s * w.y; acc.z += s * w.z; acc.w += s * w.w;
}
__device__ __forceinline__ void mad4(float4& acc, const float4& x, const float4& w) {
  acc.x += x.x * w.x; acc.y += x.y * w.y; acc.z += x.z * w.z; acc.w += x.w * w.w;
}

// What follows the product for the four consecutive columns col .. col + 3
// (col a multiple of 4) of ROWS rows of in_proj: the LoRA term is added from
// the rows' hn @ A (`hA[i]`, r floats each), then z is stored, the conv step
// or the softplus is done. Rows past B are computed on clamped reads and
// never written. With `vec` every class of columns begins at a multiple of 4
// and every operand takes 4-element vector accesses: the per-column operands
// are then loaded once per thread and the loads of different rows do not wait
// for each other. Without it, and for a conv window that is not 4 taps, each
// element goes through `in_proj_place`.
template <typename IO, typename WT, int ROWS>
__device__ __forceinline__ void in_proj_finish4(const K4Args& a, int layer,
                                                const int (&rows)[ROWS],
                                                const float* const (&hA)[ROWS], int col,
                                                float4 (&v)[ROWS], bool vec) {
  using IORaw = typename Raw4<IO>::type;
  const int conv_ch = a.d_inner + 2 * a.N;
  const int n_in = a.d_inner + conv_ch + a.Hdt;
  if (!vec) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      const float vs[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j >= n_in) continue;
        float e = vs[j];
        if (a.r > 0) {
          const WT* lora_b = layer_ptr<WT>(a, kLoraB, layer);  // (r, n_in)
          float lo = 0.0f;
          for (int q = 0; q < a.r; ++q)
            lo += hA[i][q] * to_float(lora_b[static_cast<size_t>(q) * n_in + col + j]);
          e += a.lora_scale * lo;
        }
        in_proj_place<IO, WT>(a, layer, rows[i], col + j, e);
      }
    }
    return;
  }
  if (col >= n_in) return;
  if (a.r > 0) {
    const WT* lora_b = layer_ptr<WT>(a, kLoraB, layer) + col;  // (r, n_in)
    float4 lo[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) lo[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = 0; q < a.r; ++q) {
      const float4 lb = ldg4(lora_b + static_cast<size_t>(q) * n_in);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) axpy4(lo[i], hA[i][q], lb);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) axpy4(v[i], a.lora_scale, lo[i]);
  }

  if (col < a.d_inner) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (rows[i] < a.B) store4(a.z + static_cast<size_t>(rows[i]) * a.d_inner + col, v[i]);
  } else if (col < a.d_inner + conv_ch && a.W == 4) {
    // the 4-tap shift register of every shipped config, three old taps a row
    const int c = col - a.d_inner;
    const WT* conv_w = layer_ptr<WT>(a, kConvW, layer) + c;  // (4, conv_ch)
    const float4 w0 = ldg4(conv_w), w1 = ldg4(conv_w + conv_ch);
    const float4 w2 = ldg4(conv_w + 2 * conv_ch), w3 = ldg4(conv_w + 3 * conv_ch);
    const float4 bias = ldg4(layer_ptr<WT>(a, kConvB, layer) + c);
    IO* const base = static_cast<IO*>(a.conv_state) +
                     static_cast<size_t>(layer) * a.B * 3 * conv_ch + c;
    IORaw t0[ROWS], t1[ROWS], t2[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const IO* win = base + static_cast<size_t>(min(rows[i], a.B - 1)) * 3 * conv_ch;
      t0[i] = load_raw4(win);
      t1[i] = load_raw4(win + conv_ch);
      t2[i] = load_raw4(win + 2 * conv_ch);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      float4 y = make_float4(v[i].x * w3.x, v[i].y * w3.y, v[i].z * w3.z, v[i].w * w3.w);
      mad4(y, raw_to_float4(t0[i]), w0);
      mad4(y, raw_to_float4(t1[i]), w1);
      mad4(y, raw_to_float4(t2[i]), w2);
      y.x += bias.x; y.y += bias.y; y.z += bias.z; y.w += bias.w;
      IO* win = base + static_cast<size_t>(rows[i]) * 3 * conv_ch;
      *reinterpret_cast<IORaw*>(win) = t1[i];
      *reinterpret_cast<IORaw*>(win + conv_ch) = t2[i];
      store4(win + 2 * conv_ch, v[i]);
      store4(a.xbc + static_cast<size_t>(rows[i]) * conv_ch + c,
             make_float4(silu(y.x), silu(y.y), silu(y.z), silu(y.w)));
    }
  } else {
    // dt columns, and the conv columns of another tap count
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      in_proj_place<IO, WT>(a, layer, rows[i], col, v[i].x);
      in_proj_place<IO, WT>(a, layer, rows[i], col + 1, v[i].y);
      in_proj_place<IO, WT>(a, layer, rows[i], col + 2, v[i].z);
      in_proj_place<IO, WT>(a, layer, rows[i], col + 3, v[i].w);
    }
  }
}

template <typename IO, typename WT, typename PW>
__global__ void __launch_bounds__(kGemmThreads) k4_in_proj_kernel(K4Args a, int layer) {
  __shared__ __align__(16) float As[kBK * kAsStride];
  __shared__ __align__(16) float Ws[kBK * kBN];
  static_assert(kTN == 4, "the epilogue takes four columns a thread");

  const int n_in = 2 * a.d_inner + 2 * a.N + a.Hdt;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  float acc[kTM][kTN] = {};
  gemm_tile(static_cast<const IO*>(a.hn), a.d, layer_ptr<PW>(a, kInProj, layer), n_in, a.B, n_in,
            m0, n0, 0, a.d, acc, As, Ws);

  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  int rows[kTM];
  const float* hA[kTM];
  float4 v[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    rows[i] = m0 + ty * kTM + i;
    hA[i] = a.hA + static_cast<size_t>(min(rows[i], a.B - 1)) * a.r;
    v[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if constexpr (kInt8<PW>) {
    const float4 sc = scale4(layer_ptr<float>(a, kInScale, layer), n0 + tx * kTN, n_in);
#pragma unroll
    for (int i = 0; i < kTM; ++i) v[i] = mul4(v[i], sc);
  }
  in_proj_finish4<IO, WT, kTM>(a, layer, rows, hA, n0 + tx * kTN, v, a.vec4 != 0);
}

// ---------------------------------------------------------------------------
// phase 3: SSM update in place, yf = (y + D x) silu(z), yf * w_gn, sums of yf^2
// ---------------------------------------------------------------------------

constexpr int kSsmThreads = 256;

template <typename IO, typename WT, typename ST>
__global__ void __launch_bounds__(kSsmThreads) k4_ssm_kernel(K4Args a, int layer) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // N floats
  float* Cs = Bs + a.N;                         // N floats
  __shared__ float warp_ss[kSsmThreads / 32];

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int conv_ch = a.d_inner + 2 * a.N;
  const float* xrow = a.xbc + static_cast<size_t>(b) * conv_ch;
  for (int n = threadIdx.x; n < a.N; n += kSsmThreads) {
    Bs[n] = xrow[a.d_inner + n];
    Cs[n] = xrow[a.d_inner + a.N + n];
  }
  __syncthreads();

  const float dtv = a.dt[static_cast<size_t>(b) * a.Hdt + a.h0 + h];
  const float A = -expf(to_float(layer_ptr<WT>(a, kALog, layer)[h]));
  const float decay = expf(dtv * A);
  const float Dv = to_float(layer_ptr<WT>(a, kD, layer)[h]);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ST* sp = static_cast<ST*>(a.ssm_state) +
           (static_cast<size_t>(layer) * a.B * a.H + bh) * a.P * a.N;
  const size_t chan = static_cast<size_t>(b) * a.d_inner + static_cast<size_t>(h) * a.P;
  const WT* gn_w = layer_ptr<WT>(a, kGnW, layer) + static_cast<size_t>(h) * a.P;
  IO* ya = static_cast<IO*>(a.ya) + chan;

  float ss = 0.0f;  // lane 0 of each warp: sum of yf^2 over the warp's rows, in p order
  for (int p = warp; p < a.P; p += kSsmThreads / 32) {
    // read before the row is streamed: these loads then wait behind nothing
    const float xv = xrow[h * a.P + p];
    const float zv = a.z[chan + p];
    const float gw = to_float(gn_w[p]);
    const float acc =
        ssd_step_row(sp + static_cast<size_t>(p) * a.N, Bs, Cs, decay, dtv * xv, a.N, lane);
    if (lane == 0) {
      const float yf = (acc + Dv * xv) * silu(zv);
      ya[p] = from_float<IO>(yf * gw);
      ss += yf * yf;
    }
  }
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kSsmThreads / 32; ++w) total += warp_ss[w];
    a.sumsq_out[bh] = total;
  }
}

// ---------------------------------------------------------------------------
// phase 3 on tiles of at most 64 x 128: every state load of a tile in flight at once
// ---------------------------------------------------------------------------
// k4_ssm_kernel above keeps one 256-byte state row in flight per warp: a lane
// loads its 4 elements, updates them, stores them and sums the row with
// shuffles before the next row's load is issued, every block first waits for
// its B, C, dt and the weights' loads and a barrier, and lane 0 finishes the
// warp's rows one after another. That reaches about 60% of the card's memory
// rate. Here, with the same layout (one block of 8 warps per (row, head), warp
// w owning rows p = w, w + 8, ... and lane l elements n = 4 l .. 4 l + 3 of
// each), a warp issues the loads of all its rows (up to 8 x 8 bytes a lane in
// bf16, 8 x 16 in fp32) before anything else, so a block has its whole tile
// (16 KB in bf16) in flight from its first cycles; the weights it reads
// (A_log, D, the gated norm's weight) follow. The kernel is a programmatic
// dependent of the in_proj, whose blocks let it start once the pre-norm has
// ended: the first blocks' loads (the state of this layer was written one
// token earlier) then share the memory with the in_proj's weight stream,
// which alone leaves part of the card's rate unused, and only after
// griddepcontrol.wait does a block read the in_proj's outputs (B, C, x, z,
// dt) and write anything.
// Each lane reads the B and C of its own n and lane i the x and z of the
// warp's row i, so no barrier stands before the update, and the gate (an exp
// and a division a row) runs on the warp's rows in parallel, one a lane. The
// arithmetic is k4_ssm_kernel's (and the step kernel's row code) in its order
// and contraction, written out with intrinsics: s' = fma(s, decay, dtx B[n])
// element by element, a lane's four products over n in n order, warp_sum's
// butterfly, yf^2 summed over the warp's rows in p order (the rows' yf moved
// to lane 0 by shuffles), the 8 warp totals in warp order by thread 0; so
// every output keeps its bits. The launch takes this kernel for P a multiple
// of 8 up to 64 and N a multiple of 4 up to 128 (`ssm_tile_fits`: every
// shipped config) and k4_ssm_kernel for other shapes.

// Measurement only: tools/ablation.py k4-ssm builds this file with
// OMT_K4_SSM_SKIP set to a sum of 1 (no state loads: the update reads zeros)
// and 2 (no state stores), or to 16 (the launch alone), to time what is left of
// the phase, whose results are then wrong; or to 4 (an ordinary launch, no
// programmatic dependency), 8 (the in_proj lets it start only as its blocks
// end), 32 (the state loads after griddepcontrol.wait) or 64 (the in_proj lets
// it start near the end of its k loop, not once the pre-norm has ended), which
// change when work starts and give the shipped bits. The library has 0.
#ifndef OMT_K4_SSM_SKIP
#define OMT_K4_SSM_SKIP 0
#endif

// Measurement only: tools/ablation.py k4-out-proj (k4-out-proj-int8 on int8
// layers) builds this file with OMT_K4_OUT_SKIP set to a sum of 1 (no
// activation copies), 2 (no weight copies), 4 (no products) and 8 (no
// exchange of the sums and no stores), or to 16 (the launch alone), to time
// what is left of the pair out_proj (bf16 or int8), whose results are then
// wrong; or to 32 (an ordinary launch, no programmatic dependency), 64 (no
// weights asked for before the SSM update ends), 128 (the SSM update lets the
// out_proj start at its blocks' entry, not once their griddepcontrol.wait has
// returned), 256 (... once they have issued their state stores), 512 (...
// only as they end) or 1024 (the out_proj does not let the next pre-norm start
// before its blocks end), which change when work starts and give the shipped
// bits. The library has 0.
#ifndef OMT_K4_OUT_SKIP
#define OMT_K4_OUT_SKIP 0
#endif

constexpr int kSsmTileRows = 8;  // rows a warp holds: P <= 8 warps x 8
constexpr int kSsmTileN = 128;   // four n a lane

__host__ __device__ constexpr bool ssm_tile_fits(int P, int N) {
  return P % 8 == 0 && P <= 8 * kSsmTileRows && N % 4 == 0 && N <= kSsmTileN;
}

// four floats rounded to the state type, as store4 rounds them
__device__ __forceinline__ float4 to_raw4(float4 v, float4*) { return v; }
__device__ __forceinline__ uint2 to_raw4(float4 v, uint2*) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                    *reinterpret_cast<const uint32_t*>(&hi));
}

// the raw state of this lane's elements in the warp's rows (row i at `tile` + i * step)
template <typename Raw>
__device__ __forceinline__ void ssm_tile_fetch(Raw (&raw)[kSsmTileRows], const Raw* tile,
                                               size_t step, int rows, bool on) {
#pragma unroll
  for (int i = 0; i < kSsmTileRows; ++i)
    if (i < rows && on && !(OMT_K4_SSM_SKIP & 1)) raw[i] = __ldcs(tile + i * step);
}

// blocks an SM that the register budget must allow: five with a bf16 state (at
// most 51 registers a thread), four with an fp32 one (64)
template <typename ST>
constexpr int kSsmTileBlocks = sizeof(ST) == 2 ? 5 : 4;

template <typename IO, typename WT, typename ST>
__global__ void __launch_bounds__(kSsmThreads, kSsmTileBlocks<ST>)
k4_ssm_tile_kernel(K4Args a, int layer) {
  using Raw = typename Raw4<ST>::type;
  __shared__ float warp_ss[kSsmThreads / 32];
  if (OMT_K4_SSM_SKIP & 16) return;
  // the pair out_proj is launched as a programmatic dependent of this kernel:
  // once every block has triggered, its blocks may start and fetch W_out; they
  // read yf * w_gn only once this kernel has ended
  if (OMT_K4_OUT_SKIP & 128) grid_launch_dependents();

  const int bh = blockIdx.x;
  const int b = bh / a.H;
  const int h = bh - b * a.H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = a.P / 8;  // this warp's rows: p = warp + 8 i, i < rows
  const int n = lane * 4;    // this lane's elements n .. n + 3
  const bool on = n < a.N;
  // this lane's first element in row `warp` of the tile; row p + 8 lies 8 N on
  Raw* tile = reinterpret_cast<Raw*>(static_cast<ST*>(a.ssm_state) +
                                     (static_cast<size_t>(layer) * a.B * a.H + bh) * a.P * a.N +
                                     static_cast<size_t>(warp) * a.N + n);
  const size_t step = 2 * static_cast<size_t>(a.N);  // 8 N elements in units of 4

  Raw raw[kSsmTileRows] = {};
  // the state does not come from the in_proj: its loads go first
  if (!(OMT_K4_SSM_SKIP & 32)) ssm_tile_fetch(raw, tile, step, rows, on);
  // lane i < rows holds what row p = warp + 8 i needs besides the state (the
  // other lanes a copy of the last row's)
  const int own = warp + 8 * min(lane, rows - 1);
  const float A = -expf(to_float(layer_ptr<WT>(a, kALog, layer)[h]));
  const float Dv = to_float(layer_ptr<WT>(a, kD, layer)[h]);
  const float gw = to_float(layer_ptr<WT>(a, kGnW, layer)[static_cast<size_t>(h) * a.P + own]);

  grid_dependency_wait();  // the in_proj's outputs are complete and visible
  // its state loads are out and the in_proj has ended: the out_proj may start
  if (!(OMT_K4_OUT_SKIP & (128 | 256 | 512))) grid_launch_dependents();
  if (OMT_K4_SSM_SKIP & 32) ssm_tile_fetch(raw, tile, step, rows, on);
  const int conv_ch = a.d_inner + 2 * a.N;
  const float* xrow = a.xbc + static_cast<size_t>(b) * conv_ch;
  const size_t chan = static_cast<size_t>(b) * a.d_inner + static_cast<size_t>(h) * a.P;
  float4 bq = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cq = bq;
  if (on) {
    const float* bp = xrow + a.d_inner + n;
    const float* cp = bp + a.N;
    bq = make_float4(bp[0], bp[1], bp[2], bp[3]);
    cq = make_float4(cp[0], cp[1], cp[2], cp[3]);
  }
  const float xv = xrow[h * a.P + own];
  const float zv = a.z[chan + own];
  const float dtv = a.dt[static_cast<size_t>(b) * a.Hdt + a.h0 + h];
  const float decay = expf(__fmul_rn(dtv, A));

  // Each product and multiply-add is written out as k4_ssm_kernel's code
  // compiles (its SASS): s' = fma(s, decay, dtx * B[n]), the four products
  // fma(s3, c3, fma(s2, c2, fma(s0, c0, s1 * c1))) added to the lane's sum, so
  // the compiler cannot contract them another way here
  float acc[kSsmTileRows];
#pragma unroll
  for (int i = 0; i < kSsmTileRows; ++i) {
    acc[i] = 0.0f;
    if (i >= rows) continue;
    const float dtx = __fmul_rn(dtv, __shfl_sync(0xffffffffu, xv, i));
    if (!on) continue;
    float4 s = raw_to_float4(raw[i]);
    s.x = __fmaf_rn(s.x, decay, __fmul_rn(dtx, bq.x));
    s.y = __fmaf_rn(s.y, decay, __fmul_rn(dtx, bq.y));
    s.z = __fmaf_rn(s.z, decay, __fmul_rn(dtx, bq.z));
    s.w = __fmaf_rn(s.w, decay, __fmul_rn(dtx, bq.w));
    const float dot = __fmaf_rn(s.w, cq.w, __fmaf_rn(s.z, cq.z,
                                                     __fmaf_rn(s.x, cq.x, __fmul_rn(s.y, cq.y))));
    acc[i] = __fadd_rn(acc[i], dot);
    if (!(OMT_K4_SSM_SKIP & 2)) __stcs(tile + i * step, to_raw4(s, static_cast<Raw*>(nullptr)));
  }
  if (OMT_K4_OUT_SKIP & 256) grid_launch_dependents();
  // warp_sum of each row, the rows' shuffles interleaved: every lane gets y
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < kSsmTileRows; ++i)
      if (i < rows) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);

  // lane i < rows finishes row warp + 8 i; lane 0 sums yf^2 over them in p order
  float y = acc[0];
#pragma unroll
  for (int i = 1; i < kSsmTileRows; ++i)
    if (lane == i) y = acc[i];
  const float yf = __fmul_rn(__fmaf_rn(Dv, xv, y), silu(zv));
  if (lane < rows) static_cast<IO*>(a.ya)[chan + own] = from_float<IO>(__fmul_rn(yf, gw));
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kSsmTileRows; ++i) {
    if (i >= rows) break;
    const float yi = __shfl_sync(0xffffffffu, yf, i);
    ss = __fmaf_rn(yi, yi, ss);
  }
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kSsmThreads / 32; ++w) total += warp_ss[w];
    a.sumsq_out[bh] = total;
  }
}

// phase 3 of `layer`: the tile kernel, a programmatic dependent of the in_proj,
// where the shape fits it, k4_ssm_kernel otherwise
template <typename IO, typename WT, typename ST>
cudaError_t launch_ssm(const K4Args& a, int layer, cudaStream_t stream) {
  const unsigned int row_heads = static_cast<unsigned int>(a.B) * a.H;
  if (!ssm_tile_fits(a.P, a.N)) {
    const size_t bc_smem = 2 * static_cast<size_t>(a.N) * sizeof(float);
    k4_ssm_kernel<IO, WT, ST><<<row_heads, kSsmThreads, bc_smem, stream>>>(a, layer);
    return cudaGetLastError();
  }
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_heads);
  cfg.blockDim = dim3(kSsmThreads);
  cfg.stream = stream;
  if (!(OMT_K4_SSM_SKIP & 4)) {  // 4: an ordinary launch (measurement only)
    cfg.attrs = &pdl;
    cfg.numAttrs = 1;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k4_ssm_tile_kernel<IO, WT, ST>, a, layer);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// phase 4: out_proj of the gated, weighted yf into K-split partials
// ---------------------------------------------------------------------------

template <typename IO, typename PW>
__global__ void __launch_bounds__(kGemmThreads) k4_out_proj_kernel(K4Args a, int layer) {
  __shared__ __align__(16) float As[kBK * kAsStride];
  __shared__ __align__(16) float Ws[kBK * kBN];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int split = blockIdx.z;
  const int K = a.d_inner;
  const int per = ((K + a.ksplit - 1) / a.ksplit + kBK - 1) / kBK * kBK;
  const int k_begin = min(K, split * per);
  const int k_end = min(K, k_begin + per);

  float acc[kTM][kTN] = {};
  gemm_tile(static_cast<const IO*>(a.ya), K, layer_ptr<PW>(a, kOutProj, layer), a.d, a.B, a.d, m0,
            n0, k_begin, k_end, acc, As, Ws);

  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
  float* part = a.part_out + static_cast<size_t>(split) * a.B * a.d;
  float sc[kTN] = {1.0f, 1.0f, 1.0f, 1.0f};
  if constexpr (kInt8<PW>) {
    const float4 s4 = scale4(layer_ptr<float>(a, kOutScale, layer), n0 + tx * kTN, a.d);
    sc[0] = s4.x; sc[1] = s4.y; sc[2] = s4.z; sc[3] = s4.w;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty * kTM + i;
    if (row >= a.B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx * kTN + j;
      if (col < a.d)
        part[static_cast<size_t>(row) * a.d + col] = kInt8<PW> ? acc[i][j] * sc[j] : acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core products of bf16 activations: tile widths
// ---------------------------------------------------------------------------

constexpr int kTcBN = 64, kTcBK = 64;  // columns and k rows of a weight tile
constexpr int kTcMaxRank = 64;         // LoRA ranks above this take the multiply-add kernels

// the k width of each K split of the tensor-core out_proj, a whole number of
// k tiles (the last split may be shorter)
__host__ __device__ constexpr int tc_split_width(int K, int ksplit) {
  return ((K + ksplit - 1) / ksplit + kTcBK - 1) / kTcBK * kTcBK;
}

// ---------------------------------------------------------------------------
// phase 2 for bf16 activations and a bf16 or int8 in_proj: a two-block
// cluster per column tile
// ---------------------------------------------------------------------------
// The sum order of both tensor-core products: for every 64-wide k tile in k
// order, k in [0, 32) goes into a chain `lo` and k in [32, 64) into `hi`, each
// as two k16 steps of HMMA.16816.F32.BF16 in k order (one per n8 tile of
// columns), and the result is lo + hi. The two chains run in the two blocks
// of a cluster, rank 0 lo and rank 1 hi, each over all of K, so the card gets
// two blocks per column tile of 64 and no partial sum goes through device
// memory. Each block has four consumer warps (16 columns
// and the MT m16 tiles of the row tile each) and a producer warp that copies
// the block's half of each weight tile (32 k x 64 columns: 4 KB of bf16, 2 KB
// of int8) and of each activation tile (16 MT rows x 32 k) with one TMA copy
// each, swizzled so that the ldmatrix loads have no bank conflicts, into a
// ring of about 64 KB: a stage's `full` mbarrier counts its bytes, its `empty`
// mbarrier the consumer warps done with it, and no block-wide barrier stands
// in the k loop. Weights come by ldmatrix.trans from the (K, O) tile,
// activations by ldmatrix, into mma.sync m16n8k16. An int8 tile is read as
// byte pairs, one ldmatrix.trans for both k16 steps, and widened to bf16 in
// registers as K7's decode path does (qmatmul.cu pair_tiles; exact, |q| <=
// 127): the warp's two n8 tiles are then its even and its odd columns, where
// a bf16 tile gives columns 0-7 and 8-15, and the epilogue puts each sum at
// its column. The HMMA operands are the bf16 values of the int8 weights, so
// the products do not depend on where a column sits.
//
// The launch is a programmatic dependent of the pre-norm, which lets it start
// once the pre-norm's own griddepcontrol.wait has returned (k4_prenorm_kernel:
// at its first instruction): the producer asks for the first stages' weight
// tiles (which the pre-norm does not write) before griddepcontrol.wait, and
// for activation tiles only after it. Past that wait each block lets the SSM phase, launched as its
// own programmatic dependent, start. A block takes up to 96 rows (16 MT, MT
// from the batch; more rows take more row tiles) and three blocks share an SM,
// so at B <= 96 the weights are read once and every cluster of the grid is
// resident while the pre-norm runs.
//
// What follows the product is in_proj_finish4's arithmetic in its order (with
// int8 weights after lo + hi is multiplied by the column scale), laid
// out to shorten the tail after the last weight byte: the LoRA product (hn @
// A) @ B of a thread's rows and columns is summed before the k loop (it does
// not need the in_proj's), the epilogue's other operands are asked into L2
// while the weights stream, and the layer's weight pointers are looked up once.
// At the end the blocks trade halves through distributed shared memory: rank 0
// finishes rows 0-7 of every m16 tile and rank 1 rows 8-15, so each block
// sends its sums of the other rows to its peer with st.async, which counts
// their bytes on the peer's mbarrier (no fence). lo + hi (an fp32 sum is the
// same either way round) goes through shared memory once, so that a warp
// finishes whole 64-column rows (the conv windows and the stores take whole
// 128-byte lines), 4 columns of MT rows a thread. A row's bits therefore do
// not depend on B. Shapes are whole tiles (K and N multiples of 64, every row
// 16-byte aligned): the caller takes the multiply-add kernels otherwise. Rows
// past B read as zeros (the TMA copy fills them) and are never written.

// Measurement only: tools/ablation.py k4-in-proj builds this file with
// OMT_K4_IN_SKIP set to a sum of 1 (no activation copies), 2 (no weight
// copies), 4 (no products) and 8 (no epilogue: no exchange of the sums, no
// stores, conv step or softplus; the LoRA product is summed before the k loop
// either way), or to 16 (the launch alone), to time what is left of the
// in_proj (bf16 or int8), whose results are then wrong; or to 32 (no weights asked for before
// the pre-norm ends), 64 (an ordinary launch, no programmatic dependency) or
// 128 (no L2 prefetch of the epilogue's operands), which change when work
// starts and give the shipped bits. The library has 0.
#ifndef OMT_K4_IN_SKIP
#define OMT_K4_IN_SKIP 0
#endif

template <int MT, typename PW = __nv_bfloat16>
struct InPair {
  static constexpr int kWarps = kTcBN / 16;           // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
  // k tiles a stage: 4 for int8 weights up to 48 rows, whose consumers then
  // have four tiles' ldmatrix, widening and products to interleave (2 KB weight
  // tiles: the stage is still under 21 KB); 2 otherwise
  static constexpr int kS = (kInt8<PW> && MT <= 3) ? 4 : 2;
  static constexpr int kABytes = MT * 16 * 64;        // a k tile's activations: 16 MT rows x 32 bf16
  // a k tile's weights: 32 k x 64 of PW (bf16 4 KB, int8 2 KB)
  static constexpr int kWBytes = 32 * kTcBN * static_cast<int>(sizeof(PW));
  static constexpr int kStageBytes = kS * (kABytes + kWBytes);
  static constexpr int kSumsBytes = kWarps * MT * 4 * 32 * 4;  // the peer's half of the sums
  // about 64 KB of ring, and no more than three blocks an SM leave beside the
  // sums (int8 at 96 rows: 3 stages of 16 KB, not 4); at least 3 stages
  static constexpr int kRingStages = 65536 / kStageBytes;
  static constexpr int kFitStages = (73 * 1024 - kSumsBytes) / kStageBytes;
  static constexpr int kMost = kRingStages < kFitStages ? kRingStages : kFitStages;
  static constexpr int kStages = kMost < 3 ? 3 : kMost;
  static_assert(kStages * kStageBytes + kSumsBytes <= 73 * 1024, "three blocks an SM");
  static constexpr int kBytes = kStages * kStageBytes + kSumsBytes + 1024;  // + the ring's alignment
  // every tile a multiple of 1 KB: the swizzle of a TMA copy follows the
  // address bits, so a tile starts where its pattern starts
  static_assert(kABytes % 1024 == 0 && kWBytes % 1024 == 0, "1 KB aligned tiles");
};

// N k tiles of a landed stage (activation tiles from a_tile, weight tiles from
// w_tile on) into the accumulators of this warp's MT m16 tiles and two n8
// tiles, in k order: for each tile, the two k16 steps of this block's k half.
// a_off, b_off: this lane's ldmatrix offsets in a tile for k16 step h (int8:
// b_off[0] for both). With int8 weights n8 tile 0 holds the warp's even
// columns and n8 tile 1 its odd ones; with bf16 its columns 0-7 and 8-15.
template <int MT, int N, typename PW = __nv_bfloat16>
__device__ __forceinline__ void in_pair_tiles(float (&acc)[MT][2][4], const unsigned char* a_tile,
                                              const unsigned char* w_tile,
                                              const uint32_t (&a_off)[2],
                                              const uint32_t (&b_off)[2]) {
  using P = InPair<MT, PW>;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    // int8: r[i] holds k rows 8 i + 2c, 8 i + 2c + 1 of columns 2g, 2g + 1 (bytes
    // 0-1, 2-3); as byte pairs down k they widen into the B fragments of k16
    // step i / 2, column 2g (even tile) and 2g + 1 (odd tile)
    [[maybe_unused]] uint32_t wide[2][4];  // [k16 step][b0, b1 of the even n8 tile, then of the odd]
    if constexpr (kInt8<PW>) {
      uint32_t r[4];
      tc::ldsm4t(r, w_tile + u * P::kWBytes + b_off[0]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::widen4(__byte_perm(r[i], 0u, 0x3120), wide[i >> 1][i & 1], wide[i >> 1][2 + (i & 1)]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b[4];  // b0, b1 of the warp's first n8 tile, then of its second
      if constexpr (kInt8<PW>) {
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = wide[h][e];
      } else {
        tc::ldsm4t(b, w_tile + u * P::kWBytes + b_off[h]);
      }
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) tc::ldsm4(af[i], a_tile + u * P::kABytes + i * 1024 + a_off[h]);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        tc::mma(acc[i][0], af[i], b[0], b[1]);
        tc::mma(acc[i][1], af[i], b[2], b[3]);
      }
    }
  }
}

// a barrier of the first NW warps of the block (the consumers), not the producer
template <int NW>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NW * 32) : "memory");
}

// the layer's weights that the pair in_proj's epilogue reads, looked up in the
// pointer table once, before the k loop
struct InPairOps {
  const __nv_bfloat16* lora_b;   // (r, n_in)
  const __nv_bfloat16* conv_w;   // (W, conv_ch)
  const __nv_bfloat16* conv_b;   // (conv_ch)
  const __nv_bfloat16* dt_bias;  // (H)
};

// What the epilogue of the block reads that the pre-norm does not write, asked
// into L2 while the weights stream, one request a 128-byte line: thread 0 the
// block's LoRA B columns and conv weights and bias, or dt_bias; thread (cg, rl)
// of the finishing layout with cg = 0 the conv windows of its rows
template <int MT>
__device__ __forceinline__ void in_pair_prefetch(const K4Args& a, const InPairOps& ops, int layer,
                                                 int row0, int n0) {
  const int conv_ch = a.d_inner + 2 * a.N;
  const int n_in = a.d_inner + conv_ch + a.Hdt;
  const int ch = n0 - a.d_inner;
  const bool conv = ch >= 0 && ch < conv_ch;
  if (threadIdx.x == 0) {
    for (int q = 0; q < a.r; ++q) prefetch_l2(ops.lora_b + static_cast<size_t>(q) * n_in + n0);
    if (conv) {
      for (int t = 0; t < a.W; ++t) prefetch_l2(ops.conv_w + static_cast<size_t>(t) * conv_ch + ch);
      prefetch_l2(ops.conv_b + ch);
    } else if (ch >= conv_ch) {
      prefetch_l2(ops.dt_bias + ch - conv_ch);
    }
  }
  if ((threadIdx.x & 15) != 0 || !conv) return;
  const __nv_bfloat16* win = static_cast<const __nv_bfloat16*>(a.conv_state) +
                             static_cast<size_t>(layer) * a.B * (a.W - 1) * conv_ch + ch;
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    const int row = row0 + 16 * k;
    if (row >= a.B) break;
    for (int t = 0; t + 1 < a.W; ++t)
      prefetch_l2(win + (static_cast<size_t>(row) * (a.W - 1) + t) * conv_ch);
  }
}

// The LoRA product of in_proj_finish4, summed in its order (q ascending) for 4
// columns from `col` of the rows row0, row0 + 16, ...: lo[i] = (hn @ A)[row] @
// B[:, col .. col + 3]. Rows past B read row B - 1 and are never written. The
// loads of eight q are issued together.
template <int ROWS>
__device__ __forceinline__ void in_pair_lora(const K4Args& a, const InPairOps& ops, int row0,
                                             int col, float4 (&lo)[ROWS]) {
  const int n_in = 2 * a.d_inner + 2 * a.N + a.Hdt;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) lo[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q0 = 0; q0 < a.r; q0 += 8) {
    const int n = min(8, a.r - q0);
    uint2 lb[8];
    float h[ROWS][8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k >= n) break;
      lb[k] = __ldg(reinterpret_cast<const uint2*>(ops.lora_b + static_cast<size_t>(q0 + k) * n_in + col));
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        h[i][k] = a.hA[static_cast<size_t>(min(row0 + 16 * i, a.B - 1)) * a.r + q0 + k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k >= n) break;
      const float4 l = raw_to_float4(lb[k]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) axpy4(lo[i], h[i][k], l);
    }
  }
}

// in_proj_finish4's vector path for bf16 activations and weights, in its
// arithmetic and order, for 4 columns from `col` of ROWS rows: the LoRA term
// (`lo`, from in_pair_lora), then the z store, the conv step or the softplus.
// It takes the layer's weights from `ops` rather than from the pointer table,
// and reads dt_bias once for the 4 columns, not once an element behind a
// table lookup (one column tile of the grid holds all dt columns: its blocks
// would trail the others).
template <int ROWS>
__device__ __forceinline__ void in_pair_finish(const K4Args& a, int layer, const InPairOps& ops,
                                               const int (&rows)[ROWS], const float4 (&lo)[ROWS],
                                               int col, float4 (&v)[ROWS]) {
  using bf16 = __nv_bfloat16;
  const int conv_ch = a.d_inner + 2 * a.N;
  if (a.r > 0) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) axpy4(v[i], a.lora_scale, lo[i]);
  }

  const int ch = col - a.d_inner;
  if (ch < 0) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (rows[i] < a.B) store4(a.z + static_cast<size_t>(rows[i]) * a.d_inner + col, v[i]);
  } else if (ch < conv_ch && a.W == 4) {
    // the 4-tap shift register of every shipped config, three old taps a row
    const bf16* conv_w = ops.conv_w + ch;  // (4, conv_ch)
    const float4 w0 = ldg4(conv_w), w1 = ldg4(conv_w + conv_ch);
    const float4 w2 = ldg4(conv_w + 2 * conv_ch), w3 = ldg4(conv_w + 3 * conv_ch);
    const float4 bias = ldg4(ops.conv_b + ch);
    bf16* const base = static_cast<bf16*>(a.conv_state) +
                       static_cast<size_t>(layer) * a.B * 3 * conv_ch + ch;
    uint2 t0[ROWS], t1[ROWS], t2[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bf16* win = base + static_cast<size_t>(min(rows[i], a.B - 1)) * 3 * conv_ch;
      t0[i] = load_raw4(win);
      t1[i] = load_raw4(win + conv_ch);
      t2[i] = load_raw4(win + 2 * conv_ch);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      float4 y = make_float4(v[i].x * w3.x, v[i].y * w3.y, v[i].z * w3.z, v[i].w * w3.w);
      mad4(y, raw_to_float4(t0[i]), w0);
      mad4(y, raw_to_float4(t1[i]), w1);
      mad4(y, raw_to_float4(t2[i]), w2);
      y.x += bias.x; y.y += bias.y; y.z += bias.z; y.w += bias.w;
      bf16* win = base + static_cast<size_t>(rows[i]) * 3 * conv_ch;
      *reinterpret_cast<uint2*>(win) = t1[i];
      *reinterpret_cast<uint2*>(win + conv_ch) = t2[i];
      store4(win + 2 * conv_ch, v[i]);
      store4(a.xbc + static_cast<size_t>(rows[i]) * conv_ch + ch,
             make_float4(silu(y.x), silu(y.y), silu(y.z), silu(y.w)));
    }
  } else if (ch >= conv_ch) {
    // dt columns: softplus(dt + dt_bias), linear above 20, as in_proj_place
    const int hh = ch - conv_ch;
    const float4 b4 = ldg4(ops.dt_bias + hh);
    auto softplus = [](float u) { return (u > 20.0f) ? u : log1pf(expf(u)); };
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      store4(a.dt + static_cast<size_t>(rows[i]) * a.Hdt + hh,
             make_float4(softplus(v[i].x + b4.x), softplus(v[i].y + b4.y),
                         softplus(v[i].z + b4.z), softplus(v[i].w + b4.w)));
    }
  } else {
    // the conv columns of another tap count
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rows[i] >= a.B) continue;
      in_proj_place<bf16, bf16>(a, layer, rows[i], col, v[i].x);
      in_proj_place<bf16, bf16>(a, layer, rows[i], col + 1, v[i].y);
      in_proj_place<bf16, bf16>(a, layer, rows[i], col + 2, v[i].z);
      in_proj_place<bf16, bf16>(a, layer, rows[i], col + 3, v[i].w);
    }
  }
}

// three blocks an SM (at most 136 registers a thread): the grid of 2 x 133
// blocks at B <= 96 is then one wave. PW: the type of W_in, bf16 or int8
// (then with its fp32 column scale)
template <int MT, typename PW>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(InPair<MT, PW>::kThreads, 3)
k4_in_proj_pair_kernel(K4Args a, int layer, const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap) {
  using P = InPair<MT, PW>;
  using bf16 = __nv_bfloat16;
  if (OMT_K4_IN_SKIP & 16) return;
  extern __shared__ unsigned char pair_smem_raw[];
  __shared__ __align__(8) uint64_t full[P::kStages], empty[P::kStages], sums_full;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pair_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* sums = reinterpret_cast<float*>(ring + P::kStages * P::kStageBytes);
  const uint32_t rank = cluster_ctarank();  // 0: the lo chain, 1: the hi chain
  const int n0 = (blockIdx.x >> 1) * kTcBN, m0 = blockIdx.y * MT * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntiles = a.d / kTcBK, nstages = (ntiles + P::kS - 1) / P::kS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P::kWarps);
    }
    mbar_init(&sums_full, 1);  // its bytes come from the peer's st.async stores
    mbar_arrive_expect_tx(&sums_full, P::kSumsBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // this block's barriers are set, and the peer's are once
  cluster_arrive_relaxed();  // the cluster barrier has been waited on

  if (warp == P::kWarps) {
    if (lane == 0) {
      constexpr uint32_t kA = (OMT_K4_IN_SKIP & 1) ? 0 : P::kABytes;
      constexpr uint32_t kW = (OMT_K4_IN_SKIP & 2) ? 0 : P::kWBytes;
      prefetch_tensor_map(&wmap);  // W_in of this layer
      prefetch_tensor_map(&xmap);  // hn
      auto weights = [&](int st, int slot, int n) {  // stage st's weight tiles into its slot
        for (int u = 0; u < n; ++u)
          if (kW)
            tma_load(ring + slot * P::kStageBytes + P::kS * P::kABytes + u * P::kWBytes, &wmap, n0,
                     (st * P::kS + u) * kTcBK + rank * 32, &full[slot]);
      };
      // the first stages' weights before the pre-norm has ended (32: after, a measurement)
      const int first = (OMT_K4_IN_SKIP & 32) ? 0 : min(P::kStages, nstages);
      for (int st = 0; st < first; ++st) {
        const int n = min(P::kS, ntiles - st * P::kS);
        mbar_arrive_expect_tx(&full[st], n * (kA + kW));
        weights(st, st, n);
      }
      grid_dependency_wait();  // hn is the pre-norm's output
      // the SSM phase's blocks may start now and fetch their state while this
      // kernel runs (they read its outputs only once it has ended); a block's
      // first trigger counts, and none comes before griddepcontrol.wait
      if (!(OMT_K4_SSM_SKIP & (8 | 64))) grid_launch_dependents();
      for (int st = 0; st < nstages; ++st) {
        const int slot = st % P::kStages, n = min(P::kS, ntiles - st * P::kS);
        if (st >= first) {  // into the slot once its last stage is done with
          if (st >= P::kStages) mbar_wait<false>(&empty[slot], (st / P::kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[slot], n * (kA + kW));
          weights(st, slot, n);
        }
        for (int u = 0; u < n; ++u)
          if (kA)
            tma_load(ring + slot * P::kStageBytes + u * P::kABytes, &xmap,
                     (st * P::kS + u) * kTcBK + rank * 32, m0, &full[slot]);
      }
      if (OMT_K4_SSM_SKIP & 64) grid_launch_dependents();
    }
    cluster_wait();
    return;
  }

  // this lane's ldmatrix offsets, swizzle included: A, row l % 16 of an m16
  // tile (64-byte rows; 16-byte chunk j of row r lies at j ^ ((r >> 1) & 3)) and
  // chunk 2 h + l / 16; bf16 W by .trans, k row 16 h + l % 16 (128-byte rows;
  // chunk j of row r at j ^ (r & 7)) and the chunk of columns 16 warp + 8 (l /
  // 16); int8 W by .trans, k row l (64-byte rows, swizzled as A) and the chunk
  // of columns 16 warp .. 16 warp + 15
  uint32_t a_off[2], b_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a_off[h] = (lane & 15) * 64 + (((2 * h + (lane >> 4)) ^ ((lane >> 1) & 3)) << 4);
    b_off[h] = kInt8<PW>
                   ? lane * 64 + ((warp ^ ((lane >> 1) & 3)) << 4)
                   : (h * 16 + (lane & 15)) * 128 + (((2 * warp + (lane >> 4)) ^ (lane & 7)) << 4);
  }
  // the columns 4 cg .. 4 cg + 3 and rows rl, rl + 16, ... (from row0) of the
  // tile that this thread finishes, see the epilogue
  const int cg = threadIdx.x & 15, rl = threadIdx.x >> 4;
  const int row0 = m0 + rank * 8 + rl;
  const InPairOps ops = {layer_ptr<bf16>(a, kLoraB, layer), layer_ptr<bf16>(a, kConvW, layer),
                         layer_ptr<bf16>(a, kConvB, layer), layer_ptr<bf16>(a, kDtBias, layer)};
  if (!(OMT_K4_IN_SKIP & 128)) in_pair_prefetch<MT>(a, ops, layer, row0, n0);
  // an int8 W_in's column scale of this thread's columns, read now: it is a
  // weight, and its load stays out of the tail after the last weight byte
  [[maybe_unused]] float4 sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  if constexpr (kInt8<PW>) sc = load4(layer_ptr<float>(a, kInScale, layer) + n0 + cg * 4);

  // the LoRA product (hn @ A) @ B of this thread's rows and columns does not
  // need the in_proj's: it is summed now, in q order, while the first stages land
  grid_dependency_wait();  // hn @ A is the pre-norm's
  if (!(OMT_K4_SSM_SKIP & (8 | 64))) grid_launch_dependents();
  float4 lo[MT];
  in_pair_lora<MT>(a, ops, row0, n0 + cg * 4, lo);

  float acc[MT][2][4];  // [m16 tile][n8 tile][mma.sync accumulator]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int st = 0; st < nstages; ++st) {
    const int slot = st % P::kStages;
    mbar_wait<false>(&full[slot], (st / P::kStages) & 1);
    const unsigned char* a_tile = ring + slot * P::kStageBytes;
    const unsigned char* w_tile = a_tile + P::kS * P::kABytes;
    if (!(OMT_K4_IN_SKIP & 4)) {
      const int n = min(P::kS, ntiles - st * P::kS);
      if (n == P::kS) {
        in_pair_tiles<MT, P::kS, PW>(acc, a_tile, w_tile, a_off, b_off);
      } else {  // the last stage of a K that is not a multiple of kS tiles
        for (int u = 0; u < n; ++u)
          in_pair_tiles<MT, 1, PW>(acc, a_tile + u * P::kABytes, w_tile + u * P::kWBytes, a_off,
                                   b_off);
      }
    }
    __syncwarp();  // the warp is done with the stage
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
  if (OMT_K4_SSM_SKIP & 64) grid_launch_dependents();

  cluster_wait();  // the peer's barriers are set
  if (OMT_K4_IN_SKIP & 8) return;
  // Rank 0 finishes rows 0-7 of every m16 tile, rank 1 rows 8-15: accumulators
  // 0, 1 of lane (g, c) are row g, 2, 3 row g + 8 (columns 2 c, 2 c + 1 of the
  // n8 tile). Each block sends its sums of the other rows to its peer with
  // st.async, 16 bytes a lane and m16 tile laid out as the threads hold them,
  // which count on the peer's sums_full as the bytes of a TMA copy do.
  const int g = lane >> 2, c = lane & 3;
  const int at = (warp * MT * 32 + lane) * 4;  // floats; m16 tile i at + 128 i
#pragma unroll
  for (int i = 0; i < MT; ++i)
    st_async_remote4(sums + at + i * 128, rank ^ 1, &sums_full,
                     rank ? acc[i][0][0] : acc[i][0][2], rank ? acc[i][0][1] : acc[i][0][3],
                     rank ? acc[i][1][0] : acc[i][1][2], rank ? acc[i][1][1] : acc[i][1][3]);

  // the ring, which every consumer warp is done with, takes lo + hi of this
  // block's rows (row q = 8 i + g: 8 MT x 64). The sums of lane (g, c) lie at
  // columns 2c, 2c + 1 of each n8 tile: with bf16 weights columns 2c, 2c + 1
  // and 8 + 2c, 9 + 2c of the warp's 16; with int8 weights, where the n8 tiles
  // are its even and its odd columns, 4c .. 4c + 3
  constexpr int kLdCs = kTcBN + (kInt8<PW> ? 16 : 8);  // floats: conflict-free stores
  float* Cs = reinterpret_cast<float*>(ring);
  consumer_sync<P::kWarps>();
  mbar_wait<false>(&sums_full, 0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float4 p = load4(sums + at + i * 128);
    const float x0 = (rank ? acc[i][0][2] : acc[i][0][0]) + p.x;
    const float x1 = (rank ? acc[i][0][3] : acc[i][0][1]) + p.y;
    const float y0 = (rank ? acc[i][1][2] : acc[i][1][0]) + p.z;
    const float y1 = (rank ? acc[i][1][3] : acc[i][1][1]) + p.w;
    float* row = Cs + (i * 8 + g) * kLdCs + warp * 16;
    if constexpr (kInt8<PW>) {
      store4(row + 4 * c, make_float4(x0, y0, x1, y1));
    } else {
      *reinterpret_cast<float2*>(row + 2 * c) = make_float2(x0, x1);
      *reinterpret_cast<float2*>(row + 8 + 2 * c) = make_float2(y0, y1);
    }
  }
  consumer_sync<P::kWarps>();

  // then, as in the other in_proj paths, thread (cg, rl) finishes 4 columns of
  // MT rows: a warp takes whole 64-column rows; an int8 W_in's column scale
  // (read before the k loop) multiplies lo + hi before the LoRA term is added,
  // JAX's order (_mm, then the LoRA term)
  int rows[MT];
  float4 v[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    rows[i] = row0 + i * 16;
    v[i] = load4(Cs + (i * 8 + rl) * kLdCs + cg * 4);
    if constexpr (kInt8<PW>) v[i] = mul4(v[i], sc);
  }
  in_pair_finish<MT>(a, layer, ops, rows, lo, n0 + cg * 4, v);
}

template <int MT, typename PW>
cudaError_t launch_in_proj_pair(const K4Args& a, int layer, cudaStream_t stream) {
  // programmatic dependent launch: the blocks start while the pre-norm runs
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((2 * a.d_inner + 2 * a.N + a.Hdt) / kTcBN), (a.B + MT * 16 - 1) / (MT * 16));
  cfg.blockDim = dim3(InPair<MT, PW>::kThreads);
  cfg.dynamicSmemBytes = InPair<MT, PW>::kBytes;
  cfg.stream = stream;
  if (!(OMT_K4_IN_SKIP & 64)) {  // 64: an ordinary launch (measurement only)
    cfg.attrs = &pdl;
    cfg.numAttrs = 1;
  }
  CUtensorMap wmap, xmap;  // the host copies of this layer's W_in and of hn
  std::memcpy(&wmap, a.in_maps + layer, sizeof(wmap));
  std::memcpy(&xmap, a.in_maps + a.L, sizeof(xmap));
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, k4_in_proj_pair_kernel<MT, PW>, a, layer, wmap, xmap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// rows a block of the pair kernels: 16 to 96, so that up to 96 rows read each
// weight tile from device memory once and the grid is one wave
inline int pair_row_fragments(int B) { return B >= 96 ? 6 : (B + 15) / 16; }

template <typename PW>
cudaError_t launch_in_proj_pair(const K4Args& a, int layer, cudaStream_t stream) {
  switch (pair_row_fragments(a.B)) {
    case 1: return launch_in_proj_pair<1, PW>(a, layer, stream);
    case 2: return launch_in_proj_pair<2, PW>(a, layer, stream);
    case 3: return launch_in_proj_pair<3, PW>(a, layer, stream);
    case 4: return launch_in_proj_pair<4, PW>(a, layer, stream);
    case 5: return launch_in_proj_pair<5, PW>(a, layer, stream);
    default: return launch_in_proj_pair<6, PW>(a, layer, stream);
  }
}

// ---------------------------------------------------------------------------
// phase 4 for bf16 activations and a bf16 or int8 out_proj: a two-block
// cluster per (column tile, K split)
// ---------------------------------------------------------------------------
// The sum order is the in_proj's (above): each K split's fp32 partial is lo +
// hi, where lo is the chain of HMMA.16816.F32.BF16 over k in [0, 32) of every
// 64-wide k tile of the split, in k order, and hi the same chain over [32,
// 64); with an int8 W_out the partial is then multiplied by the column scale
// (JAX's _mm with quant=True: the scale on the fp32 product of each split).
// As in the in_proj, the two chains run in the two blocks of a cluster, rank
// 0 lo and rank 1 hi, each over the whole split: at 1.3B and B=48 the grid is
// 32 column tiles x 4 K splits x 2 = 256 blocks, each streaming 64 KB of a
// bf16 W_out or 32 KB of an int8 one. A producer warp copies the block's half
// of each weight tile (32 k x 64 columns: 4 KB of bf16, 2 KB of int8) and of
// each activation tile (16 MT rows x 32 k) with one TMA copy each into a ring
// of mbarrier-guarded stages (the in_proj's InPair ring, about 64 KB: three
// blocks an SM); four consumer warps (16 columns and the MT m16 tiles each)
// multiply with in_pair_tiles, an int8 tile widened in registers, and never
// meet at a block barrier in the k loop. A block takes up to 96 rows
// (pair_row_fragments), so at B <= 96 W_out is read from device memory once;
// more rows take more row tiles.
//
// The launch is a programmatic dependent of the SSM update
// (k4_ssm_tile_kernel), whose blocks let it start once their own
// griddepcontrol.wait has returned: the producer asks for the first stages'
// weight tiles, which no running kernel writes, before griddepcontrol.wait,
// and for activation tiles (yf * w_gn, the SSM update's output) only after
// it; nothing is written before it. That wait is also what orders the stores
// of `part` after this layer's pre-norm, which read it three kernels earlier:
// every kernel of the chain waits for the one before it to end before it
// ends. Where the SSM phase is an ordinary launch (k4_ssm_kernel), the wait
// returns at once. The next layer's pre-norm is a programmatic dependent of
// this kernel, and the blocks let it start at entry.
//
// At the end the blocks trade halves through distributed shared memory as the
// in_proj's do: rank 0 finishes rows 0-7 of every m16 tile and rank 1 rows
// 8-15, each sending its sums of the other rows to its peer with st.async
// counted on the peer's mbarrier. lo + hi is one fp32 addition (no product to
// contract it with; the same bits either way round), and each block stores its
// rows of part[split] through shared memory as whole 64-column rows, two
// 128-byte lines each; with an int8 W_out each storing thread multiplies its
// four columns by their scale, read before the k loop, on the way. Rows past B
// read as zeros (the TMA copy fills them) and are never written. The split's k
// range is tc_split_width's, so a row's bits do not depend on B.

// the shapes the pair kernel takes, on the bf16 tensor-core path with bf16 or
// int8 projections: whole tiles and every K split non-empty (every ksplit that
// prepare_fused_decode picks); other shapes take k4_out_proj_kernel
__host__ __device__ constexpr bool out_pair_fits(int d, int d_inner, int ksplit) {
  return d % kTcBN == 0 && d_inner % kTcBK == 0 && ksplit >= 1 && ksplit <= kMaxKSplit &&
         d_inner > (ksplit - 1) * tc_split_width(d_inner, ksplit);
}

// PW: the type of W_out, bf16 or int8 (then with its fp32 column scale)
template <int MT, typename PW>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(InPair<MT, PW>::kThreads, 3)
k4_out_proj_pair_kernel(K4Args a, int layer, const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap) {
  using P = InPair<MT, PW>;  // the in_proj's tiles, ring and warps
  if (OMT_K4_OUT_SKIP & 16) return;
  // the next layer's pre-norm may start now and fetch its weights; it reads
  // the partials only once this kernel has ended
  if (!(OMT_K4_OUT_SKIP & 1024)) grid_launch_dependents();
  extern __shared__ unsigned char out_pair_smem_raw[];
  __shared__ __align__(8) uint64_t full[P::kStages], empty[P::kStages], sums_full;
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(out_pair_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* sums = reinterpret_cast<float*>(ring + P::kStages * P::kStageBytes);
  const uint32_t rank = cluster_ctarank();  // 0: the lo chain, 1: the hi chain
  const int n0 = (blockIdx.x >> 1) * kTcBN, m0 = blockIdx.y * MT * 16, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = tc_split_width(a.d_inner, a.ksplit);
  const int k_begin = split * per;
  const int ntiles = (min(a.d_inner, k_begin + per) - k_begin) / kTcBK;
  const int nstages = (ntiles + P::kS - 1) / P::kS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < P::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], P::kWarps);
    }
    mbar_init(&sums_full, 1);  // its bytes come from the peer's st.async stores
    mbar_arrive_expect_tx(&sums_full, P::kSumsBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // this block's barriers are set, and the peer's are once
  cluster_arrive_relaxed();  // the cluster barrier has been waited on

  if (warp == P::kWarps) {
    if (lane == 0) {
      constexpr uint32_t kA = (OMT_K4_OUT_SKIP & 1) ? 0 : P::kABytes;
      constexpr uint32_t kW = (OMT_K4_OUT_SKIP & 2) ? 0 : P::kWBytes;
      prefetch_tensor_map(&wmap);  // W_out of this layer
      prefetch_tensor_map(&xmap);  // yf * w_gn
      auto k_row = [&](int st, int u) { return k_begin + (st * P::kS + u) * kTcBK + rank * 32; };
      auto weights = [&](int st, int slot, int n) {  // stage st's weight tiles into its slot
        for (int u = 0; u < n; ++u)
          if (kW)
            tma_load(ring + slot * P::kStageBytes + P::kS * P::kABytes + u * P::kWBytes, &wmap, n0,
                     k_row(st, u), &full[slot]);
      };
      // the first stages' weights before the SSM update has ended (64: after, a measurement)
      const int first = (OMT_K4_OUT_SKIP & 64) ? 0 : min(P::kStages, nstages);
      for (int st = 0; st < first; ++st) {
        const int n = min(P::kS, ntiles - st * P::kS);
        mbar_arrive_expect_tx(&full[st], n * (kA + kW));
        weights(st, st, n);
      }
      grid_dependency_wait();  // yf * w_gn is the SSM update's output
      for (int st = 0; st < nstages; ++st) {
        const int slot = st % P::kStages, n = min(P::kS, ntiles - st * P::kS);
        if (st >= first) {  // into the slot once its last stage is done with
          if (st >= P::kStages) mbar_wait<false>(&empty[slot], (st / P::kStages - 1) & 1);
          mbar_arrive_expect_tx(&full[slot], n * (kA + kW));
          weights(st, slot, n);
        }
        for (int u = 0; u < n; ++u)
          if (kA)
            tma_load(ring + slot * P::kStageBytes + u * P::kABytes, &xmap, k_row(st, u), m0,
                     &full[slot]);
      }
    }
    cluster_wait();
    return;
  }

  // this lane's ldmatrix offsets, swizzle included, as in k4_in_proj_pair_kernel:
  // the warp's columns are 16 warp .. 16 warp + 15
  uint32_t a_off[2], b_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a_off[h] = (lane & 15) * 64 + (((2 * h + (lane >> 4)) ^ ((lane >> 1) & 3)) << 4);
    if constexpr (kInt8<PW>)
      b_off[h] = lane * 64 + ((warp ^ ((lane >> 1) & 3)) << 4);
    else
      b_off[h] = (h * 16 + (lane & 15)) * 128 + (((2 * warp + (lane >> 4)) ^ (lane & 7)) << 4);
  }
  // an int8 W_out's column scale of the four columns this thread stores (see
  // the stores below): a weight, read now so that its load stays out of the
  // tail after the last weight byte
  [[maybe_unused]] float4 sc = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  if constexpr (kInt8<PW>)
    sc = load4(layer_ptr<float>(a, kOutScale, layer) + n0 + (threadIdx.x & 15) * 4);

  float acc[MT][2][4];  // [m16 tile][n8 tile][mma.sync accumulator]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int st = 0; st < nstages; ++st) {
    const int slot = st % P::kStages;
    mbar_wait<false>(&full[slot], (st / P::kStages) & 1);
    const unsigned char* a_tile = ring + slot * P::kStageBytes;
    const unsigned char* w_tile = a_tile + P::kS * P::kABytes;
    if (!(OMT_K4_OUT_SKIP & 4)) {
      const int n = min(P::kS, ntiles - st * P::kS);
      if (n == P::kS) {
        in_pair_tiles<MT, P::kS, PW>(acc, a_tile, w_tile, a_off, b_off);
      } else {  // the last stage of a split that is not a multiple of kS tiles
        for (int u = 0; u < n; ++u)
          in_pair_tiles<MT, 1, PW>(acc, a_tile + u * P::kABytes, w_tile + u * P::kWBytes, a_off,
                                   b_off);
      }
    }
    __syncwarp();  // the warp is done with the stage
    if (lane == 0) mbar_arrive(&empty[slot]);
  }

  cluster_wait();  // the peer's barriers are set
  if (OMT_K4_OUT_SKIP & 8) return;
  // Rank 0 finishes rows 0-7 of every m16 tile, rank 1 rows 8-15: accumulators
  // 0, 1 of lane (g, c) are row g, 2, 3 row g + 8 (columns 2 c, 2 c + 1 of the
  // n8 tile). Each block sends its sums of the other rows to its peer, 16
  // bytes a lane for each m16 tile (both n8 tiles), counted on the peer's
  // sums_full.
  const int g = lane >> 2, c = lane & 3;
  auto slot4 = [&](int i) {  // floats: this lane's 16 bytes of m16 tile i
    return sums + ((warp * MT + i) * 32 + lane) * 4;
  };
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float(&x)[4] = acc[i][0];
    const float(&y)[4] = acc[i][1];
    st_async_remote4(slot4(i), rank ^ 1, &sums_full, rank ? x[0] : x[2], rank ? x[1] : x[3],
                     rank ? y[0] : y[2], rank ? y[1] : y[3]);
  }

  // the ring, which every consumer warp is done with, takes lo + hi of this
  // block's rows (row r = 8 i + g: 8 MT x 64). The sums of lane (g, c) lie at
  // columns 2c, 2c + 1 of each n8 tile: with bf16 weights columns 2c, 2c + 1
  // and 8 + 2c, 9 + 2c of the warp's 16; with int8 weights, where the n8 tiles
  // are its even and its odd columns, 4c .. 4c + 3
  constexpr int kLdCs = kTcBN + (kInt8<PW> ? 16 : 8);  // floats: conflict-free stores
  float* Cs = reinterpret_cast<float*>(ring);
  consumer_sync<P::kWarps>();
  mbar_wait<false>(&sums_full, 0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float4 p = load4(slot4(i));
    const float(&x)[4] = acc[i][0];
    const float(&y)[4] = acc[i][1];
    if constexpr (kInt8<PW>) {
      store4(Cs + (i * 8 + g) * kLdCs + warp * 16 + 4 * c,
             make_float4((rank ? x[2] : x[0]) + p.x, (rank ? y[2] : y[0]) + p.z,
                         (rank ? x[3] : x[1]) + p.y, (rank ? y[3] : y[1]) + p.w));
    } else {
      float* row = Cs + (i * 8 + g) * kLdCs + warp * 16 + 2 * c;
      *reinterpret_cast<float2*>(row) =
          make_float2((rank ? x[2] : x[0]) + p.x, (rank ? x[3] : x[1]) + p.y);
      *reinterpret_cast<float2*>(row + 8) =
          make_float2((rank ? y[2] : y[0]) + p.z, (rank ? y[3] : y[1]) + p.w);
    }
  }
  consumer_sync<P::kWarps>();

  // thread (cg, r0) stores columns 4 cg .. 4 cg + 3 of the block's rows r0,
  // r0 + R, ...: a half warp takes a whole 64-column row; an int8 W_out's
  // partial is lo + hi times the column scale
  grid_dependency_wait();  // returned long ago: the producer's wait came first
  constexpr int R = P::kWarps * 2;  // rows a pass
  const int cg = threadIdx.x & 15, r0 = threadIdx.x >> 4;
  float* part = a.part_out + static_cast<size_t>(split) * a.B * a.d + n0 + cg * 4;
#pragma unroll
  for (int r = r0; r < 8 * MT; r += R) {
    const int row = m0 + (r >> 3) * 16 + static_cast<int>(rank) * 8 + (r & 7);
    if (row < a.B) {
      float4 v = load4(Cs + r * kLdCs + cg * 4);
      if constexpr (kInt8<PW>) v = mul4(v, sc);
      store4(part + static_cast<size_t>(row) * a.d, v);
    }
  }
}

template <int MT, typename PW>
cudaError_t launch_out_proj_pair(const K4Args& a, int layer, cudaStream_t stream) {
  // programmatic dependent launch: the blocks start while the SSM update runs
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * (a.d / kTcBN), (a.B + MT * 16 - 1) / (MT * 16), a.ksplit);
  cfg.blockDim = dim3(InPair<MT, PW>::kThreads);
  cfg.dynamicSmemBytes = InPair<MT, PW>::kBytes;
  cfg.stream = stream;
  if (!(OMT_K4_OUT_SKIP & 32)) {  // 32: an ordinary launch (measurement only)
    cfg.attrs = &pdl;
    cfg.numAttrs = 1;
  }
  CUtensorMap wmap, xmap;  // the host copies of this layer's W_out and of yf * w_gn
  std::memcpy(&wmap, a.out_maps + layer, sizeof(wmap));
  std::memcpy(&xmap, a.out_maps + a.L, sizeof(xmap));
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, k4_out_proj_pair_kernel<MT, PW>, a, layer, wmap, xmap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename PW>
cudaError_t launch_out_proj_pair(const K4Args& a, int layer, cudaStream_t stream) {
  switch (pair_row_fragments(a.B)) {
    case 1: return launch_out_proj_pair<1, PW>(a, layer, stream);
    case 2: return launch_out_proj_pair<2, PW>(a, layer, stream);
    case 3: return launch_out_proj_pair<3, PW>(a, layer, stream);
    case 4: return launch_out_proj_pair<4, PW>(a, layer, stream);
    case 5: return launch_out_proj_pair<5, PW>(a, layer, stream);
    default: return launch_out_proj_pair<6, PW>(a, layer, stream);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the in_proj's and the out_proj's pair kernels of MT row fragments
template <int MT, typename PW>
cudaError_t allow_smem_pair() {
  const cudaError_t err = allow_smem(k4_in_proj_pair_kernel<MT, PW>, InPair<MT, PW>::kBytes);
  if (err != cudaSuccess) return err;
  return allow_smem(k4_out_proj_pair_kernel<MT, PW>, InPair<MT, PW>::kBytes);
}

// the shared memory of the products a step at B rows launches on the tensor
// cores, with projections of type PW
template <typename PW>
cudaError_t allow_smem_products(int B) {
  switch (pair_row_fragments(B)) {
    case 1: return allow_smem_pair<1, PW>();
    case 2: return allow_smem_pair<2, PW>();
    case 3: return allow_smem_pair<3, PW>();
    case 4: return allow_smem_pair<4, PW>();
    case 5: return allow_smem_pair<5, PW>();
    default: return allow_smem_pair<6, PW>();
  }
}

// ---------------------------------------------------------------------------

template <typename IO, typename WT>
constexpr bool kBothBf16 =
    std::is_same<IO, __nv_bfloat16>::value && std::is_same<WT, __nv_bfloat16>::value;

// phase 2 of `layer` on the path the step takes
template <typename IO, typename WT, typename PW>
cudaError_t launch_in_proj(const K4Args& a, int layer, bool tensor_cores, cudaStream_t stream) {
  if constexpr (kBothBf16<IO, WT>) {
    if (tensor_cores) return launch_in_proj_pair<PW>(a, layer, stream);
  }
  const dim3 in_grid((2 * a.d_inner + 2 * a.N + a.Hdt + kBN - 1) / kBN, (a.B + kBM - 1) / kBM);
  k4_in_proj_kernel<IO, WT, PW><<<in_grid, kGemmThreads, 0, stream>>>(a, layer);
  return cudaGetLastError();
}

// phase 4 of `layer` on the path the step takes: with `pair` (bf16 or int8
// projections on the tensor-core path, a shape that out_pair_fits) the pair
// kernel, a programmatic dependent of the SSM update; k4_out_proj_kernel
// otherwise
template <typename IO, typename WT, typename PW>
cudaError_t launch_out_proj(const K4Args& a, int layer, bool pair, cudaStream_t stream) {
  if constexpr (kBothBf16<IO, WT>) {
    if (pair) return launch_out_proj_pair<PW>(a, layer, stream);
  }
  const dim3 out_grid((a.d + kBN - 1) / kBN, (a.B + kBM - 1) / kBM, a.ksplit);
  k4_out_proj_kernel<IO, PW><<<out_grid, kGemmThreads, 0, stream>>>(a, layer);
  return cudaGetLastError();
}

// phases that run_fused_decode can launch alone, for one layer (a measurement)
// kPhaseLayer: the four phases of one layer; kPhaseFinish: the step's last kernel alone
// (the per-layer step of tp, which gathers every rank's sums between the layers)
enum K4Phase : int {
  kPhasePrenorm = 1, kPhaseInProj = 2, kPhaseSsm = 3, kPhaseOutProj = 4, kPhaseLayer = 5,
  kPhaseFinish = 6
};

template <int E, int R>
cudaError_t launch_prenorm_early(const cudaLaunchConfig_t& cfg, const K4Args& a, int layer) {
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k4_prenorm_early_kernel<E, R>, a, layer);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// phase 1 of `layer`: with `early` (bf16 on the tensor-core path, a shape that
// prenorm_row_fits) the early kernel, a programmatic dependent of the
// out_proj; k4_prenorm_kernel otherwise
template <typename IO, typename WT>
cudaError_t launch_prenorm(const K4Args& a, int layer, bool early, cudaStream_t stream) {
  if constexpr (kBothBf16<IO, WT>) {
    if (early) {
      cudaLaunchAttribute pdl;
      pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
      pdl.val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(a.B);
      cfg.blockDim = dim3(kRowThreads);
      cfg.stream = stream;
      if (!(OMT_K4_PRE_SKIP & 16)) {  // 16: an ordinary launch (measurement only)
        cfg.attrs = &pdl;
        cfg.numAttrs = 1;
      }
      if (a.d == kRowThreads)
        return a.r ? launch_prenorm_early<1, 8>(cfg, a, layer)
                   : launch_prenorm_early<1, 0>(cfg, a, layer);
      return a.r ? launch_prenorm_early<2, 8>(cfg, a, layer)
                 : launch_prenorm_early<2, 0>(cfg, a, layer);
    }
  }
  const size_t row_smem = static_cast<size_t>(a.d) * sizeof(float);
  k4_prenorm_kernel<IO, WT><<<a.B, kRowThreads, row_smem, stream>>>(a, layer);
  return cudaGetLastError();
}

// `layer_only` < 0: the whole step; else phase `phase_only` of that layer
// alone (a measurement: it reads what it takes from the scratch as it stands)
template <typename IO, typename WT, typename PW, typename ST>
cudaError_t run_fused_decode(const K4Args& a, bool whole_tiles, int layer_only, int phase_only,
                             cudaStream_t stream) {
  // tensor cores for bf16 activations and weights, with bf16 or int8 projections
  const size_t row_smem = static_cast<size_t>(a.d) * sizeof(float);
  const size_t bc_smem = 2 * static_cast<size_t>(a.N) * sizeof(float);
  cudaError_t err = allow_smem(k4_prenorm_kernel<IO, WT>, row_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(k4_ssm_kernel<IO, WT, ST>, bc_smem);
  if (err != cudaSuccess) return err;
  bool tensor_cores = false;
  if constexpr (kBothBf16<IO, WT>) {
    tensor_cores = whole_tiles;
    // the in_proj (bf16 or int8) reads its tiles through the plan's tensor maps:
    // no other path stands in
    if (tensor_cores && a.in_maps == nullptr) return cudaErrorInvalidValue;
    if (tensor_cores && (err = allow_smem_products<PW>(a.B)) != cudaSuccess) return err;
  }
  const bool early_prenorm =
      kBothBf16<IO, WT> && tensor_cores && prenorm_row_fits(a.d, a.r, a.H * a.tp, a.ksplit * a.tp);
  const bool out_pair =
      kBothBf16<IO, WT> && tensor_cores && out_pair_fits(a.d, a.d_inner, a.ksplit);
  // which reads its tiles through the plan's tensor maps: no other path stands in
  if (out_pair && a.out_maps == nullptr) return cudaErrorInvalidValue;
  if (layer_only >= 0 && phase_only == kPhasePrenorm)
    return launch_prenorm<IO, WT>(a, layer_only, early_prenorm, stream);
  if (layer_only >= 0 && phase_only == kPhaseInProj)
    return launch_in_proj<IO, WT, PW>(a, layer_only, tensor_cores, stream);
  if (layer_only >= 0 && phase_only == kPhaseSsm)
    return launch_ssm<IO, WT, ST>(a, layer_only, stream);
  if (layer_only >= 0 && phase_only == kPhaseOutProj)
    return launch_out_proj<IO, WT, PW>(a, layer_only, out_pair, stream);
  if (layer_only >= 0 && phase_only == kPhaseFinish) {
    k4_finish_kernel<IO><<<dim3(a.B), kRowThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (layer_only >= 0 && phase_only != kPhaseLayer) return cudaErrorInvalidValue;

  for (int layer = 0; layer < a.L; ++layer) {
    if (layer_only >= 0 && layer != layer_only) continue;
    if ((err = launch_prenorm<IO, WT>(a, layer, early_prenorm, stream)) != cudaSuccess) return err;
    if ((err = launch_in_proj<IO, WT, PW>(a, layer, tensor_cores, stream)) != cudaSuccess) return err;
    if ((err = launch_ssm<IO, WT, ST>(a, layer, stream)) != cudaSuccess) return err;
    if ((err = launch_out_proj<IO, WT, PW>(a, layer, out_pair, stream)) != cudaSuccess) return err;
  }
  if (layer_only >= 0) return cudaSuccess;
  k4_finish_kernel<IO><<<dim3(a.B), kRowThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename IO, typename WT, typename PW>
cudaError_t run_fused_decode_state(const K4Args& a, int state_dtype, bool whole_tiles,
                                   int layer_only, int phase_only, cudaStream_t stream) {
  if (state_dtype == kF32)
    return run_fused_decode<IO, WT, PW, float>(a, whole_tiles, layer_only, phase_only, stream);
  if (state_dtype == kBF16)
    return run_fused_decode<IO, WT, PW, __nv_bfloat16>(a, whole_tiles, layer_only, phase_only,
                                                       stream);
  return cudaErrorInvalidValue;
}

}  // namespace omt

// One decode token through L layers. `tables` is a device array of
// kNumOps * L device pointers, table[op * L + layer], in the order of
// omt::K4Op: norm weight (d), in_proj (d, 2*d_inner + 2N + H), LoRA A (d, r),
// LoRA B (r, 2*d_inner + 2N + H), conv weight (W, d_inner + 2N) oldest tap
// first, conv bias, dt_bias (H), A_log (H), D (H), gated-norm weight
// (d_inner), out_proj (d_inner, d); all of the element type w_dtype,
// contiguous, except in_proj and out_proj when proj_dtype is int8: then they
// are int8 and the rows in_scale (2*d_inner + 2N + H) and out_scale (d) hold
// their fp32 column scales (the scale rows are not read otherwise).
// r = 0 means no LoRA (its two table rows are not read). h_in,
// h_out, hn, ya and conv_state have the element type io_dtype; ssm_state has
// state_dtype; res_in (may be null), res_out and the scratch arrays hA, z, xbc,
// dt, sumsq and part (ksplit, B, d) are fp32. conv_state and ssm_state are
// contiguous over (L, B, ...) and are updated in place; ssm_state must be
// 16-byte aligned and N a multiple of 4. One group (B and C shared by all
// heads), H * P = d_inner. `aligned16` says that every tensor of the tables,
// conv_state and every scratch array is 16-byte aligned: the in_proj epilogue
// then takes 4-element vector accesses (d_inner and H multiples of 4), and
// with whole tiles (d, d_inner and the in_proj width multiples of 64) and
// bf16 activations and weights the products run on the tensor cores; the
// in_proj there (bf16 or int8) reads W_in and hn through `in_maps`, what
// omt_fused_decode_in_maps wrote (in host memory) for these tables and this
// hn, and the out_proj (bf16 or int8) at the shapes out_pair_fits takes W_out and ya
// through `out_maps`, written by the same function for the out_proj's tables
// and this ya (each null otherwise; the call fails if its path finds it null).
// Activations and weights are both bf16 or both fp32; proj_dtype is w_dtype
// or int8. `layer_only` < 0 runs the step; a layer index runs that layer's
// phase `phase_only` alone (1: the pre-norm, 2: the in_proj, 3: the SSM
// update, 4: the out_proj), as the step would launch it (a measurement), or
// (5) all four phases of that layer, or (6) the step's finishing kernel.
// Under tp (`tp` > 1: heads cut over the ranks, K4-tp) the tables hold this
// rank's slices (in_proj z | x | bc | dt of width 2 d_inner + 2N + Hdt, dt
// for every one of the model's Hdt = H tp heads; A_log and D from head h0)
// and the host runs the step layer by layer (5, then 6): a layer writes its
// K-split partials to part_out (ksplit, B, d) and its sums of squares to
// sumsq_out (B, H), the host gathers every rank's block of both into part and
// sumsq, rank q's at q rank_stride floats, and the next layer's pre-norm (or
// the finish) reads them in one rank's order of K splits and heads. With
// tp = 1, Hdt = H, h0 = 0 and part_out / sumsq_out unused.
// Everything is enqueued on `stream`; nothing synchronises. Returns the first
// cudaError_t of a launch (0 = success).
extern "C" int omt_fused_decode_step(
    const void* tables, int L, int B, int d, int d_inner, int H, int P, int N, int W, int r,
    int ksplit, float lora_scale, float norm_eps, float gn_eps, void* conv_state,
    void* ssm_state, const void* h_in, const void* res_in, void* h_out, void* res_out, void* hn,
    void* hA, void* z, void* xbc, void* dt, void* ya, void* sumsq, void* part, int io_dtype,
    int w_dtype, int state_dtype, int aligned16, int proj_dtype, const void* in_maps,
    const void* out_maps, int layer_only, int phase_only, int Hdt, int h0, int tp,
    long rank_stride, void* part_out, void* sumsq_out, void* stream) {
  using namespace omt;
  if (L < 1 || B < 1 || d < 1 || W < 1 || r < 0 || N % 4 != 0 || H * P != d_inner ||
      ksplit < 1 || ksplit > kMaxKSplit || tp < 1 || h0 < 0 || h0 + H > Hdt ||
      (tp > 1 && (Hdt != H * tp || part_out == nullptr || sumsq_out == nullptr)) ||
      2 * static_cast<size_t>(N) * sizeof(float) > 227 * 1024 ||
      static_cast<size_t>(d) * sizeof(float) > 227 * 1024 || (B + kBM - 1) / kBM > 65535 ||
      layer_only >= L)
    return static_cast<int>(cudaErrorInvalidValue);
  K4Args a;
  a.tab = static_cast<const void* const*>(tables);
  a.L = L; a.B = B; a.d = d; a.d_inner = d_inner; a.H = H; a.P = P; a.N = N; a.W = W;
  a.r = r; a.ksplit = ksplit;
  a.vec4 = aligned16 != 0 && d_inner % 4 == 0 && H % 4 == 0 && Hdt % 4 == 0;
  a.lora_scale = lora_scale; a.norm_eps = norm_eps; a.gn_eps = gn_eps;
  a.conv_state = conv_state; a.ssm_state = ssm_state;
  a.h_in = h_in; a.res_in = static_cast<const float*>(res_in);
  a.h_out = h_out; a.res = static_cast<float*>(res_out);
  a.hn = hn; a.hA = static_cast<float*>(hA); a.z = static_cast<float*>(z);
  a.xbc = static_cast<float*>(xbc); a.dt = static_cast<float*>(dt);
  a.ya = ya; a.sumsq = static_cast<float*>(sumsq);
  a.part = static_cast<float*>(part);
  a.sumsq_out = static_cast<float*>(tp > 1 ? sumsq_out : sumsq);
  a.part_out = static_cast<float*>(tp > 1 ? part_out : part);
  a.tp = tp; a.rank_stride = rank_stride; a.Hdt = Hdt; a.h0 = h0;
  a.in_maps = static_cast<const CUtensorMap*>(in_maps);
  a.out_maps = static_cast<const CUtensorMap*>(out_maps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool whole = aligned16 != 0 && d % 64 == 0 && d_inner % 64 == 0 &&
                     (2 * d_inner + 2 * N + Hdt) % 64 == 0 && r <= kTcMaxRank;
  using bf16 = __nv_bfloat16;
  if (io_dtype == kBF16 && w_dtype == kBF16 && proj_dtype == kBF16)
    return run_fused_decode_state<bf16, bf16, bf16>(a, state_dtype, whole, layer_only,
                                                    phase_only, s);
  if (io_dtype == kBF16 && w_dtype == kBF16 && proj_dtype == kI8)
    return run_fused_decode_state<bf16, bf16, int8_t>(a, state_dtype, whole, layer_only,
                                                      phase_only, s);
  if (io_dtype == kF32 && w_dtype == kF32 && proj_dtype == kF32)
    return run_fused_decode_state<float, float, float>(a, state_dtype, whole, layer_only,
                                                       phase_only, s);
  if (io_dtype == kF32 && w_dtype == kF32 && proj_dtype == kI8)
    return run_fused_decode_state<float, float, int8_t>(a, state_dtype, whole, layer_only,
                                                        phase_only, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of a product of the two-block clusters: for each of the L
// layers W (the host array `w_in` of L device pointers to (d, n_in) matrices of
// w_dtype, bf16 or int8), read in boxes of 32 k x 64 columns, then the
// activations `hn` ((B, d) bf16), in boxes of the row tile x 32 k. The
// in_proj's are W_in and hn (d = d_model), the out_proj's W_out and ya (d =
// d_inner, n_in = d_model).
// Written to `maps` in host memory, (L + 1) x 128 bytes, for the caller to hand
// to omt_fused_decode_step with these tables and these activations (each
// launch takes its two maps as parameters).
// Returns 0, or cudaErrorInvalidValue for shapes that are not whole tiles or a
// map that cuTensorMapEncodeTiled refuses (a pointer or row that is not 16-byte aligned).
extern "C" int omt_fused_decode_in_maps(const void* const* w_in, int L, int B, int d, int n_in,
                                        int w_dtype, const void* hn, void* maps) {
  using namespace omt;
  if (L < 1 || B < 1 || d % kTcBK != 0 || n_in % kTcBN != 0 || d < 1 || n_in < 1 ||
      (w_dtype != kBF16 && w_dtype != kI8))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool int8 = w_dtype == kI8;  // 64-byte box rows: the 64-byte swizzle
  unsigned char* out = static_cast<unsigned char*>(maps);
  CUtensorMap m;
  for (int l = 0; l < L; ++l) {
    if (!encode_tile_map(&m, w_in[l],
                         int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         int8 ? 1 : 2, d, n_in, 32, kTcBN))
      return static_cast<int>(cudaErrorInvalidValue);
    std::memcpy(out + l * sizeof(m), &m, sizeof(m));
  }
  if (!encode_tile_map(&m, hn, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, d, 16 * pair_row_fragments(B),
                       32))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(out + L * sizeof(m), &m, sizeof(m));
  return 0;
}
