// Chunked Mamba-2 SSD forward (prefill and training), zero initial state.
// Replaces _ssd_kernel / ssd_pallas of omnimamba_tpu/ops/ssd_pallas.py. Two
// paths, as the JAX kernel has two operand types (its mxu_dtype): bf16 inputs
// take the tensor-core kernel further down (namespace fwd16) wherever their
// (P, N) fits one of its tile shapes; fp32 inputs, and bf16 inputs of other
// shapes, take the kernel of fp32 multiply-adds described here.
//
// One thread block per (batch, head) walks the sequence in chunks of kChunk
// tokens and carries the head's fp32 (P, N) state from the first chunk to the
// last, so neither the decay matrix nor any chunk state touches device memory
// unless asked for. Per chunk, with s the inclusive cumulative sum of dt * A
// inside the chunk (computed here, in order, never materialised outside):
//
//   W[i][j]  = (C_i . B_j) * exp(s_i - s_j) * dt_j           for j <= i
//   y_i      = sum_j W[i][j] x_j + exp(s_i) * (state C_i) + D x_i
//   state    = exp(s_last) * state + sum_j dt_j exp(s_last - s_j) x_j (x) B_j
//
// The ragged last chunk is masked (dt = 0, x = B = C = 0 beyond the end), never
// padded in device memory, and dt = 0 anywhere is an exact no-op for the state
// (decay exp(0) = 1, update 0). For training the kernel also writes the state
// entering every chunk, (B, C, H, P, N) fp32 with C = ceil(L / kChunk): the
// backward kernel (ssd_scan_bwd.cu) starts each chunk from it instead of
// running the recurrence again.
//
// Arithmetic: fp32 inputs take fp32 operands, exact to summation order, as the
// JAX kernel takes fp32 operands at HIGHEST precision. bf16 inputs round the
// operands of the products to bf16 where the JAX kernel's small-chunk path
// does (the chunk here is 16 tokens): the masked scores C_i . B_j and the decay
// exp(s_i - s_j) each, then their product W; x_j dt_j; the state, for
// state C_i; (x_j dt_j) exp(s_last - s_j), for the update. Sums, the state and
// y before its one rounding stay fp32. ops/ssd_kernel.ssd_fused_plain rounds
// at the same points.
//
// This multiply-add kernel is held back by its fp32 products out of shared
// memory, not by its bytes. The chunk length is chosen by shared memory, not
// by the model's chunk_size: chunking does not change the result. x, B and C
// are read through a row stride (elements from one token's row to the next),
// so column slices of the fused conv output go in without a copy.
#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace omt {

constexpr int kScanThreads = 256;
constexpr int kChunk = 16;

// Floats of dynamic shared memory for one block.
__host__ __device__ inline size_t scan_smem_floats(int P, int N) {
  const size_t NS = static_cast<size_t>(N) + 4;
  return static_cast<size_t>(P) * NS        // state, rows padded against bank conflicts
         + 2 * kChunk * NS                  // B and C tiles
         + static_cast<size_t>(kChunk) * P  // x tile
         + kChunk * (kChunk + 1)            // W
         + 3 * kChunk;                      // s, dt, carry
}

template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const T* __restrict__ x,        // (B, L, H, P)
                const float* __restrict__ dt,   // (B, L, H)
                const float* __restrict__ A,    // (H)
                const T* __restrict__ Bm,       // (B, L, G, N)
                const T* __restrict__ Cm,       // (B, L, G, N)
                const float* __restrict__ D,    // (H) or null
                T* __restrict__ y,              // (B, L, H, P)
                float* __restrict__ final_state,  // (B, H, P, N)
                float* __restrict__ chunk_states,  // (B, C, H, P, N) or null
                long x_rs, long b_rs, long c_rs,  // token-row strides of x, Bm, Cm
                int L, int H, int P, int G, int N) {
  constexpr int Q = kChunk;
  constexpr bool kRound = !std::is_same<T, float>::value;
  const int NS = N + 4;
  const int N4 = N / 4;

  extern __shared__ float4 smem4[];
  float* st = reinterpret_cast<float*>(smem4);  // P * NS
  float* Bs = st + static_cast<size_t>(P) * NS;  // Q * NS
  float* Cs = Bs + Q * NS;                       // Q * NS
  float* xs = Cs + Q * NS;                       // Q * P
  float* W = xs + Q * P;                         // Q * (Q + 1)
  float* sc = W + Q * (Q + 1);                   // Q: inclusive cumsum of dt * A
  float* dtc = sc + Q;                           // Q: dt of the chunk (0 beyond the end)
  float* carry = dtc + Q;                        // Q: dt_j * exp(s_last - s_j); bf16: exp(s_last - s_j)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / G);
  const float Ah = A[h];
  const float Dv = (D != nullptr) ? D[h] : 0.0f;

  for (int i = tid; i < P * NS; i += kScanThreads) st[i] = 0.0f;
  __syncthreads();  // the first chunk's entry state is read back below

  const int n_chunks = (L + Q - 1) / Q;
  for (int t0 = 0; t0 < L; t0 += Q) {
    const int Qc = min(Q, L - t0);

    if (chunk_states != nullptr) {  // the state entering this chunk
      float* cs = chunk_states +
                  ((static_cast<size_t>(b) * n_chunks + t0 / Q) * H + h) * P * N;
      for (int idx = tid; idx < P * N4; idx += kScanThreads) {
        const int p = idx / N4;
        const int n = (idx - p * N4) * 4;
        store4(cs + static_cast<size_t>(p) * N + n, load4(st + static_cast<size_t>(p) * NS + n));
      }
    }

    // ---- load the chunk: B, C, x tiles as fp32, dt ----
    for (int idx = tid; idx < Q * N; idx += kScanThreads) {
      const int t = idx / N;
      const int n = idx - t * N;
      float bv = 0.0f, cv = 0.0f;
      if (t < Qc) {
        const size_t row = static_cast<size_t>(b) * L + t0 + t;
        const size_t col = static_cast<size_t>(g) * N + n;
        bv = to_float(Bm[row * b_rs + col]);
        cv = to_float(Cm[row * c_rs + col]);
      }
      Bs[t * NS + n] = bv;
      Cs[t * NS + n] = cv;
    }
    for (int idx = tid; idx < Q * P; idx += kScanThreads) {
      const int t = idx / P;
      const int p = idx - t * P;
      xs[idx] = (t < Qc)
                    ? to_float(x[(static_cast<size_t>(b) * L + t0 + t) * x_rs +
                                 static_cast<size_t>(h) * P + p])
                    : 0.0f;
    }
    if (tid < Q) {
      dtc[tid] = (tid < Qc) ? dt[(static_cast<size_t>(b) * L + t0 + tid) * H + h] : 0.0f;
    }
    __syncthreads();

    if (tid == 0) {
      float run = 0.0f;
      for (int t = 0; t < Q; ++t) {
        run += dtc[t] * Ah;
        sc[t] = run;
      }
    }
    __syncthreads();
    if (tid < Q) carry[tid] = (kRound ? 1.0f : dtc[tid]) * expf(sc[Q - 1] - sc[tid]);

    // ---- W[i][j] = (C_i . B_j) * exp(s_i - s_j) * dt_j for j <= i ----
    for (int idx = tid; idx < Q * Q; idx += kScanThreads) {
      const int i = idx / Q;
      const int j = idx - i * Q;
      float w = 0.0f;
      if (j <= i) {
        const float* ci = Cs + i * NS;
        const float* bj = Bs + j * NS;
        float dot = 0.0f;
        for (int n4 = 0; n4 < N4; ++n4) {
          const float4 c = load4(ci + 4 * n4);
          const float4 v = load4(bj + 4 * n4);
          dot += c.x * v.x + c.y * v.y + c.z * v.z + c.w * v.w;
        }
        w = kRound ? round_bf16(round_bf16(dot) * round_bf16(expf(sc[i] - sc[j])))
                   : dot * expf(sc[i] - sc[j]) * dtc[j];
      }
      W[i * (Q + 1) + j] = w;
    }
    __syncthreads();

    // ---- outputs of the chunk ----
    for (int idx = tid; idx < Qc * P; idx += kScanThreads) {
      const int t = idx / P;
      const int p = idx - t * P;
      float intra = 0.0f;
      for (int j = 0; j <= t; ++j)  // bf16: W times bf16(x_j dt_j)
        intra += W[t * (Q + 1) + j] * (kRound ? round_bf16(xs[j * P + p] * dtc[j]) : xs[j * P + p]);
      const float* ct = Cs + t * NS;
      const float* sp = st + static_cast<size_t>(p) * NS;
      float inter = 0.0f;
      for (int n4 = 0; n4 < N4; ++n4) {
        const float4 c = load4(ct + 4 * n4);
        float4 v = load4(sp + 4 * n4);
        if constexpr (kRound)  // bf16(state)
          v = make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
        inter += c.x * v.x + c.y * v.y + c.z * v.z + c.w * v.w;
      }
      const float yv = intra + expf(sc[t]) * inter + Dv * xs[idx];
      y[((static_cast<size_t>(b) * L + t0 + t) * H + h) * P + p] = from_float<T>(yv);
    }
    __syncthreads();

    // ---- state = exp(s_last) * state + sum_j carry_j x_j (x) B_j ----
    const float total = expf(sc[Q - 1]);
    for (int idx = tid; idx < P * N4; idx += kScanThreads) {
      const int p = idx / N4;
      const int n = (idx - p * N4) * 4;
      float* sp = st + static_cast<size_t>(p) * NS + n;
      float4 a = load4(sp);
      a.x *= total; a.y *= total; a.z *= total; a.w *= total;
      for (int t = 0; t < Q; ++t) {
        const float c = kRound ? round_bf16(xs[t * P + p] * dtc[t] * carry[t])  // bf16((x dt) e^..)
                               : xs[t * P + p] * carry[t];
        const float4 v = load4(Bs + t * NS + n);
        a.x += c * v.x; a.y += c * v.y; a.z += c * v.z; a.w += c * v.w;
      }
      store4(sp, a);
    }
    __syncthreads();
  }

  float* out = final_state + static_cast<size_t>(bh) * P * N;
  for (int idx = tid; idx < P * N4; idx += kScanThreads) {
    const int p = idx / N4;
    const int n = (idx - p * N4) * 4;
    store4(out + static_cast<size_t>(p) * N + n, load4(st + static_cast<size_t>(p) * NS + n));
  }
}

template <typename T>
cudaError_t launch_ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, void* y, float* final_state,
                            float* chunk_states, long x_rs, long b_rs, long c_rs,
                            int B, int L, int H, int P, int G, int N, cudaStream_t stream) {
  const size_t smem = scan_smem_floats(P, N) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned int>(B) * H), kScanThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      D, static_cast<T*>(y), final_state, chunk_states, x_rs, b_rs, c_rs, L, H, P, G, N);
  return cudaGetLastError();
}

// ============================================================================
// The bf16 path: tensor-core products, the state in registers.
//
// One block per (batch, head) walks the chunks in order. Every product is
// mma.sync m16n8k16 with bf16 operands and fp32 sums, on operands rounded at
// the points listed above; a chunk of 16 tokens is one m16 / k16 tile. P and N
// are zero-padded in shared memory and registers, which is exact, to the first
// tile shape (kPM, kNM) that holds them: (64, 128), the models' shape, (128,
// 128) or (64, 256).
//
// Warp w holds a 16 x 64 slab of the fp32 state, rows p in [16 pb, 16 pb + 16)
// and columns n in [64 nq, 64 nq + 64) (pb = w / kNG, nq = w % kNG, kNG = kNM /
// 64 warps share a row block), as eight m16n8 accumulator tiles (32 floats a
// thread), from the first chunk to the last. A chunk, in every warp:
//   - C (t, n) of its 64 columns as A operands, used twice: the partial scores
//     C B^T over those columns, and the partial y_inter = C bf16(state)^T of its
//     16 rows p, whose B operands are packed from the state registers (two
//     adjacent n8 accumulator tiles of one row block are one k16 operand);
//   - the update state = e^tot state + bf16(x dt e^{tot - s})^T B, the A
//     operand loaded transposed from x and scaled in registers;
//   - after a barrier of the kNG warps of its row block (their partials in
//     shared memory), warps nq = 0, 1 each finish one 8-column tile of y: the
//     scores summed over the group in warp order, masked, weighted and rounded
//     into W as an A operand in registers, y_intra = W bf16(x dt) (one mma),
//     y = y_intra + e^s y_inter + D x, rounded once and stored.
// The scores are made once per row block (kPM / 16 times a block), which
// needs no block barrier: a chunk has one, where its tiles have landed. The
// next chunk's x, B, C and dt are copied by cp.async into the other half of a
// double buffer meanwhile. For training, the state entering each chunk goes
// from the registers to device memory as 16-byte stores (two lanes swap
// halves of their tiles), issued before the chunk's products: 2% faster than
// streaming stores, 6% faster than issuing them after the update.
//
// Bound by bytes: with the chunk states on, their 32 KB a chunk and head (3.96
// GB at the training shape) are the floor; without them, x and y. The walk
// over chunks is serial, so the blocks in flight (three a multiprocessor at
// (64, 128), 80 registers a thread) hide each other's latency.
namespace fwd16 {

using namespace tc;
constexpr int kQ = kChunk;  // 16: one m16 / k16 tile
constexpr int kPS = 24;     // fp32 row stride of the partial tiles: no bank conflicts

struct Args {
  const bf16 *x, *Bm, *Cm;
  const float *dt, *A, *D;
  bf16* y;
  float *final_state, *chunk_states;
  long x_rs, b_rs, c_rs;
  int L, H, P, G, N;
};

template <int PM, int NM>
struct Tiles {
  static constexpr int kPM = PM;  // largest P (head dim); smaller P is zero-padded
  static constexpr int kNM = NM;  // largest N (state dim)
  static constexpr int kNG = kNM / 64;  // warps of one row block, 64 columns n each
  static constexpr int kWarps = kPM / 16 * kNG;
  static constexpr int kT = 32 * kWarps;
  // blocks a multiprocessor: three at 8 warps (80 registers a thread) where every
  // place is in range, two where the bounds are checked (they take more registers)
  static constexpr int min_blocks(bool full) { return kT > 256 ? 1 : full ? 3 : 2; }
  static constexpr int kXS = kPM + 8;  // bf16 row stride of the (Q, P) tile: 144 B at kPM 64
  static constexpr int kBS = kNM + 8;  // bf16 row stride of the (Q, N) tiles: 272 B at kNM 128
  static_assert(kPM % 16 == 0 && kNM % 64 == 0 && kNG >= 2 && kPM / 16 <= 15,
                "16-row blocks, two or more 64-column warps to a block, a named barrier each");

  struct Raw {  // one chunk's inputs as they arrive (zero beyond L, P, N)
    bf16 x[kQ * kXS], B[kQ * kBS], C[kQ * kBS];
    float dt[kQ];
  };
  struct Smem {
    Raw raw[2];
    float sp[kWarps][kQ * kPS];  // each warp's partial scores (t, j) over its columns n
    float yp[kWarps][kQ * kPS];  // ... and partial y_inter (t, p) of its 16 rows p
  };
  static_assert(sizeof(Raw) % 16 == 0, "16-byte aligned tiles");

  // chunk c's x, B, C and dt into `r` by cp.async (rows beyond L as zeros)
  template <bool kFull>
  static __device__ __forceinline__ void load_chunk(Raw& r, const Args& a, int b, int h, int grp,
                                                    int c) {
    const int tid = threadIdx.x;
    const int t0 = c * kQ;
    const int Qc = min(kQ, a.L - t0);
    const int P = kFull ? kPM : a.P, N = kFull ? kNM : a.N;
    const int P4 = P / 4, N4 = N / 4;
#pragma unroll 1
    for (int i = tid; i < kQ * P4; i += kT) {
      const int t = i / P4;
      const int q = i - t * P4;
      const bool ok = t < Qc;
      const size_t row = static_cast<size_t>(b) * a.L + t0 + (ok ? t : 0);
      cp8(r.x + t * kXS + 4 * q, a.x + row * a.x_rs + static_cast<size_t>(h) * P + 4 * q, ok);
    }
#pragma unroll 1
    for (int i = tid; i < 2 * kQ * N4; i += kT) {
      const int which = i >= kQ * N4;
      const int j = i - which * kQ * N4;
      const int t = j / N4;
      const int q = j - t * N4;
      const bool ok = t < Qc;
      const size_t row = static_cast<size_t>(b) * a.L + t0 + (ok ? t : 0);
      const bf16* src = which ? a.Cm + row * a.c_rs : a.Bm + row * a.b_rs;
      cp8((which ? r.C : r.B) + t * kBS + 4 * q, src + static_cast<size_t>(grp) * N + 4 * q, ok);
    }
    if (tid < kQ) {
      const bool ok = tid < Qc;
      cp4(&r.dt[tid], a.dt + (static_cast<size_t>(b) * a.L + t0 + (ok ? tid : 0)) * a.H + h, ok);
    }
  }

  // The state's tiles to `dst` ((P, N) fp32, row p0 of this warp's block): lane
  // pairs swap halves so that each lane stores four columns of one row.
  template <bool kFull>
  static __device__ __forceinline__ void store_state(float* dst, const float (&st)[8][4], int p0,
                                                     int n0, int P, int N) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const bool odd = q & 1;
    const int p = p0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v0 = __shfl_xor_sync(0xffffffffu, odd ? st[i][0] : st[i][2], 1);
      const float v1 = __shfl_xor_sync(0xffffffffu, odd ? st[i][1] : st[i][3], 1);
      const float4 v = odd ? make_float4(v0, v1, st[i][2], st[i][3])
                           : make_float4(st[i][0], st[i][1], v0, v1);
      const int n = n0 + 8 * i + 2 * (q & 2);
      if (kFull || (p < P && n < N))
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(p) * N + n) = v;
    }
  }

  // One (batch, head) chain. kFull: P = kPM and N = kNM: every place is in range
  // and the strides are constants.
  template <bool kFull>
  static __device__ __forceinline__ void walk(const Args& a) {
    extern __shared__ float4 smem4[];
    Smem& sm = *reinterpret_cast<Smem*>(smem4);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int pb = warp / kNG, nq = warp - pb * kNG;
    const int p0 = 16 * pb, n0 = 64 * nq;  // this warp's slab of the state
    const int b = blockIdx.x / a.H;
    const int h = blockIdx.x - b * a.H;
    const int grp = h / (a.H / a.G);
    const int n_chunks = (a.L + kQ - 1) / kQ;
    const int P = kFull ? kPM : a.P, N = kFull ? kNM : a.N;
    const float Ah = a.A[h];
    const float Dv = a.D != nullptr ? a.D[h] : 0.0f;
    const size_t state = static_cast<size_t>(P) * N;

    if (!kFull) {  // zero padding: what the copies never write stays zero
      for (int i = tid; i < static_cast<int>(sizeof(Smem) / 16); i += kT)
        smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      __syncthreads();
    }
    float st[8][4];  // the state: tile i holds rows p0 + g (+ 8), columns n0 + 8 i + 2 q (+ 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = 0.0f;

    load_chunk<kFull>(sm.raw[0], a, b, h, grp, 0);
    cp_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const Raw& raw = sm.raw[c & 1];
      cp_wait<0>();
      __syncthreads();  // chunk c has landed; every warp is done with chunk c - 1
      if (c + 1 < n_chunks) load_chunk<kFull>(sm.raw[(c & 1) ^ 1], a, b, h, grp, c + 1);
      cp_commit();
      const int t0 = c * kQ;
      const int Qc = min(kQ, a.L - t0);
      if (a.chunk_states != nullptr)  // the state entering this chunk
        store_state<kFull>(
            a.chunk_states + ((static_cast<size_t>(b) * n_chunks + c) * a.H + h) * state, st, p0,
            n0, P, N);

      // ---- the decay: lane l holds dt, s, e^s and e^{tot - s} of row l & 15 ----
      const int tl = lane & 15;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kQ; ++k)  // in order, as a sequential cumulative sum
        if (k <= tl) s += __fmul_rn(raw.dt[k], Ah);
      const float tot = __shfl_sync(0xffffffffu, s, kQ - 1);
      const float dtl = raw.dt[tl];
      const float es = expf(s);
      const float carry = expf(tot - s);
      const float etot = expf(tot);

      // ---- partial scores S = C B^T and y_inter = C bf16(state)^T (k = n) ----
      float sc[2][4] = {}, yi[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t cf[4], bj[2][2];  // C (t, n) as an A operand; B (j, n) as B operands, j tiles 0, 1
        ldsm4(cf, quads_down(raw.C + n0 + 16 * ks, kBS, lane));
#pragma unroll
        for (int jt = 0; jt < 2; ++jt) {
          ldsm2(bj[jt][0], bj[jt][1],
                raw.B + (8 * jt + (lane & 7)) * kBS + n0 + 16 * ks + ((lane >> 3) & 1) * 8);
          mma(sc[jt], cf, bj[jt][0], bj[jt][1]);
        }
        const int i0 = 2 * ks, i1 = i0 + 1;
        mma(yi[0], cf, pack(st[i0][0], st[i0][1]), pack(st[i1][0], st[i1][1]));
        mma(yi[1], cf, pack(st[i0][2], st[i0][3]), pack(st[i1][2], st[i1][3]));
      }
      float* spw = sm.sp[warp];
      float* ypw = sm.yp[warp];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = (g + 8 * half) * kPS + 2 * q;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          *reinterpret_cast<float2*>(spw + row + 8 * k) =
              make_float2(sc[k][2 * half], sc[k][2 * half + 1]);
          *reinterpret_cast<float2*>(ypw + row + 8 * k) =
              make_float2(yi[k][2 * half], yi[k][2 * half + 1]);
        }
      }

      // ---- state = e^tot state + bf16(x dt e^{tot - s})^T B (k = t) ----
      {
        uint32_t xa[4];  // x^T (p, t): registers 0, 1 at t = 2q, 2q + 1; 2, 3 at t + 8
        ldsm4t(xa, quads_across(raw.x + p0, kXS, lane));
#pragma unroll
        for (int r = 0; r < 4; r += 2) {
          const int t = 2 * q + 4 * r;
          const float d0 = __shfl_sync(0xffffffffu, dtl, t);
          const float d1 = __shfl_sync(0xffffffffu, dtl, t + 1);
          const float c0 = __shfl_sync(0xffffffffu, carry, t);
          const float c1 = __shfl_sync(0xffffffffu, carry, t + 1);
          xa[r] = pack(lo16(xa[r]) * d0 * c0, hi16(xa[r]) * d1 * c1);
          xa[r + 1] = pack(lo16(xa[r + 1]) * d0 * c0, hi16(xa[r + 1]) * d1 * c1);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] *= etot;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t bg[4];
          ldsm4t(bg, quads_down(raw.B + n0 + 16 * k, kBS, lane));
          mma(st[2 * k], xa, bg[0], bg[1]);
          mma(st[2 * k + 1], xa, bg[2], bg[3]);
        }
      }

      // ---- the row block's partials are in place: warps nq = 0, 1 finish y ----
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pb), "r"(32 * kNG) : "memory");
      if (nq < 2) {
        // W (t, j) as an A operand: S summed over the group in warp order, masked,
        // S and the decay each rounded, then their product
        uint32_t wa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = g + 8 * (r & 1);
          const int j = 2 * q + 8 * (r >> 1);
          const int off = t * kPS + j;
          float2 S = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int k = 0; k < kNG; ++k) {
            const float2 v = *reinterpret_cast<const float2*>(sm.sp[pb * kNG + k] + off);
            S.x += v.x;
            S.y += v.y;
          }
          const float st_ = __shfl_sync(0xffffffffu, s, t);
          const float s0 = __shfl_sync(0xffffffffu, s, j);
          const float s1 = __shfl_sync(0xffffffffu, s, j + 1);
          const float w0 = j <= t ? round_bf16(S.x) * round_bf16(expf(st_ - s0)) : 0.0f;
          const float w1 = j + 1 <= t ? round_bf16(S.y) * round_bf16(expf(st_ - s1)) : 0.0f;
          wa[r] = pack(w0, w1);
        }
        // bf16(x dt) (j, p) of the tile's 8 columns p as a B operand
        const int pc = p0 + 8 * nq;
        uint32_t xb[2];
        ldsm2t(xb[0], xb[1], raw.x + (lane & 15) * kXS + pc);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int j = 2 * q + 8 * k;
          xb[k] = pack(lo16(xb[k]) * __shfl_sync(0xffffffffu, dtl, j),
                       hi16(xb[k]) * __shfl_sync(0xffffffffu, dtl, j + 1));
        }
        float ya[4] = {};
        mma(ya, wa, xb[0], xb[1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = g + 8 * half;
          const int p = pc + 2 * q;
          float2 inter = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int k = 0; k < kNG; ++k) {
            const float2 v =
                *reinterpret_cast<const float2*>(sm.yp[pb * kNG + k] + t * kPS + 8 * nq + 2 * q);
            inter.x += v.x;
            inter.y += v.y;
          }
          const float et = __shfl_sync(0xffffffffu, es, t);
          const float2 xv = ld2(raw.x + t * kXS + p);
          if (t < Qc && (kFull || p < P)) {
            const size_t off = ((static_cast<size_t>(b) * a.L + t0 + t) * a.H + h) * P + p;
            *reinterpret_cast<uint32_t*>(a.y + off) =
                pack(ya[2 * half] + et * inter.x + Dv * xv.x,
                     ya[2 * half + 1] + et * inter.y + Dv * xv.y);
          }
        }
      }
    }
    store_state<kFull>(a.final_state + static_cast<size_t>(blockIdx.x) * state, st, p0, n0,
                              P, N);
  }
};
template <int PM, int NM, bool kFull>
__global__ void __launch_bounds__(Tiles<PM, NM>::kT, Tiles<PM, NM>::min_blocks(kFull))
    ssd_scan_bf16_kernel(const Args a) {
  Tiles<PM, NM>::template walk<kFull>(a);
}

template <class S>
cudaError_t launch_tiles(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = sizeof(typename S::Smem);
  const bool full = args.P == S::kPM && args.N == S::kNM;
  auto kernel = full ? ssd_scan_bf16_kernel<S::kPM, S::kNM, true>
                     : ssd_scan_bf16_kernel<S::kPM, S::kNM, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned int>(B) * args.H), S::kT, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace fwd16

// The bf16 tensor-core path; cudaErrorInvalidValue where it does not take the
// shape or the rows are not 8-byte aligned pieces of four.
cudaError_t launch_ssd_scan_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                                 const void* Cm, const float* D, void* y, float* final_state,
                                 float* chunk_states, long x_rs, long b_rs, long c_rs, int B,
                                 int L, int H, int P, int G, int N, cudaStream_t stream) {
  using tc::bf16;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(Bm) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(Cm) % 8 == 0 && x_rs % 4 == 0 &&
                       b_rs % 4 == 0 && c_rs % 4 == 0;
  if (!aligned) return cudaErrorInvalidValue;
  fwd16::Args args;
  args.x = static_cast<const bf16*>(x);
  args.Bm = static_cast<const bf16*>(Bm);
  args.Cm = static_cast<const bf16*>(Cm);
  args.dt = dt; args.A = A; args.D = D;
  args.y = static_cast<bf16*>(y);
  args.final_state = final_state;
  args.chunk_states = chunk_states;
  args.x_rs = x_rs; args.b_rs = b_rs; args.c_rs = c_rs;
  args.L = L; args.H = H; args.P = P; args.G = G; args.N = N;
  cudaError_t err = cudaErrorInvalidValue;
  tc::with_tiles<fwd16::Tiles>(P, N, [&](auto tiles) {
    err = fwd16::launch_tiles<decltype(tiles)>(args, B, stream);
  });
  return err;
}

}  // namespace omt

// Bytes of dynamic shared memory a block of the bf16 tensor-core forward takes
// at head dim P and state dim N; 0 if that kernel does not take them (bf16
// inputs of such shapes take the multiply-add kernel).
extern "C" long omt_ssd_scan_bf16_smem_bytes(int P, int N) {
  long bytes = 0;
  omt::tc::with_tiles<omt::fwd16::Tiles>(P, N, [&](auto tiles) {
    bytes = static_cast<long>(sizeof(typename decltype(tiles)::Smem));
  });
  return bytes;
}

// N must be a multiple of 4 and `final_state` 16-byte aligned. x_dtype is the
// type of x, Bm, Cm and y. x_rs, b_rs and c_rs are the elements between
// consecutive (batch, token) rows of x, Bm and Cm (H*P and G*N when they are
// contiguous); dt, y, final_state and chunk_states are contiguous. D may be
// null; chunk_states may be null (inference), else it receives the state
// entering each chunk of kChunk tokens. bf16 inputs whose (P, N) the
// tensor-core kernel takes (omt_ssd_scan_bf16_smem_bytes is not 0) further
// need x, Bm, Cm 8-byte aligned with row strides that are multiples of 4.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int omt_ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, void* y, float* final_state,
                            float* chunk_states, long x_rs, long b_rs, long c_rs, int B, int L, int H, int P,
                            int G, int N, int x_dtype,
                            void* stream) {
  using namespace omt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kBF16 && omt_ssd_scan_bf16_smem_bytes(P, N) != 0)
    return launch_ssd_scan_bf16(x, dt, A, Bm, Cm, D, y, final_state, chunk_states, x_rs, b_rs, c_rs, B, L, H, P, G, N, s);
  if (x_dtype == kBF16)
    return launch_ssd_scan<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, final_state, chunk_states, x_rs, b_rs, c_rs, B, L, H, P, G, N, s);
  if (x_dtype == kF32)
    return launch_ssd_scan<float>(x, dt, A, Bm, Cm, D, y, final_state, chunk_states, x_rs, b_rs, c_rs, B, L, H, P, G, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
