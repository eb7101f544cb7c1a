// Chunked Mamba-2 SSD forward (prefill), zero initial state.
//
// One thread block per (batch, head) walks the sequence in chunks of kChunk
// tokens and carries the head's fp32 (P, N) state in shared memory from the
// first chunk to the last, so neither the decay matrix nor any chunk state
// touches device memory. Per chunk, with s the inclusive cumulative sum of
// dt * A inside the chunk (computed here, never materialised outside):
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
// running the recurrence again. All products are fp32 multiply-adds on values
// widened from the input type, which is exact for fp32 inputs and at least as
// accurate as bf16 dot operands for bf16 inputs.
//
// Bound by bytes at prefill shapes (x and y once each, the final state written
// once). This first version spends more time than that on its fp32 products
// and on shared-memory traffic; tensor-core products are later work. The chunk
// length is chosen by shared memory (state + B/C/x tiles of one chunk), not by
// the model's chunk_size: chunking does not change the result. x, B and C are
// read through a row stride (elements from one token's row to the next), so
// column slices of the fused conv output go in without a copy.
#include "common.cuh"

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
  float* carry = dtc + Q;                        // Q: dt_j * exp(s_last - s_j)

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
    if (tid < Q) carry[tid] = dtc[tid] * expf(sc[Q - 1] - sc[tid]);

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
        w = dot * expf(sc[i] - sc[j]) * dtc[j];
      }
      W[i * (Q + 1) + j] = w;
    }
    __syncthreads();

    // ---- outputs of the chunk ----
    for (int idx = tid; idx < Qc * P; idx += kScanThreads) {
      const int t = idx / P;
      const int p = idx - t * P;
      float intra = 0.0f;
      for (int j = 0; j <= t; ++j) intra += W[t * (Q + 1) + j] * xs[j * P + p];
      const float* ct = Cs + t * NS;
      const float* sp = st + static_cast<size_t>(p) * NS;
      float inter = 0.0f;
      for (int n4 = 0; n4 < N4; ++n4) {
        const float4 c = load4(ct + 4 * n4);
        const float4 v = load4(sp + 4 * n4);
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
        const float c = xs[t * P + p] * carry[t];
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

}  // namespace omt

// N must be a multiple of 4 and `final_state` 16-byte aligned. x_dtype is the
// type of x, Bm, Cm and y. x_rs, b_rs and c_rs are the elements between
// consecutive (batch, token) rows of x, Bm and Cm (H*P and G*N when they are
// contiguous); dt, y, final_state and chunk_states are contiguous. D may be
// null; chunk_states may be null (inference), else it receives the state
// entering each chunk of kChunk tokens. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int omt_ssd_scan(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* D, void* y, float* final_state,
                            float* chunk_states, long x_rs, long b_rs, long c_rs, int B, int L, int H, int P,
                            int G, int N, int x_dtype,
                            void* stream) {
  using namespace omt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kBF16)
    return launch_ssd_scan<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, final_state, chunk_states, x_rs, b_rs, c_rs, B, L, H, P, G, N, s);
  if (x_dtype == kF32)
    return launch_ssd_scan<float>(x, dt, A, Bm, Cm, D, y, final_state, chunk_states, x_rs, b_rs, c_rs, B, L, H, P, G, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
