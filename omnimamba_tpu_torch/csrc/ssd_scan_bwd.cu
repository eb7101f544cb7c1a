// Backward of the chunked Mamba-2 SSD scan (ssd_scan.cu), zero initial state.
//
// One thread block takes one batch row and a tile of heads of one B/C group.
// For each head it walks the sequence in chunks of kBwdChunk tokens from the
// last chunk to the first and carries the fp32 (P, N) adjoint of the state in
// shared memory, as the forward carries the state. The state entering a chunk
// is read from what the forward saved (B, C, H, P, N); the (Q, Q) decay and
// score matrices of the chunk are rebuilt here and never touch device memory.
//
// Per head and chunk, with a_k = dt_k A, s the inclusive cumulative sum of a
// inside the chunk, tot = s_last, w_tj = e^{s_t - s_j} for t >= j, h_in the
// state entering the chunk, adj the cotangent of the state leaving it and g
// the cotangent of y:
//
//   M1_tj = (g_t . x_j) w_tj dt_j        M2_tj = (C_t . B_j) w_tj
//   dC_t  = sum_j M1_tj B_j + e^{s_t} (g_t h_in)
//   dB_j  = sum_t M1_tj C_t + dt_j e^{tot - s_j} (x_j adj)       [second term: dB2_j]
//   K_j   = sum_t M2_tj g_t + e^{tot - s_j} (adj B_j)
//   dx_j  = dt_j K_j + D g_j             dD = sum g . x
//   r_t   = C_t . dC_t - B_t . dB_t      [dL/ds_t: the decay cotangent folded into dC, dB]
//   da_k  = sum_{t >= k} r_t + sum_j B_j . dB2_j + e^{tot} <h_in, adj>
//   ddt_k = A da_k + x_k . K_k           dA = sum dt_k da_k
//   adj  <- e^{tot} adj + sum_t e^{s_t} g_t (x) C_t              [entering the chunk]
//
// Every exponent formed is <= 0 (s is a cumulative sum of non-positive terms),
// so nothing is clamped. The ragged last chunk is masked (dt = 0 and x = g = B
// = C = 0 beyond the end). All products are fp32 multiply-adds on values
// widened from the input type: exact to summation order for fp32 inputs.
//
// Sums across blocks are taken without atomics, in a fixed order: the heads of
// a block's tile add their dB / dC into the block's own fp32 partial (one
// thread owns an element through all heads), dA and dD are written per (batch,
// head), and two small kernels sum the partials of a group's tiles and of the
// batch in index order. The same inputs give the same bits on every run.
//
// Bound by bytes by the roofline rule (x, g, the saved states read once, dx
// written once); this first version is held back by its multiply-adds and
// shared-memory traffic, like the forward. x, B, C and g are read through row
// strides; the outputs are contiguous.
#include "common.cuh"

namespace omt {

constexpr int kBwdThreads = 256;
constexpr int kBwdChunk = 16;  // equals kChunk of ssd_scan.cu: one saved state per chunk
constexpr int kAdjRows = 8;    // rows of the adjoint one thread updates at a time

// Floats of dynamic shared memory for one block.
__host__ __device__ inline size_t scan_bwd_smem_floats(int P, int N) {
  const size_t NS = static_cast<size_t>(N) + 4;  // rows padded against bank conflicts
  const size_t PS = static_cast<size_t>(P) + 1;
  const size_t Q = kBwdChunk;
  return static_cast<size_t>(P) * NS  // adjoint of the state
         + 4 * Q * NS                 // B, C, dB, dC tiles
         + 3 * Q * PS                 // x, g, x * K tiles
         + 2 * Q * (Q + 1)            // M1, M2
         + 6 * Q;                     // s, dt, e^s, e^{tot - s}, r, x . K
}

__device__ __forceinline__ void fma4(float4& acc, float s, const float4 v) {
  acc.x += s * v.x; acc.y += s * v.y; acc.z += s * v.z; acc.w += s * v.w;
}
__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ssd_scan_bwd_kernel(const T* __restrict__ x,         // (B, L, H, P)
                    const float* __restrict__ dt,    // (B, L, H)
                    const float* __restrict__ A,     // (H)
                    const T* __restrict__ Bm,        // (B, L, G, N)
                    const T* __restrict__ Cm,        // (B, L, G, N)
                    const float* __restrict__ D,     // (H) or null
                    const float* __restrict__ hin,   // (B, C, H, P, N) states entering the chunks
                    const T* __restrict__ gy,        // (B, L, H, P)
                    const float* __restrict__ gstate,  // (B, H, P, N) or null
                    T* __restrict__ dx,              // (B, L, H, P)
                    float* __restrict__ ddt,         // (B, L, H)
                    float* dB_part,                  // (B, L, tiles, N), read back by its writer
                    float* dC_part,                  // (B, L, tiles, N)
                    float* __restrict__ dA_part,     // (B, H)
                    float* __restrict__ dD_part,     // (B, H)
                    long x_rs, long b_rs, long c_rs, long g_rs,  // token-row strides
                    int L, int H, int P, int G, int N, int tile) {
  constexpr int Q = kBwdChunk;
  constexpr int kWarps = kBwdThreads / 32;
  const int NS = N + 4;
  const int N4 = N / 4;
  const int PS = P + 1;

  extern __shared__ float4 smem4[];
  float* adj = reinterpret_cast<float*>(smem4);   // P * NS
  float* Bs = adj + static_cast<size_t>(P) * NS;  // Q * NS each
  float* Cs = Bs + Q * NS;
  float* dBs = Cs + Q * NS;
  float* dCs = dBs + Q * NS;
  float* xs = dCs + Q * NS;  // Q * PS each
  float* gs = xs + Q * PS;
  float* xk = gs + Q * PS;   // x_j[p] * K_j[p]
  float* M1 = xk + Q * PS;   // Q * (Q + 1) each
  float* M2 = M1 + Q * (Q + 1);
  float* sc = M2 + Q * (Q + 1);  // Q each
  float* dtc = sc + Q;
  float* es = dtc + Q;     // e^{s_t}
  float* carry = es + Q;   // e^{tot - s_j}
  float* rv = carry + Q;   // r_t
  float* ks = rv + Q;      // x_t . K_t
  __shared__ float scratch[32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = H / tile;
  const int b = blockIdx.x / tiles;
  const int tl = blockIdx.x - b * tiles;
  const int n_chunks = (L + Q - 1) / Q;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int hi = 0; hi < tile; ++hi) {
    const int h = tl * tile + hi;
    const int g = h / (H / G);
    const float Ah = A[h];
    const float Dv = (D != nullptr) ? D[h] : 0.0f;

    // adjoint of the final state: its cotangent, or zero where there is none
    for (int idx = tid; idx < P * N4; idx += kBwdThreads) {
      const int p = idx / N4;
      const int n = (idx - p * N4) * 4;
      float4 v = zero4;
      if (gstate != nullptr)
        v = load4(gstate + ((static_cast<size_t>(b) * H + h) * P + p) * N + n);
      store4(adj + static_cast<size_t>(p) * NS + n, v);
    }
    float dA_acc = 0.0f;  // thread 0 only
    float dD_acc = 0.0f;  // every thread's share, summed after the last chunk
    __syncthreads();

    for (int c = n_chunks - 1; c >= 0; --c) {
      const int t0 = c * Q;
      const int Qc = min(Q, L - t0);
      const float* hc = hin + ((static_cast<size_t>(b) * n_chunks + c) * H + h) * P * N;

      // ---- load the chunk as fp32: B, C, x, g tiles and dt (0 beyond the end) ----
      for (int idx = tid; idx < Q * N; idx += kBwdThreads) {
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
      for (int idx = tid; idx < Q * P; idx += kBwdThreads) {
        const int t = idx / P;
        const int p = idx - t * P;
        float xv = 0.0f, gv = 0.0f;
        if (t < Qc) {
          const size_t row = static_cast<size_t>(b) * L + t0 + t;
          const size_t col = static_cast<size_t>(h) * P + p;
          xv = to_float(x[row * x_rs + col]);
          gv = to_float(gy[row * g_rs + col]);
        }
        xs[t * PS + p] = xv;
        gs[t * PS + p] = gv;
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
      const float tot = sc[Q - 1];
      const float etot = expf(tot);
      if (tid < Q) {
        es[tid] = expf(sc[tid]);
        carry[tid] = expf(tot - sc[tid]);
      }

      // ---- M1_tj = (g_t . x_j) w_tj dt_j and M2_tj = (C_t . B_j) w_tj for j <= t ----
      for (int idx = tid; idx < Q * Q; idx += kBwdThreads) {
        const int t = idx / Q;
        const int j = idx - t * Q;
        float m1 = 0.0f, m2 = 0.0f;
        if (j <= t) {
          float cb = 0.0f;
          for (int n4 = 0; n4 < N4; ++n4)
            cb += dot4(load4(Cs + t * NS + 4 * n4), load4(Bs + j * NS + 4 * n4));
          float gx = 0.0f;
          for (int p = 0; p < P; ++p) gx += gs[t * PS + p] * xs[j * PS + p];
          const float w = expf(sc[t] - sc[j]);
          m1 = gx * w * dtc[j];
          m2 = cb * w;
        }
        M1[t * (Q + 1) + j] = m1;
        M2[t * (Q + 1) + j] = m2;
      }
      __syncthreads();

      // ---- this head's dC and dB tiles; chi = sum_j B_j . dB2_j. A thread takes
      // two rows (t, t + Q/2) of one column quad, so every h_in, adj, B and C
      // vector it loads feeds both; M1 is 0 above the diagonal, which lets the
      // row loops run to a common end without changing any sum.
      float chi = 0.0f;
      for (int idx = tid; idx < (Q / 2) * N4; idx += kBwdThreads) {
        const int ta = idx / N4;
        const int tb = ta + Q / 2;
        const int n = (idx - ta * N4) * 4;
        float4 dca = zero4, dcb = zero4;
        for (int j = 0; j <= tb; ++j) {
          const float4 v = load4(Bs + j * NS + n);
          fma4(dca, M1[ta * (Q + 1) + j], v);
          fma4(dcb, M1[tb * (Q + 1) + j], v);
        }
        float4 dba = zero4, dbb = zero4;  // rows taken as the source positions j = ta, tb
        for (int tt = ta; tt < Q; ++tt) {
          const float4 v = load4(Cs + tt * NS + n);
          fma4(dba, M1[tt * (Q + 1) + ta], v);
          fma4(dbb, M1[tt * (Q + 1) + tb], v);
        }
        float4 gha = zero4, ghb = zero4;  // g_t h_in
        float4 xaa = zero4, xab = zero4;  // x_j adj
        for (int p = 0; p < P; ++p) {
          const float4 hv4 =
              __ldg(reinterpret_cast<const float4*>(hc + static_cast<size_t>(p) * N + n));
          const float4 av4 = load4(adj + static_cast<size_t>(p) * NS + n);
          fma4(gha, gs[ta * PS + p], hv4);
          fma4(ghb, gs[tb * PS + p], hv4);
          fma4(xaa, xs[ta * PS + p], av4);
          fma4(xab, xs[tb * PS + p], av4);
        }
        fma4(dca, es[ta], gha);
        fma4(dcb, es[tb], ghb);
        store4(dCs + ta * NS + n, dca);
        store4(dCs + tb * NS + n, dcb);
        const float fa = dtc[ta] * carry[ta];
        const float fb = dtc[tb] * carry[tb];
        const float4 db2a = make_float4(fa * xaa.x, fa * xaa.y, fa * xaa.z, fa * xaa.w);
        const float4 db2b = make_float4(fb * xab.x, fb * xab.y, fb * xab.z, fb * xab.w);
        chi += dot4(load4(Bs + ta * NS + n), db2a) + dot4(load4(Bs + tb * NS + n), db2b);
        dba.x += db2a.x; dba.y += db2a.y; dba.z += db2a.z; dba.w += db2a.w;
        dbb.x += db2b.x; dbb.y += db2b.y; dbb.z += db2b.z; dbb.w += db2b.w;
        store4(dBs + ta * NS + n, dba);
        store4(dBs + tb * NS + n, dbb);
      }

      // ---- K_j, dx_j, x_j . K_j and dD: a thread takes four source positions
      // (j, j + Q/4, ...) of one channel p, so it reads adj's row p once ----
      for (int idx = tid; idx < (Q / 4) * P; idx += kBwdThreads) {
        const int j0 = idx / P;
        const int p = idx - j0 * P;
        float k1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = j0; t < Q; ++t) {  // M2 is 0 for t < j
          const float gv = gs[t * PS + p];
#pragma unroll
          for (int q = 0; q < 4; ++q) k1[q] += M2[t * (Q + 1) + j0 + q * (Q / 4)] * gv;
        }
        float k2[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // (adj B_j)_p
        const float* ap = adj + static_cast<size_t>(p) * NS;
        for (int n4 = 0; n4 < N4; ++n4) {
          const float4 a = load4(ap + 4 * n4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            k2[q] += dot4(a, load4(Bs + (j0 + q * (Q / 4)) * NS + 4 * n4));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q * (Q / 4);
          const float k = k1[q] + carry[j] * k2[q];
          const float xv = xs[j * PS + p];
          const float gv = gs[j * PS + p];
          xk[j * PS + p] = xv * k;
          dD_acc += gv * xv;
          if (j < Qc) {
            dx[((static_cast<size_t>(b) * L + t0 + j) * H + h) * P + p] =
                from_float<T>(dtc[j] * k + Dv * gv);
          }
        }
      }

      // ---- <h_in, adj> ----
      float hv = 0.0f;
      for (int idx = tid; idx < P * N4; idx += kBwdThreads) {
        const int p = idx / N4;
        const int n = (idx - p * N4) * 4;
        hv += dot4(__ldg(reinterpret_cast<const float4*>(hc + static_cast<size_t>(p) * N + n)),
                   load4(adj + static_cast<size_t>(p) * NS + n));
      }
      chi = block_sum(chi, scratch);
      hv = block_sum(hv, scratch);  // the barriers inside also complete the tiles above
      const float bias = chi + etot * hv;

      // ---- r_t = C_t . dC_t - B_t . dB_t and x_t . K_t, one warp per row ----
      for (int t = warp; t < Q; t += kWarps) {
        float rr = 0.0f;
        for (int n = lane; n < N; n += 32)
          rr += Cs[t * NS + n] * dCs[t * NS + n] - Bs[t * NS + n] * dBs[t * NS + n];
        rr = warp_sum(rr);
        float kk = 0.0f;
        for (int p = lane; p < P; p += 32) kk += xk[t * PS + p];
        kk = warp_sum(kk);
        if (lane == 0) {
          rv[t] = rr;
          ks[t] = kk;
        }
      }

      // ---- the block's dB / dC partial: the first head stores, the others add.
      // An element is read back by the thread that wrote it.
      for (int idx = tid; idx < Q * N4; idx += kBwdThreads) {
        const int t = idx / N4;
        const int n = (idx - t * N4) * 4;
        if (t < Qc) {
          const size_t off = ((static_cast<size_t>(b) * L + t0 + t) * tiles + tl) * N + n;
          float4 vb = load4(dBs + t * NS + n);
          float4 vc = load4(dCs + t * NS + n);
          if (hi > 0) {
            const float4 ob = load4(dB_part + off);
            const float4 oc = load4(dC_part + off);
            vb.x += ob.x; vb.y += ob.y; vb.z += ob.z; vb.w += ob.w;
            vc.x += oc.x; vc.y += oc.y; vc.z += oc.z; vc.w += oc.w;
          }
          store4(dB_part + off, vb);
          store4(dC_part + off, vc);
        }
      }
      __syncthreads();

      // ---- da_k = sum_{t >= k} r_t + bias; ddt_k = A da_k + x_k . K_k; dA += dt_k da_k ----
      if (tid == 0) {
        float run = 0.0f;
        for (int t = Q - 1; t >= 0; --t) {
          run += rv[t];
          const float da = run + bias;
          if (t < Qc) ddt[(static_cast<size_t>(b) * L + t0 + t) * H + h] = Ah * da + ks[t];
          dA_acc += dtc[t] * da;
        }
      }

      // ---- adjoint of the state entering this chunk: a thread takes up to
      // kAdjRows rows p of one column quad, so each C vector feeds them all ----
      const int pgroups = (P + kAdjRows - 1) / kAdjRows;
      for (int idx = tid; idx < pgroups * N4; idx += kBwdThreads) {
        const int p0 = idx / N4;
        const int n = (idx - p0 * N4) * 4;
        float4 a[kAdjRows];
#pragma unroll
        for (int q = 0; q < kAdjRows; ++q) {
          const int p = p0 + q * pgroups;
          a[q] = zero4;
          if (p < P) {
            a[q] = load4(adj + static_cast<size_t>(p) * NS + n);
            a[q].x *= etot; a[q].y *= etot; a[q].z *= etot; a[q].w *= etot;
          }
        }
        for (int t = 0; t < Q; ++t) {
          const float4 cv = load4(Cs + t * NS + n);
          const float e = es[t];
#pragma unroll
          for (int q = 0; q < kAdjRows; ++q) {
            const int p = p0 + q * pgroups;
            if (p < P) fma4(a[q], e * gs[t * PS + p], cv);
          }
        }
#pragma unroll
        for (int q = 0; q < kAdjRows; ++q) {
          const int p = p0 + q * pgroups;
          if (p < P) store4(adj + static_cast<size_t>(p) * NS + n, a[q]);
        }
      }
      __syncthreads();
    }

    dD_acc = block_sum(dD_acc, scratch);
    if (tid == 0) {
      dA_part[static_cast<size_t>(b) * H + h] = dA_acc;
      dD_part[static_cast<size_t>(b) * H + h] = dD_acc;
    }
  }
}

// dB[row, g] = sum of the partials of group g's tiles, in tile order; likewise dC.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_reduce_bc_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                         T* __restrict__ dB, T* __restrict__ dC, long total, int tiles, int G,
                         int N) {
  const long idx = static_cast<long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx >= total) return;  // total = rows * G * N / 4
  const int N4 = N / 4;
  const int n = static_cast<int>(idx % N4) * 4;
  const long rg = idx / N4;
  const int g = static_cast<int>(rg % G);
  const long row = rg / G;
  const int per_group = tiles / G;
  float4 ab = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ac = ab;
  for (int k = 0; k < per_group; ++k) {
    const size_t off = (static_cast<size_t>(row) * tiles + g * per_group + k) * N + n;
    const float4 vb = load4(dB_part + off);
    const float4 vc = load4(dC_part + off);
    ab.x += vb.x; ab.y += vb.y; ab.z += vb.z; ab.w += vb.w;
    ac.x += vc.x; ac.y += vc.y; ac.z += vc.z; ac.w += vc.w;
  }
  const size_t out = (static_cast<size_t>(row) * G + g) * N + n;
  store4(dB + out, ab);
  store4(dC + out, ac);
}

// dA[h] = sum over the batch of dA_part[b, h], in batch order; likewise dD.
__global__ void __launch_bounds__(kBwdThreads)
ssd_bwd_reduce_ad_kernel(const float* __restrict__ dA_part, const float* __restrict__ dD_part,
                         float* __restrict__ dA, float* __restrict__ dD, int B, int H) {
  const int h = blockIdx.x * kBwdThreads + threadIdx.x;
  if (h >= H) return;
  float a = 0.0f, d = 0.0f;
  for (int b = 0; b < B; ++b) {
    a += dA_part[static_cast<size_t>(b) * H + h];
    d += dD_part[static_cast<size_t>(b) * H + h];
  }
  dA[h] = a;
  dD[h] = d;
}

template <typename T>
cudaError_t launch_ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                                const void* Cm, const float* D, const float* hin,
                                const void* gy, const float* gstate, void* dx, float* ddt,
                                float* dA, void* dB, void* dC, float* dD, float* dBC_part,
                                float* dAD_part, long x_rs, long b_rs, long c_rs, long g_rs,
                                int B, int L, int H, int P, int G, int N, int tile,
                                cudaStream_t stream) {
  const size_t smem = scan_bwd_smem_floats(P, N) * sizeof(float);
  auto kernel = ssd_scan_bwd_kernel<T>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tiles = H / tile;
  const size_t part = static_cast<size_t>(B) * L * tiles * N;
  float* dB_part = dBC_part;
  float* dC_part = dBC_part + part;
  float* dA_part = dAD_part;
  float* dD_part = dAD_part + static_cast<size_t>(B) * H;
  kernel<<<dim3(static_cast<unsigned int>(B) * tiles), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), D,
      hin, static_cast<const T*>(gy), gstate, static_cast<T*>(dx), ddt, dB_part, dC_part,
      dA_part, dD_part, x_rs, b_rs, c_rs, g_rs, L, H, P, G, N, tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long total = static_cast<long>(B) * L * G * (N / 4);
  const unsigned int blocks = static_cast<unsigned int>((total + kBwdThreads - 1) / kBwdThreads);
  ssd_bwd_reduce_bc_kernel<T><<<dim3(blocks), kBwdThreads, 0, stream>>>(
      dB_part, dC_part, static_cast<T*>(dB), static_cast<T*>(dC), total, tiles, G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_ad_kernel<<<dim3((H + kBwdThreads - 1) / kBwdThreads), kBwdThreads, 0, stream>>>(
      dA_part, dD_part, dA, dD, B, H);
  return cudaGetLastError();
}

}  // namespace omt

// Backward of omt_ssd_scan. x_dtype is the type of x, Bm, Cm, gy, dx, dB and
// dC; dt, A, D, hin, gstate, ddt, dA and dD are fp32. x_rs, b_rs, c_rs and g_rs
// are the elements between consecutive (batch, token) rows of x, Bm, Cm and gy;
// everything else is contiguous. hin is the forward's chunk_states. D may be
// null (then dD receives zeros) and gstate may be null (no cotangent of the
// final state: nothing is read). `tile` heads share a block: it must divide
// the heads of a group, H / G. dBC_part is scratch of 2 * B * L * (H / tile) * N
// floats, dAD_part of 2 * B * H floats. N must be a multiple of 4 and the fp32
// buffers 16-byte aligned. Returns the cudaError_t of the launches (0 = success).
extern "C" int omt_ssd_scan_bwd(const void* x, const float* dt, const float* A, const void* Bm,
                                const void* Cm, const float* D, const float* hin,
                                const void* gy, const float* gstate, void* dx, float* ddt,
                                float* dA, void* dB, void* dC, float* dD, float* dBC_part,
                                float* dAD_part, long x_rs, long b_rs, long c_rs, long g_rs,
                                int B, int L, int H, int P, int G, int N, int tile, int x_dtype,
                                void* stream) {
  using namespace omt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % 4 != 0 || tile < 1 || G < 1 || H % G != 0 || (H / G) % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kBF16)
    return launch_ssd_scan_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, hin, gy, gstate, dx, ddt, dA, dB, dC, dD, dBC_part, dAD_part, x_rs, b_rs, c_rs, g_rs, B, L, H, P, G, N, tile, s);
  if (x_dtype == kF32)
    return launch_ssd_scan_bwd<float>(x, dt, A, Bm, Cm, D, hin, gy, gstate, dx, ddt, dA, dB, dC, dD, dBC_part, dAD_part, x_rs, b_rs, c_rs, g_rs, B, L, H, P, G, N, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
