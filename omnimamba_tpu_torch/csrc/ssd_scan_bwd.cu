// Backward of the chunked Mamba-2 SSD scan (ssd_scan.cu), zero initial state.
// Replaces _ssd_bwd_kernel of omnimamba_tpu/ops/ssd_pallas_bwd.py. Two paths,
// as the JAX kernel has two operand types (its mxu_dtype): fp32 inputs take
// the fp32 kernel described here, bf16 inputs the tensor-core kernel further
// down (namespace bwd16), which rounds the operands of its products to bf16
// where the JAX kernel does.
//
// The fp32 path. One thread block takes one batch row and a tile of heads of
// one B/C group.
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
// = C = 0 beyond the end). All products are fp32 multiply-adds: exact to
// summation order for fp32 inputs. bf16 inputs take this kernel only at the
// shapes the tensor-core kernel below does not take; it then rounds the
// operands of its products to bf16 where that kernel (and ssd_bwd_plain)
// does: x dt, g e^s, x dt e^{tot - s}, the state, the adjoint, (g . x dt) w
// and (C . B) w.
//
// Sums across blocks are taken without atomics, in a fixed order: the heads of
// a block's tile add their dB / dC into the block's own fp32 partial (one
// thread owns an element through all heads), dA and dD are written per (batch,
// head), and two small kernels sum the partials of a group's tiles and of the
// batch in index order. The same inputs give the same bits on every run.
//
// Bound by bytes by the roofline rule (x, g, the saved states read once, dx
// written once); this path is held back by its multiply-adds and
// shared-memory traffic, like the forward. x, B, C and g are read through row
// strides; the outputs are contiguous.
#include <cstddef>

#include "common.cuh"
#include "tensor_core.cuh"

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

// an operand of a product: rounded to bf16 for bf16 inputs, as it is for fp32
template <bool kRound>
__device__ __forceinline__ float op(float v) { return kRound ? round_bf16(v) : v; }
template <bool kRound>
__device__ __forceinline__ float4 op4(float4 v) {
  return make_float4(op<kRound>(v.x), op<kRound>(v.y), op<kRound>(v.z), op<kRound>(v.w));
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
  constexpr bool kRound = !std::is_same<T, float>::value;
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
          const float w = expf(sc[t] - sc[j]);
          float gx = 0.0f;
          if constexpr (kRound) {  // g . bf16(x dt), then both weighted products rounded
            for (int p = 0; p < P; ++p) gx += gs[t * PS + p] * round_bf16(xs[j * PS + p] * dtc[j]);
            m1 = round_bf16(gx * w);
            m2 = round_bf16(cb * w);
          } else {
            for (int p = 0; p < P; ++p) gx += gs[t * PS + p] * xs[j * PS + p];
            m1 = gx * w * dtc[j];
            m2 = cb * w;
          }
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
        float4 gha = zero4, ghb = zero4;  // g_t h_in; bf16: bf16(g_t e^{s_t}) bf16(h_in)
        float4 xaa = zero4, xab = zero4;  // x_j adj; bf16: bf16(x_j dt_j e^{tot - s_j}) bf16(adj)
        const float fa = dtc[ta] * carry[ta];
        const float fb = dtc[tb] * carry[tb];
        for (int p = 0; p < P; ++p) {
          const float4 hv4 = op4<kRound>(
              __ldg(reinterpret_cast<const float4*>(hc + static_cast<size_t>(p) * N + n)));
          const float4 av4 = op4<kRound>(load4(adj + static_cast<size_t>(p) * NS + n));
          if constexpr (kRound) {
            fma4(gha, round_bf16(gs[ta * PS + p] * es[ta]), hv4);
            fma4(ghb, round_bf16(gs[tb * PS + p] * es[tb]), hv4);
            fma4(xaa, round_bf16(xs[ta * PS + p] * fa), av4);
            fma4(xab, round_bf16(xs[tb * PS + p] * fb), av4);
          } else {
            fma4(gha, gs[ta * PS + p], hv4);
            fma4(ghb, gs[tb * PS + p], hv4);
            fma4(xaa, xs[ta * PS + p], av4);
            fma4(xab, xs[tb * PS + p], av4);
          }
        }
        // the scales went into the rounded operands for bf16
        fma4(dca, kRound ? 1.0f : es[ta], gha);
        fma4(dcb, kRound ? 1.0f : es[tb], ghb);
        store4(dCs + ta * NS + n, dca);
        store4(dCs + tb * NS + n, dcb);
        const float sa = kRound ? 1.0f : fa, sb = kRound ? 1.0f : fb;
        const float4 db2a = make_float4(sa * xaa.x, sa * xaa.y, sa * xaa.z, sa * xaa.w);
        const float4 db2b = make_float4(sb * xab.x, sb * xab.y, sb * xab.z, sb * xab.w);
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
          const float4 a = op4<kRound>(load4(ap + 4 * n4));
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
            if (p < P) fma4(a[q], op<kRound>(e * gs[t * PS + p]), cv);
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

// ============================================================================
// The bf16 path: tensor-core products, the adjoint in registers.
//
// One block of kNM / 16 warps walks one (batch, head) chain from the last
// chunk to the first; the blocks of a head tile (`tile` heads of one group)
// form a cluster, which sums its heads' dB / dC in shared memory. Every product
// is mma.sync m16n8k16 with bf16 operands and fp32 sums, on operands rounded
// where _ssd_bwd_kernel rounds them for bf16 inputs (ssd_pallas_bwd.py:385;
// ssd_bwd_plain lists the points). P and N are zero-padded in shared memory
// and registers, which is exact, to the first of three tile shapes (kPM, kNM)
// that holds them: (64, 128), the models' shape, (128, 128) and (64, 256).
//
// Warp w holds the fp32 adjoint transposed, adj^T (n, p), rows n in
// [16w, 16w + 16), all kPM columns p, as kPM / 8 m16n8 accumulator tiles
// (kPM / 2 floats a thread), for the whole walk. The state entering a chunk,
// h_in, comes into shared memory by cp.async a whole chunk ahead, each warp
// copying the columns n it reads itself; a thread reads it once, at its own
// (n, p) places, for both <h_in, adj> (fp32) and dC2^T = h_in^T ge^T (its bf16
// copy as the A operand), as adj in registers feeds dB2^T = adj^T xc^T. The
// products of a chunk, the first of them made at the end of the chunk after it
// (in the walk's order), once that chunk's adjoint update is done:
//   first: each warp, its 16 rows n: dC2^T and <h_in, adj>; warps 0-3: S = C B^T
//     and Gxd = g xd^T, one j tile each, * w, rounded (ge and xd are rounded
//     from the chunk's g and x in registers);
//   each warp, its 16 rows n: dC^T += B^T Gxdw^T, dB^T = adj^T xc^T + C^T Gxdw,
//     then the update adj^T = e^tot adj^T + C^T ge;
//   tiles of 8 columns p, dealt round the warps: W = B adj^T (adj's bf16 copy
//     in shared memory, written once a chunk), K1 = SW^T g, K = K1 + carry W, dx.
// r, chi, <h_in, adj> and x . K are per-warp partial sums, added across warps
// in warp order; the suffix sum of r and the cumulative sum of dt A are warp
// scans. dB and dC rows go to the block of the cluster that sums them (a
// block sums Q / tile rows, its heads in rank order) by stores into its
// shared memory. Two block barriers a chunk (the chunk's derived tiles and
// first products; the partial sums and the next chunk's tiles) and two
// cluster barrier phases, each placed a part of a chunk after its arrival:
// the pushed rows landed, and summed.
//
// Bound by bytes: the saved states (32 KB a chunk and head, 3.96 GB at the
// training shape) dominate, and the walk over chunks is serial, so the chains
// of a card-full of blocks (two a multiprocessor at (64, 128)) overlap the
// next chunk's state copy with this chunk's products. What holds it back on
// the H100 (tools/ablation.py k5): the chains' latency at two blocks a
// multiprocessor, and the shared-memory and L1 traffic of the operand loads,
// the state copy and the pushed rows.
namespace bwd16 {

// Measurement only: tools/ablation.py k5 builds this file with bits of
// OMT_K5_SKIP set to take work out of the bf16 kernel (1: the state copies,
// 2: the pushes of dB / dC rows to the cluster, 4: the W products, 8: the sums
// of the pushed rows); its results are then wrong. The library has 0.
#ifndef OMT_K5_SKIP
#define OMT_K5_SKIP 0
#endif

using namespace tc;
constexpr int kQ = kBwdChunk;   // 16: one m16 / k16 tile
constexpr int kWS = kQ + 8;     // bf16 row stride of the (Q, Q) tiles: 48 B

__device__ __forceinline__ float red4(float v) {  // sum over the 8 lanes of one lane & 3
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

struct Args {
  const bf16 *x, *Bm, *Cm, *gy;
  const float *dt, *A, *D, *hin, *gstate;
  bf16* dx;
  float *ddt, *dB_part, *dC_part, *dA_part, *dD_part;
  long x_rs, b_rs, c_rs, g_rs;
  int L, H, P, G, N, tile;
  int R, r_shift;  // rows of a chunk that one block of a cluster sums, Q / tile = 2^r_shift
};

// The chunk's decay, in every warp: lane l holds dt, s (the inclusive
// cumulative sum of dt A), e^s and e^{tot - s} of row l & 15.
struct Decay {
  float dt, s, es, carry, etot;
};
__device__ __forceinline__ Decay decay(const float* dt, float Ah) {
  const int t = threadIdx.x & 15;
  Decay d;
  d.dt = dt[t];
  float s = d.dt * Ah;
#pragma unroll
  for (int off = 1; off < kQ; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, s, off, kQ);
    if (t >= off) s += o;
  }
  const float tot = __shfl_sync(0xffffffffu, s, kQ - 1);
  d.s = s;
  d.es = expf(s);
  d.carry = expf(tot - s);
  d.etot = expf(tot);
  return d;
}

// (acc * w) rounded to bf16 into columns [8 jt, 8 jt + 8) of a (Q, Q) tile,
// w_tj = e^{s_t - s_j} for t >= j, else 0
__device__ __forceinline__ void store_weighted(bf16* dst, const float (&acc)[4], int jt,
                                               const Decay& d) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, cq = lane & 3;
  const int j = 8 * jt + 2 * cq;
  const float s0 = __shfl_sync(0xffffffffu, d.s, j);
  const float s1 = __shfl_sync(0xffffffffu, d.s, j + 1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = r + 8 * half;
    const float st = __shfl_sync(0xffffffffu, d.s, t);
    const float w0 = t >= j ? expf(st - s0) : 0.0f;
    const float w1 = t >= j + 1 ? expf(st - s1) : 0.0f;
    *reinterpret_cast<uint32_t*>(dst + t * kWS + j) =
        pack(acc[2 * half] * w0, acc[2 * half + 1] * w1);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of `local`'s place in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// bf16(v * f) of the two values of a row at `p` as one B-operand register
__device__ __forceinline__ uint32_t scaled_pair(const bf16* row, int p, float f) {
  const float2 v = ld2(row + p);
  return pack(v.x * f, v.y * f);
}

// The kernel for P <= kPM and N <= kNM.
template <int PM, int NM>
struct Tiles {
  static constexpr int kPM = PM;     // largest P (head dim); smaller P is zero-padded
  static constexpr int kNM = NM;     // largest N (state dim); 16 rows n a warp
  static constexpr int kWarps = kNM / 16;
  static constexpr int kT = 32 * kWarps;
  static constexpr int kPT = kPM / 8;  // m16n8 tiles of adj^T a warp holds
  static constexpr int kMinBlocks = kPM * kNM <= 64 * 128 ? 2 : 1;  // per multiprocessor
  static constexpr int kXS = kPM + 8;  // bf16 row stride of the (Q, P) tiles: 144 B at kPM 64
  static constexpr int kBS = kNM + 8;  // bf16 row stride of the (Q, N) tiles: 272 B at kNM 128
  static constexpr int kAS = kPM + 8;  // bf16 row stride of adj^T (N, P)
  static constexpr int kHS = kNM + 4;  // fp32 row stride of the saved state h_in (P, N)
  static constexpr int kDS = kNM + 4;  // fp32 row stride of the pushed dB / dC rows
  static_assert(kPM % 16 == 0 && kNM % 32 == 0 && kWarps >= 8,
                "k16 steps over p, k32 steps over n, S and Gxd on four warps and the sums on more");
  static_assert(kQ * kPM / 2 % kT == 0, "derive: whole steps of the block");

  struct Raw {  // one chunk's inputs as they arrive (zero beyond L, P, N)
    bf16 x[kQ * kXS], g[kQ * kXS], B[kQ * kBS], C[kQ * kBS];
    float dt[kQ];
  };
  struct Smem {
    Raw raw[2];
    bf16 ge[2][kQ * kXS], xc[2][kQ * kXS];  // g e^s, x dt e^{tot-s}
    bf16 sw[kQ * kWS], gw[kQ * kWS];        // (S * w), (Gxd * w), (t, j)
    bf16 adj[kNM * kAS];                    // bf16 adj^T (n, p)
    float hs[kPM * kHS];                    // the state entering the chunk
    // [dB, dC](rows, n): the rows [rank R, rank R + R) of a chunk that this block sums,
    // R = Q / tile, as the cluster's blocks push them (the block of rank q: rows q R ...)
    float rb[2][kQ * kDS];
    float rpart[kWarps][kQ], kpart[kWarps][kQ], chi[kWarps], vpart[2][kWarps];
  };
  static_assert(sizeof(Raw) % 16 == 0 && offsetof(Smem, hs) % 16 == 0 &&
                    offsetof(Smem, rb) % 16 == 0,
                "16-byte aligned tiles");

  // chunk c's x, g, B, C and dt into `r` by cp.async (rows beyond L as zeros)
  template <bool kFull>
  static __device__ __forceinline__ void load_chunk(Raw& r, const Args& a, int b, int h, int grp,
                                                    int c) {
    const int tid = threadIdx.x;
    const int t0 = c * kQ;
    const int Qc = min(kQ, a.L - t0);
    const int P = kFull ? kPM : a.P, N = kFull ? kNM : a.N;
    const int P4 = P / 4, N4 = N / 4;
#pragma unroll 1
    for (int i = tid; i < 2 * kQ * P4; i += kT) {
      const int which = i >= kQ * P4;
      const int j = i - which * kQ * P4;
      const int t = j / P4;
      const int q = j - t * P4;
      const bool ok = t < Qc;
      const size_t row = static_cast<size_t>(b) * a.L + t0 + (ok ? t : 0);
      const bf16* src = which ? a.gy + row * a.g_rs : a.x + row * a.x_rs;
      cp8((which ? r.g : r.x) + t * kXS + 4 * q, src + static_cast<size_t>(h) * P + 4 * q, ok);
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

  // ge = g e^s and xc = x (dt e^{tot - s}), each rounded to bf16; returns this
  // thread's share of sum g . x
  static __device__ __forceinline__ float derive(const Raw& r, const Decay& d, bf16* ge, bf16* xc) {
    float gx = 0.0f;
#pragma unroll
    for (int k = 0; k < kQ * kPM / 2 / kT; ++k) {
      const int i = threadIdx.x + k * kT;
      const int t = i / (kPM / 2);  // the same t across a warp
      const int p = 2 * (i - t * (kPM / 2));
      const float dt = __shfl_sync(0xffffffffu, d.dt, t);
      const float es = __shfl_sync(0xffffffffu, d.es, t);
      const float dc = dt * __shfl_sync(0xffffffffu, d.carry, t);
      const float2 xv = ld2(r.x + t * kXS + p);
      const float2 gv = ld2(r.g + t * kXS + p);
      *reinterpret_cast<uint32_t*>(ge + t * kXS + p) = pack(gv.x * es, gv.y * es);
      *reinterpret_cast<uint32_t*>(xc + t * kXS + p) = pack(xv.x * dc, xv.y * dc);
      gx += gv.x * xv.x + gv.y * xv.y;
    }
    return gx;
  }

  // This block's dB or dC of chunk c (`acc`, (n, t) accumulator tiles) pushed to
  // the blocks that sum its rows: row t to block t / R, among its rows of rank `rank`.
  static __device__ __forceinline__ void push_rows(Smem& sm, const float (&acc)[2][4], int which,
                                                   int rank, const Args& a, int n0) {
    const int lane = threadIdx.x & 31;
    const int r = lane >> 2, cq = lane & 3;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt) {
      const int t = 8 * tt + 2 * cq;  // t and t + 1 lie in the rows of one block (R is even)
      const int owner = t >> a.r_shift;
      const uint32_t base = cluster_addr(sm.rb[which], owner) +
                            4u * ((rank * a.R + t - owner * a.R) * kDS + n0 + r);
#pragma unroll
      for (int e = 0; e < 4; ++e) st_cluster(base + 4u * ((e & 1) * kDS + 8 * (e >> 1)), acc[tt][e]);
    }
  }

  // Chunk c's dB / dC rows [rank R, rank R + R), as the cluster pushed them, summed
  // over its heads in rank order into the head tile's partial, by the `threads`
  // threads from `first` on.
  template <bool kFull>
  static __device__ __forceinline__ void sum_rows(const Smem& sm, const Args& a, int b, int tl,
                                                  int rank, int c, int first, int threads) {
    const int i0 = static_cast<int>(threadIdx.x) - first;
    if (i0 < 0) return;
    const int t0 = c * kQ;
    const int Qc = min(kQ, a.L - t0);
    const int R = a.R;
    const int N = kFull ? kNM : a.N, N4 = N / 4;
    const size_t tiles = a.H >> (4 - a.r_shift);  // H / tile
    for (int i = i0; i < 2 * R * N4; i += threads) {
      const int which = i >= R * N4;
      const int j = i - which * R * N4;
      const int row = j / N4;
      const int n = 4 * (j - row * N4);
      const int t = rank * R + row;
      if (t >= Qc) continue;
      const float* src = sm.rb[which] + row * kDS + n;
      float4 sum = load4(src);
      for (int q = 1; q < a.tile; ++q) {
        const float4 o = load4(src + q * R * kDS);
        sum.x += o.x; sum.y += o.y; sum.z += o.z; sum.w += o.w;
      }
      float* dst = which ? a.dC_part : a.dB_part;
      store4(dst + ((static_cast<size_t>(b) * a.L + t0 + t) * tiles + tl) * N + n, sum);
    }
  }

  // The first products of chunk c, made at the end of chunk c + 1 from its raw
  // tiles, its decay `d`, its state in sm.hs and its adjoint `av`:
  // dC2^T = h_in^T ge^T (k = p) into `dc`, <h_in, adj> into sm.vpart, and on warps
  // 0-3 S = C B^T (k = n) or Gxd = g xd^T (k = p), one j tile each, times w, into
  // sm.sw / sm.gw. The ge and xd operands are rounded from g and x here.
  static __device__ __forceinline__ void first_products(Smem& sm, const Raw& raw, const Decay& d,
                                                        const float (&av)[kPT][4],
                                                        float (&dc)[2][4], int c) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int r = lane >> 2, cq = lane & 3;
    const int n0 = 16 * warp;
    const float es0 = __shfl_sync(0xffffffffu, d.es, r);
    const float es1 = __shfl_sync(0xffffffffu, d.es, r + 8);
    float v = 0.0f;
#pragma unroll
    for (int tt = 0; tt < 2; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dc[tt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kPM / 16; ++ks) {
      float hv[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hv[q][e] = sm.hs[(16 * ks + 8 * q + 2 * cq + (e & 1)) * kHS + n0 + r + 8 * (e >> 1)];
      const uint32_t ah[4] = {pack(hv[0][0], hv[0][1]), pack(hv[0][2], hv[0][3]),
                              pack(hv[1][0], hv[1][1]), pack(hv[1][2], hv[1][3])};
      const int p = 16 * ks + 2 * cq;
      mma(dc[0], ah, scaled_pair(raw.g + r * kXS, p, es0), scaled_pair(raw.g + r * kXS, p + 8, es0));
      mma(dc[1], ah, scaled_pair(raw.g + (r + 8) * kXS, p, es1),
          scaled_pair(raw.g + (r + 8) * kXS, p + 8, es1));
#pragma unroll
      for (int e = 0; e < 4; ++e) v += hv[0][e] * av[2 * ks][e] + hv[1][e] * av[2 * ks + 1][e];
    }
    v = warp_sum(v);
    if (lane == 0) sm.vpart[c & 1][warp] = v;
    if (warp < 4) {
      const int jt = warp & 1;
      float acc[4] = {};
      if (warp < 2) {  // S = C B^T
        const bf16* bm = raw.B + 8 * jt * kBS;
        for (int ks = 0; ks < kNM / 16; ks += 2) {
          uint32_t aa[4], bb[4];
          ldsm4(bb, bm + (lane & 7) * kBS + 16 * ks + (lane >> 3) * 8);
          ldsm4(aa, quads_down(raw.C + 16 * ks, kBS, lane));
          mma(acc, aa, bb[0], bb[1]);
          ldsm4(aa, quads_down(raw.C + 16 * ks + 16, kBS, lane));
          mma(acc, aa, bb[2], bb[3]);
        }
      } else {  // Gxd = g xd^T
        const int j = 8 * jt + r;
        const float dtj = __shfl_sync(0xffffffffu, d.dt, j);
        const bf16* xrow = raw.x + j * kXS;
#pragma unroll
        for (int ks = 0; ks < kPM / 16; ++ks) {
          uint32_t aa[4];
          ldsm4(aa, quads_down(raw.g + 16 * ks, kXS, lane));
          const int p = 16 * ks + 2 * cq;
          mma(acc, aa, scaled_pair(xrow, p, dtj), scaled_pair(xrow, p + 8, dtj));
        }
      }
      store_weighted(warp < 2 ? sm.sw : sm.gw, acc, jt, d);
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
    const int r = lane >> 2, cq = lane & 3;
    const int n0 = 16 * warp;  // this warp's rows n of adj^T
    const int b = blockIdx.x / a.H;
    const int h = blockIdx.x - b * a.H;
    const int grp = h / (a.H / a.G);
    const int tl = h / a.tile;
    const int rank = h - tl * a.tile;  // the block's rank in its cluster
    const int n_chunks = (a.L + kQ - 1) / kQ;
    const int P = kFull ? kPM : a.P, N = kFull ? kNM : a.N;
    const float Ah = a.A[h];
    const float Dv = a.D != nullptr ? a.D[h] : 0.0f;
    const size_t state = static_cast<size_t>(P) * N;

    // zero padding: what the copies never write stays zero. A cluster barrier,
    // not a block one: the other blocks push rows into sm.rb, which must not
    // happen before this block has zeroed it (nor before it has started at all)
    for (int i = tid; i < static_cast<int>(sizeof(Smem) / 16); i += kT)
      smem4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    cluster_arrive();
    cluster_wait();

    // this thread's places (n, p) in adj^T: tile pt, element e
    auto np_ok = [&](int pt, int e, int& n, int& p) {
      n = n0 + r + 8 * (e >> 1);
      p = 8 * pt + 2 * cq + (e & 1);
      return kFull || (n < N && p < P);
    };
    float av[kPT][4];  // fp32 adj^T
    // columns [n0, n0 + 16) of h_in of chunk c into sm.hs by cp.async, one group: the
    // places this warp reads, so that a warp needs no block barrier to reuse them
    auto load_state = [&](int c) {
      const float* hc = a.hin + ((static_cast<size_t>(b) * n_chunks + c) * a.H + h) * state;
#pragma unroll 2
      for (int i = lane; i < 4 * P && !(OMT_K5_SKIP & 1); i += 32) {
        const int p = i >> 2;
        const int n = n0 + 4 * (i & 3);
        if (n < N) cp16(sm.hs + p * kHS + n, hc + static_cast<size_t>(p) * N + n);
      }
      cp_commit();
    };
    auto store_adj = [&]() {  // the bf16 copy of adj^T, the B operand of W
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt) {
        bf16* q = sm.adj + (n0 + r) * kAS + 8 * pt + 2 * cq;
        *reinterpret_cast<uint32_t*>(q) = pack(av[pt][0], av[pt][1]);
        *reinterpret_cast<uint32_t*>(q + 8 * kAS) = pack(av[pt][2], av[pt][3]);
      }
    };

    // ---- the last chunk: its tiles, decay and derived tiles; the final state's cotangent ----
    int c = n_chunks - 1;
    load_chunk<kFull>(sm.raw[c & 1], a, b, h, grp, c);
    load_state(c);
    cp_wait<0>();
    __syncthreads();
    Decay dk = decay(sm.raw[c & 1].dt, Ah);
    float gx_acc = derive(sm.raw[c & 1], dk, sm.ge[c & 1], sm.xc[c & 1]);
    {
      const size_t gs = (static_cast<size_t>(b) * a.H + h) * state;
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int n, p;
          const bool ok = np_ok(pt, e, n, p) && a.gstate != nullptr;
          av[pt][e] = ok ? a.gstate[gs + static_cast<size_t>(p) * N + n] : 0.0f;
        }
    }
    store_adj();
    float dc[2][4];  // dC^T of the chunk, its h_in part made at the end of the chunk before
    first_products(sm, sm.raw[c & 1], dk, av, dc, c);
    if (c > 0) {  // the next chunk's state lands while this chunk computes
      __syncwarp();
      load_state(c - 1);
    }
    float dA_acc = 0.0f;  // warp 0, lanes 0-15

    for (; c >= 0; --c) {
      const int cur = c & 1;
      const Raw& raw = sm.raw[cur];
      const bf16* ge = sm.ge[cur];
      const int t0 = c * kQ;
      const int Qc = min(kQ, a.L - t0);
      __syncthreads();  // (1) this chunk's derived tiles, SW, Gxdw, bf16 adj^T are in place
      if (c > 0) {  // the next chunk's tiles land while this chunk computes
        load_chunk<kFull>(sm.raw[cur ^ 1], a, b, h, grp, c - 1);
        cp_commit();
      }

      // ---- dC^T += B^T Gxdw^T (k = j); r_t's share C_t . dC_t ----
      uint32_t bT[4], cT[4];  // B^T and C^T (n, t) as A operands: also B, C at this thread's places
      ldsm4t(bT, quads_across(raw.B + n0, kBS, lane));
      ldsm4t(cT, quads_across(raw.C + n0, kBS, lane));
      {
        uint32_t bw[4];
        ldsm4(bw, quads_across(sm.gw, kWS, lane));
        mma(dc[0], bT, bw[0], bw[1]);
        mma(dc[1], bT, bw[2], bw[3]);
      }
      // element e of tile tt sits at n = n0 + r + 8 (e >> 1), t = 8 tt + 2 cq + (e & 1);
      // register 2 tt + (e >> 1) of an (n, t) A operand holds the same place
      float rl[2][2];
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        rl[tt][0] = lo16(cT[2 * tt]) * dc[tt][0] + lo16(cT[2 * tt + 1]) * dc[tt][2];
        rl[tt][1] = hi16(cT[2 * tt]) * dc[tt][1] + hi16(cT[2 * tt + 1]) * dc[tt][3];
      }
      if (c + 1 < n_chunks) cluster_wait();  // the cluster has summed its rows of chunk c + 1
      if (!(OMT_K5_SKIP & 2)) push_rows(sm, dc, 1, rank, a, n0);

      // ---- dB2^T = adj^T xc^T (k = p); chi = sum B . dB2; dB^T += C^T Gxdw (k = t) ----
      float db[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kPM / 16; ++ks) {
        const uint32_t aa[4] = {pack(av[2 * ks][0], av[2 * ks][1]),
                                pack(av[2 * ks][2], av[2 * ks][3]),
                                pack(av[2 * ks + 1][0], av[2 * ks + 1][1]),
                                pack(av[2 * ks + 1][2], av[2 * ks + 1][3])};
        uint32_t bx[4];
        ldsm4(bx, quads_across(sm.xc[cur] + 16 * ks, kXS, lane));
        mma(db[0], aa, bx[0], bx[1]);
        mma(db[1], aa, bx[2], bx[3]);
      }
      float chi = 0.0f;
#pragma unroll
      for (int jt = 0; jt < 2; ++jt)
        chi += lo16(bT[2 * jt]) * db[jt][0] + hi16(bT[2 * jt]) * db[jt][1] +
               lo16(bT[2 * jt + 1]) * db[jt][2] + hi16(bT[2 * jt + 1]) * db[jt][3];
      {
        uint32_t bw[4];
        ldsm4t(bw, quads_down(sm.gw, kWS, lane));
        mma(db[0], cT, bw[0], bw[1]);
        mma(db[1], cT, bw[2], bw[3]);
      }
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        rl[tt][0] -= lo16(bT[2 * tt]) * db[tt][0] + lo16(bT[2 * tt + 1]) * db[tt][2];
        rl[tt][1] -= hi16(bT[2 * tt]) * db[tt][1] + hi16(bT[2 * tt + 1]) * db[tt][3];
      }
      if (!(OMT_K5_SKIP & 2)) push_rows(sm, db, 0, rank, a, n0);
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float s = red4(rl[tt][k]);
          if (r == 0) sm.rpart[warp][8 * tt + 2 * cq + k] = s;
        }
      chi = warp_sum(chi);
      if (lane == 0) sm.chi[warp] = chi;
      cluster_arrive();  // this block's dB / dC rows of chunk c are pushed

      // ---- tiles pt of 8 columns p, dealt round the warps: W = B adj^T (k = n),
      // K1 = SW^T g (k = t), K, dx, x . K ----
      float kx[2] = {};
#pragma unroll
      for (int i = 0; i < (kPT + kWarps - 1) / kWarps; ++i) {
        const int pt = warp + i * kWarps;
        if (kPT % kWarps != 0 && pt >= kPT) break;
        const int p0 = 8 * pt;
        float w[4] = {}, k1[4] = {};
#pragma unroll
        for (int ks = 0; ks < kNM / 16 && !(OMT_K5_SKIP & 4); ks += 2) {
          uint32_t ba[4], aa[4];
          ldsm4t(ba, sm.adj + (16 * ks + lane) * kAS + p0);
          ldsm4(aa, quads_down(raw.B + 16 * ks, kBS, lane));
          mma(w, aa, ba[0], ba[1]);
          ldsm4(aa, quads_down(raw.B + 16 * ks + 16, kBS, lane));
          mma(w, aa, ba[2], ba[3]);
        }
        {
          uint32_t as[4], g0, g1;
          ldsm4t(as, quads_across(sm.sw, kWS, lane));
          ldsm2t(g0, g1, raw.g + (lane & 15) * kXS + p0);
          mma(k1, as, g0, g1);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = r + 8 * half;
          const int p = p0 + 2 * cq;
          const float carry = __shfl_sync(0xffffffffu, dk.carry, j);
          const float dtj = __shfl_sync(0xffffffffu, dk.dt, j);
          const float K0 = k1[2 * half] + carry * w[2 * half];
          const float K1 = k1[2 * half + 1] + carry * w[2 * half + 1];
          const float2 xv = ld2(raw.x + j * kXS + p);
          const float2 gv = ld2(raw.g + j * kXS + p);
          kx[half] += xv.x * K0 + xv.y * K1;
          if (j < Qc && p < P) {
            const size_t off = ((static_cast<size_t>(b) * a.L + t0 + j) * a.H + h) * P + p;
            *reinterpret_cast<uint32_t*>(a.dx + off) =
                pack(dtj * K0 + Dv * gv.x, dtj * K1 + Dv * gv.y);
          }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float s = kx[half];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (cq == 0) sm.kpart[warp][r + 8 * half] = s;
      }
      cp_wait<0>();     // the next chunk's tiles and state
      __syncthreads();  // (2) every partial sum and the next chunk's tiles and state are in place

      // ---- warps 4 on: this chunk's dB / dC rows summed over the cluster ----
      cluster_wait();  // every block of the cluster pushed its rows of chunk c
      if (warp >= 4 && !(OMT_K5_SKIP & 8))
        sum_rows<kFull>(sm, a, b, tl, rank, c, 4 * 32, kT - 4 * 32);
      cluster_arrive();  // this block has summed them

      // ---- da_t = sum_{u >= t} r_u + chi + e^tot <h_in, adj>; ddt; dA ----
      if (warp == 0) {
        const int t = lane & 15;
        float rt = 0.0f, kt = 0.0f, bias = 0.0f, vv = 0.0f;
#pragma unroll
        for (int q = 0; q < kWarps; ++q) {
          rt += sm.rpart[q][t];
          kt += sm.kpart[q][t];
          bias += sm.chi[q];
          vv += sm.vpart[cur][q];
        }
        bias += dk.etot * vv;
#pragma unroll
        for (int off = 1; off < kQ; off <<= 1) {  // suffix sum over t
          const float o = __shfl_down_sync(0xffffffffu, rt, off, kQ);
          if (t + off < kQ) rt += o;
        }
        const float da = rt + bias;
        if (lane < kQ) {
          if (t < Qc) a.ddt[(static_cast<size_t>(b) * a.L + t0 + t) * a.H + h] = Ah * da + kt;
          dA_acc += dk.dt * da;
        }
      }

      // ---- adj^T <- e^tot adj^T + C^T ge (k = t), and its bf16 copy ----
#pragma unroll
      for (int pt = 0; pt < kPT; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) av[pt][e] *= dk.etot;
#pragma unroll
      for (int pp = 0; pp < kPM / 16; ++pp) {
        uint32_t bg[4];
        ldsm4t(bg, quads_down(ge + 16 * pp, kXS, lane));
        mma(av[2 * pp], cT, bg[0], bg[1]);
        mma(av[2 * pp + 1], cT, bg[2], bg[3]);
      }
      store_adj();

      // ---- the next chunk's decay, derived tiles and first products ----
      if (c > 0) {
        dk = decay(sm.raw[cur ^ 1].dt, Ah);
        gx_acc += derive(sm.raw[cur ^ 1], dk, sm.ge[cur ^ 1], sm.xc[cur ^ 1]);
        first_products(sm, sm.raw[cur ^ 1], dk, av, dc, c - 1);
        if (c > 1) {  // the state of the chunk after lands while that one computes
          __syncwarp();
          load_state(c - 2);
        }
      }
    }
    cluster_wait();  // nothing reaches this block's shared memory after this

    __shared__ float scratch[32];
    const float dA = warp_sum(warp == 0 ? dA_acc : 0.0f);
    const float dD = block_sum(gx_acc, scratch);
    if (tid == 0) {
      a.dA_part[static_cast<size_t>(b) * a.H + h] = dA;
      a.dD_part[static_cast<size_t>(b) * a.H + h] = dD;
    }
  }
};
template <int PM, int NM, bool kFull>
__global__ void __launch_bounds__(Tiles<PM, NM>::kT, Tiles<PM, NM>::kMinBlocks)
    ssd_scan_bwd_bf16_kernel(const Args a) {
  Tiles<PM, NM>::template walk<kFull>(a);
}

}  // namespace bwd16

// The bf16 path: one cluster of `tile` blocks per head tile, one block per
// (batch, head), then the same two summing kernels as the fp32 path.
template <class S>
cudaError_t launch_tiles(const bwd16::Args& args, int B, int P, int N,
                                     float* dA, void* dB, void* dC, float* dD, cudaStream_t stream) {
  using bwd16::bf16;
  const size_t smem = sizeof(typename S::Smem);
  const bool full = P == S::kPM && N == S::kNM;
  auto kernel = full ? bwd16::ssd_scan_bwd_bf16_kernel<S::kPM, S::kNM, true>
                     : bwd16::ssd_scan_bwd_bf16_kernel<S::kPM, S::kNM, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int H = args.H, G = args.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B) * H);
  cfg.blockDim = dim3(S::kT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned int>(args.tile);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, args)) != cudaSuccess)
    return err;

  const int tiles = H / args.tile;
  const long total = static_cast<long>(B) * args.L * G * (N / 4);
  const unsigned int blocks = static_cast<unsigned int>((total + kBwdThreads - 1) / kBwdThreads);
  ssd_bwd_reduce_bc_kernel<bf16><<<dim3(blocks), kBwdThreads, 0, stream>>>(
      args.dB_part, args.dC_part, static_cast<bf16*>(dB), static_cast<bf16*>(dC), total, tiles,
      G, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce_ad_kernel<<<dim3((H + kBwdThreads - 1) / kBwdThreads), kBwdThreads, 0, stream>>>(
      args.dA_part, args.dD_part, dA, dD, B, H);
  return cudaGetLastError();
}

cudaError_t launch_ssd_scan_bwd_bf16(const void* x, const float* dt, const float* A,
                                     const void* Bm, const void* Cm, const float* D,
                                     const float* hin, const void* gy, const float* gstate,
                                     void* dx, float* ddt, float* dA, void* dB, void* dC, float* dD,
                                     float* dBC_part, float* dAD_part, long x_rs, long b_rs,
                                     long c_rs, long g_rs, int B, int L, int H, int P, int G,
                                     int N, int tile, cudaStream_t stream) {
  using bwd16::bf16;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(Bm) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(Cm) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(gy) % 8 == 0 && x_rs % 4 == 0 &&
                       b_rs % 4 == 0 && c_rs % 4 == 0 && g_rs % 4 == 0;
  if (tile > 8 || bwd16::kQ % tile != 0 || !aligned) return cudaErrorInvalidValue;
  const size_t part = static_cast<size_t>(B) * L * (H / tile) * N;
  bwd16::Args args;
  args.x = static_cast<const bf16*>(x);
  args.Bm = static_cast<const bf16*>(Bm);
  args.Cm = static_cast<const bf16*>(Cm);
  args.gy = static_cast<const bf16*>(gy);
  args.dt = dt; args.A = A; args.D = D; args.hin = hin; args.gstate = gstate;
  args.dx = static_cast<bf16*>(dx);
  args.ddt = ddt;
  args.dB_part = dBC_part;
  args.dC_part = dBC_part + part;
  args.dA_part = dAD_part;
  args.dD_part = dAD_part + static_cast<size_t>(B) * H;
  args.x_rs = x_rs; args.b_rs = b_rs; args.c_rs = c_rs; args.g_rs = g_rs;
  args.L = L; args.H = H; args.P = P; args.G = G; args.N = N; args.tile = tile;
  args.R = bwd16::kQ / tile;
  args.r_shift = __builtin_ctz(static_cast<unsigned>(args.R));
  cudaError_t err = cudaErrorInvalidValue;
  tc::with_tiles<bwd16::Tiles>(P, N, [&](auto tiles) {
    err = launch_tiles<decltype(tiles)>(args, B, P, N, dA, dB, dC, dD, stream);
  });
  return err;
}

}  // namespace omt

// Bytes of dynamic shared memory a block of the bf16 backward takes at head
// dim P and state dim N; 0 if the bf16 backward does not take them.
extern "C" long omt_ssd_scan_bwd_bf16_smem_bytes(int P, int N) {
  long bytes = 0;
  omt::tc::with_tiles<omt::bwd16::Tiles>(P, N, [&](auto tiles) {
    bytes = static_cast<long>(sizeof(typename decltype(tiles)::Smem));
  });
  return bytes;
}


// Backward of omt_ssd_scan. x_dtype is the type of x, Bm, Cm, gy, dx, dB and
// dC; dt, A, D, hin, gstate, ddt, dA and dD are fp32. x_rs, b_rs, c_rs and g_rs
// are the elements between consecutive (batch, token) rows of x, Bm, Cm and gy;
// everything else is contiguous. hin is the forward's chunk_states. D may be
// null (then dD receives zeros) and gstate may be null (no cotangent of the
// final state: nothing is read). `tile` heads share a block: it must divide
// the heads of a group, H / G. dBC_part is scratch of 2 * B * L * (H / tile) * N
// floats, dAD_part of 2 * B * H floats. N must be a multiple of 4 and the fp32
// buffers 16-byte aligned. bf16 inputs whose (P, N) the tensor-core kernel takes
// (omt_ssd_scan_bwd_bf16_smem_bytes is not 0) further need tile <= 8, and x, Bm,
// Cm, gy 8-byte aligned with row strides that are multiples of 4; other bf16
// shapes take the multiply-add kernel, rounding as the tensor-core one does.
// Returns the cudaError_t of the launches (0 = success).
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
  if (x_dtype == kBF16 && omt_ssd_scan_bwd_bf16_smem_bytes(P, N) == 0)
    return launch_ssd_scan_bwd<__nv_bfloat16>(x, dt, A, Bm, Cm, D, hin, gy, gstate, dx, ddt, dA, dB, dC, dD, dBC_part, dAD_part, x_rs, b_rs, c_rs, g_rs, B, L, H, P, G, N, tile, s);
  if (x_dtype == kBF16)
    return launch_ssd_scan_bwd_bf16(x, dt, A, Bm, Cm, D, hin, gy, gstate, dx, ddt, dA, dB, dC, dD, dBC_part, dAD_part, x_rs, b_rs, c_rs, g_rs, B, L, H, P, G, N, tile, s);
  if (x_dtype == kF32)
    return launch_ssd_scan_bwd<float>(x, dt, A, Bm, Cm, D, hin, gy, gstate, dx, ddt, dA, dB, dC, dD, dBC_part, dAD_part, x_rs, b_rs, c_rs, g_rs, B, L, H, P, G, N, tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
