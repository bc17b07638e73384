// Backward of the Mamba2 SSD chunked scan for Hopper (sm_90a), f32: from
// dy (and the final state's gradient) the gradients dx, ddt, dA, dB and
// dC of y, final_state = ssd(x, dt, A, B, C) (ssd.cu, K7's counterpart).
//
// Replaces no TPU kernel.  The JAX package never differentiates its Pallas
// kernel (kernels/ssd/kernel.py::_ssd_kernel, K7): it trains through the
// pure-JAX models/ssm.py::ssd_chunked, whose gradient XLA derives.  The
// port runs that function on the card as K7, so training on the card needs
// this backward, behind the autograd Function ops.SsdFn.
//
// Per chunk of Q steps and head h, with a = dt * A_h, cum = cumsum(a) in
// the chunk, cl = cum_last, L_ij = exp(cum_i - cum_j) (i >= j), w_j =
// exp(cl - cum_j), S_in the state the chunk starts from and G the
// gradient of the state it ends with:
//   G(chunk c)  = exp(cl_{c+1}) G(c+1) + sum_i exp(cum_i) C_i dy_i^T,
//                 G after the last chunk = d final_state     (reverse pass)
//   u_j   = sum_{i>=j} (C_i . B_j) L_ij dy_i + w_j G^T B_j    (P)
//   dx_j  = dt_j u_j,            ddt_j = x_j . u_j + A_h da_j
//   dB_j  = sum_{i>=j} L_ij dt_j (dy_i . x_j) C_i + w_j dt_j G x_j
//   dC_i  = sum_{j<=i} L_ij dt_j (dy_i . x_j) B_j + exp(cum_i) S_in dy_i
//   dcum  from every exp(.) above, da = the reverse cumsum of dcum in the
//   chunk, dA_h = sum over (b, steps) of da dt.
// B and C are shared across heads and A is per head, so dB, dC and dA are
// sums over heads (and steps): each block writes its head's share, and a
// last kernel adds the shares in a fixed order.  No atomics anywhere, so
// two runs give the same bits.
//
// Design, five kernels behind the one entry point ssd_bwd_launch (counted
// as one ssd_bwd launch), on the caller's stream:
// 1. ssd_bwd_adj_kernel, one block per (chunk, h, b): U_c = sum_i
//    exp(cum_i) C_i dy_i^T (N x P) into the scratch gbuf.
// 2. ssd_bwd_pass_kernel, one thread per 4 state elements of one (b, h):
//    the reverse recurrence over the chunks; it overwrites each U_c with
//    G, the gradient of the state the chunk ends with.
// 3. ssd_bwd_chunk_kernel, one block per (chunk, h, b): C B^T and dy x^T
//    (Q x Q) in registers, a thread an 8 x 8 block; L-weighted into M =
//    C B^T * L and R = L dt (dy x^T) in shared memory; then u, dx, ddt,
//    dB, dC and dcum, and the reverse cumsum into da.
// 4. ssd_bwd_reduce_kernel twice: dB and dC, the heads' shares added in
//    order h = 0, 1, ...; and ssd_bwd_reduce_a_kernel: dA.
// The chunk-boundary states S_in and cum come from the forward (ssd.cu
// keeps both in its scratch: each chunk's starting state, and cum as f32
// (hi, lo) pairs from its f64 scan), so exp(cum_i - cum_j) is taken from
// the same f64 cum as in the forward (cum_diff), and the recurrence uses
// the forward's exp(hi of cl).  Steps past S (a ragged last chunk) are
// zeros with dt = 0, as in the forward: exact no-ops.
//
// Products are f32 FMAs on the CUDA cores from tiles in shared memory.
// What bounds it: at Mamba2-2.7B's training shape (B 2, S 2049, H 80, P
// 64, N 128, Q 128) the function moves x, dt, B, C, dy in and dx, ddt, dB,
// dC out, ~0.36 GB (0.11 ms at 3.35 TB/s), and its products are ~26
// GFLOP (0.05 ms even at 495 TFLOP/s in TF32): bytes.  This design also
// writes and reads the heads' dB and dC shares (~0.34 GB) and the state
// gradients, and runs its products on the CUDA cores: several times its
// bound.  Tensor-core products are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;        // threads of every block
constexpr int QM = 128;        // longest chunk (the forward's Q_MAX)
constexpr int LDM = QM + 2;    // row stride of M and R (Q x Q)
constexpr int SW = 64;         // columns of a slab in shared memory
constexpr int LDS = SW + 1;    // its row stride: conflict-free columns
constexpr int PASS_THREADS = 256;

__device__ __forceinline__ float cum_diff(float2 a, float2 b) {
  return (a.x - b.x) + (a.y - b.y);
}

// rows [0, n) and columns [0, w) of a row-strided f32 array into a QM x
// LDS slab, zeros elsewhere (rows past the chunk's end, columns past w)
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          long long rs, int n, int w) {
  for (int e = threadIdx.x; e < QM * SW; e += BT) {
    const int r = e / SW, c = e % SW;
    dst[r * LDS + c] = (r < n && c < w) ? __ldg(src + r * rs + c) : 0.f;
  }
}

// the sum over the 16 threads of a half warp that share tr (tid >> 4)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t chunk_smem_bytes() {
  return sizeof(float) * (size_t)(2 * QM * LDM + 2 * QM * LDS + 12 * QM + BT);
}

size_t adj_smem_bytes() {
  return sizeof(float) * (size_t)(2 * QM * LDS + QM);
}

// 1. U_c = sum_i exp(cum_i) C_i dy_i^T over the chunk's rows, N x P.
// Thread (tr, tk) holds rows n0 + tr + 16a and columns tk + 16q.
__global__ void __launch_bounds__(BT) ssd_bwd_adj_kernel(
    const float* __restrict__ Cm, long long csb, long long css,
    const float* __restrict__ dy, const float2* __restrict__ cum,
    float* __restrict__ gbuf, int S, int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);
  float* sY = sC + QM * LDS;
  float* se = sY + QM * LDS;  // exp(cum_i)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const int Qp = (Q + 15) & ~15;
  const size_t bhc = ((size_t)b * H + h) * nc + c;
  const int tr = tid >> 4, tk = tid & 15;
  if (tid < QM) {
    float e = 0.f;
    if (tid < Qv) {
      const float2 ci = cum[bhc * Qp + tid];
      e = expf(ci.x + ci.y);
    }
    se[tid] = e;
  }
  load_slab(sY, dy + (((size_t)b * S + t0) * H + h) * P, (long long)H * P, Qv,
            P);
  float* out = gbuf + bhc * N * P;
  for (int n0 = 0; n0 < N; n0 += SW) {
    const int w = min(SW, N - n0);
    __syncthreads();
    load_slab(sC, Cm + b * csb + (long long)t0 * css + n0, css, Qv, w);
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
    for (int i = 0; i < Qv; ++i) {
      float cv[4], yv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = sC[i * LDS + tr + 16 * a] * se[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) yv[q] = sY[i * LDS + tk + 16 * q];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(cv[a], yv[q], acc[a][q]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = n0 + tr + 16 * a;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tk + 16 * q;
        if (n < N && p < P) out[(size_t)n * P + p] = acc[a][q];
      }
    }
  }
}

// 2. The reverse pass: G = d final_state, then for c = nc-1 .. 0 the
// chunk's G is stored over its U_c and G = exp(cl_c) G + U_c.
__global__ void __launch_bounds__(PASS_THREADS) ssd_bwd_pass_kernel(
    float* __restrict__ gbuf, const float2* __restrict__ cum,
    const float* __restrict__ dstate, int H, int NP, int nc, int Qp) {
  const int e4 = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e4 * 4 >= NP) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float4* gp = reinterpret_cast<float4*>(gbuf + bh * nc * NP) + e4;
  const float2* cl = cum + bh * nc * Qp + Qp - 1;
  const size_t step = NP / 4;
  float4 G = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dstate != nullptr)
    G = reinterpret_cast<const float4*>(dstate + bh * NP)[e4];
  for (int c = nc - 1; c >= 0; --c) {
    const float4 U = gp[c * step];
    gp[c * step] = G;  // the gradient of the state chunk c ends with
    const float d = expf(__ldg(cl + (size_t)c * Qp).x);
    G.x = G.x * d + U.x;
    G.y = G.y * d + U.y;
    G.z = G.z * d + U.z;
    G.w = G.w * d + U.w;
  }
}

// 3. One chunk of one head.  Thread (tr, tk) = (tid >> 4, tid & 15) holds
// rows tr + 16a and columns tk + 16q of each Q x Q or Q x 64 block.
__global__ void __launch_bounds__(BT, 1) ssd_bwd_chunk_kernel(
    const float* __restrict__ x, long long xsb, long long xss, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dss,
    long long dsh, const float* __restrict__ A, const float* __restrict__ Bm,
    long long bsb, long long bss, const float* __restrict__ Cm,
    long long csb, long long css, const float* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gbuf,
    const float2* __restrict__ cum, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dBpart,
    float* __restrict__ dCpart, float* __restrict__ dApart, int Bn, int S,
    int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* sM = reinterpret_cast<float*>(smem4);  // QM x LDM
  float* sR = sM + QM * LDM;                    // QM x LDM
  float* sA = sR + QM * LDM;                    // QM x LDS slab
  float* sB = sA + QM * LDS;                    // QM x LDS slab
  float* sdt = sB + QM * LDS;                   // the vectors, QM each
  float* swl = sdt + QM;     // exp(cl - cum_j)
  float* sec = swl + QM;     // exp(cum_i)
  float* srow = sec + QM;    // sum_j T_ij
  float* scol = srow + QM;   // sum_i T_ij
  float* sdd = scol + QM;    // ddt's direct term x . u
  float* sW = sdd + QM;      // the chunk-state term of dcum_j
  float* sI = sW + QM;       // the starting-state term of dcum_i
  float2* scum = reinterpret_cast<float2*>(sI + QM);  // QM pairs
  float* red = reinterpret_cast<float*>(scum + QM);   // BT
  float* sG = sM;                     // after u: G (N x LDS) ...
  float* sSin = sM + QM * LDS;        // ... and S_in (N x LDS)
  float* colpart = sA;                // 16 x QM, right after C B^T

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const int Qp = (Q + 15) & ~15;
  const size_t bhc = ((size_t)b * H + h) * nc + c;
  const int tr = tid >> 4, tk = tid & 15;
  const float2 clp = cum[bhc * Qp + Qp - 1];
  if (tid < QM) {
    const float2 ci = tid < Qv ? cum[bhc * Qp + tid] : clp;
    scum[tid] = ci;
    sdt[tid] = tid < Qv ? __ldg(dt + b * dsb + (long long)(t0 + tid) * dss +
                                h * dsh)
                        : 0.f;
    sec[tid] = tid < Qv ? expf(ci.x + ci.y) : 0.f;
    swl[tid] = tid < Qv ? expf(cum_diff(clp, ci)) : 0.f;
  }
  const float* Cb = Cm + b * csb + (long long)t0 * css;
  const float* Bb = Bm + b * bsb + (long long)t0 * bss;
  const float* xb = x + b * xsb + (long long)t0 * xss + h * xsh;
  const float* yb = dy + (((size_t)b * S + t0) * H + h) * P;
  const long long ys = (long long)H * P;

  // ---- C B^T and dy x^T (rows i, columns j), 8 x 8 a thread
  float cb[8][8], dd[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) cb[a][q] = dd[a][q] = 0.f;
  for (int n0 = 0; n0 < N; n0 += SW) {
    const int w = min(SW, N - n0);
    __syncthreads();
    load_slab(sA, Cb + n0, css, Qv, w);
    load_slab(sB, Bb + n0, bss, Qv, w);
    __syncthreads();
    for (int n = 0; n < w; ++n) {
      float ca[8], bv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) ca[a] = sA[(tr + 16 * a) * LDS + n];
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = sB[(tk + 16 * q) * LDS + n];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) cb[a][q] = fmaf(ca[a], bv[q], cb[a][q]);
    }
  }
  for (int p0 = 0; p0 < P; p0 += SW) {
    const int w = min(SW, P - p0);
    __syncthreads();
    load_slab(sA, yb + p0, ys, Qv, w);
    load_slab(sB, xb + p0, xss, Qv, w);
    __syncthreads();
    for (int p = 0; p < w; ++p) {
      float ya[8], xv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) ya[a] = sA[(tr + 16 * a) * LDS + p];
#pragma unroll
      for (int q = 0; q < 8; ++q) xv[q] = sB[(tk + 16 * q) * LDS + p];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) dd[a][q] = fmaf(ya[a], xv[q], dd[a][q]);
    }
  }
  __syncthreads();  // the slabs are free: colpart lives in sA
  // M = C B^T * L, R = L dt_j (dy x^T), T = M dt_j (dy x^T): T's row sums
  // add to dcum_i, its column sums subtract from dcum_j
  {
    float colp[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) colp[q] = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = tr + 16 * a;
      float rowp = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tk + 16 * q;
        float L = 0.f;
        if (i < Qv && j <= i) L = expf(cum_diff(scum[i], scum[j]));
        const float m = cb[a][q] * L;
        const float r = L * sdt[j] * dd[a][q];
        const float t = m * sdt[j] * dd[a][q];
        sM[i * LDM + j] = m;
        sR[i * LDM + j] = r;
        rowp += t;
        colp[q] += t;
      }
      rowp = sum16(rowp);
      if (tk == 0) srow[i] = rowp;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) colpart[tr * QM + tk + 16 * q] = colp[q];
  }
  __syncthreads();
  if (tid < QM) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += colpart[t * QM + tid];
    scol[tid] = s;
  }

  // ---- u = M^T dy (rows j, columns p < P <= 64)
  float u[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q) u[a][q] = 0.f;
  __syncthreads();
  load_slab(sA, yb, ys, Qv, P);
  __syncthreads();
  for (int i = 0; i < Qv; ++i) {
    float mv[8], yv[4];
#pragma unroll
    for (int a = 0; a < 8; ++a) mv[a] = sM[i * LDM + tr + 16 * a];
#pragma unroll
    for (int q = 0; q < 4; ++q) yv[q] = sA[i * LDS + tk + 16 * q];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) u[a][q] = fmaf(mv[a], yv[q], u[a][q]);
  }
  __syncthreads();  // M is spent: G and S_in take its place
  {
    const float* gsrc = gbuf + bhc * N * P;
    const float* ssrc = states + bhc * N * P;
    for (int e = tid; e < N * P; e += BT) {
      const int n = e / P, p = e % P;
      sG[n * LDS + p] = gsrc[e];
      sSin[n * LDS + p] = ssrc[e];
    }
  }
  // + w_j G^T B_j
  {
    float us[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) us[a][q] = 0.f;
    for (int n0 = 0; n0 < N; n0 += SW) {
      const int w = min(SW, N - n0);
      __syncthreads();
      load_slab(sB, Bb + n0, bss, Qv, w);
      __syncthreads();
      for (int n = 0; n < w; ++n) {
        float bv[8], gv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) bv[a] = sB[(tr + 16 * a) * LDS + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = sG[(n0 + n) * LDS + tk + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) us[a][q] = fmaf(bv[a], gv[q], us[a][q]);
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float wl = swl[tr + 16 * a];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[a][q] = fmaf(wl, us[a][q], u[a][q]);
    }
  }
  // dx = dt u; ddt's direct term x . u (x into sA)
  __syncthreads();
  load_slab(sA, xb, xss, Qv, P);
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = tr + 16 * a;
    float part = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = tk + 16 * q;
      part = fmaf(sA[j * LDS + p], u[a][q], part);
      if (j < Qv && p < P)
        dx[(((size_t)b * S + t0 + j) * H + h) * P + p] = sdt[j] * u[a][q];
    }
    part = sum16(part);
    if (tk == 0) sdd[j] = part;
  }

  // ---- dB_j = R^T C + w_j dt_j G x_j, and the chunk-state term of dcum_j
  //      W_j = B_j . (w_j dt_j G x_j)      (x stays in sA)
  {
    float wpart[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) wpart[a] = 0.f;
    for (int n0 = 0; n0 < N; n0 += SW) {
      const int w = min(SW, N - n0);
      __syncthreads();
      load_slab(sB, Cb + n0, css, Qv, w);
      __syncthreads();
      float acc[8][4], s2[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = s2[a][q] = 0.f;
      for (int i = 0; i < Qv; ++i) {
        float rv[8], cv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) rv[a] = sR[i * LDM + tr + 16 * a];
#pragma unroll
        for (int q = 0; q < 4; ++q) cv[q] = sB[i * LDS + tk + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(rv[a], cv[q], acc[a][q]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[8], gv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) xv[a] = sA[(tr + 16 * a) * LDS + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + tk + 16 * q;
          gv[q] = n < N ? sG[n * LDS + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s2[a][q] = fmaf(xv[a], gv[q], s2[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int j = tr + 16 * a;
        const float f = swl[j] * sdt[j];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + tk + 16 * q;
          if (j < Qv && n < N) {
            const float summ = f * s2[a][q];
            wpart[a] = fmaf(__ldg(Bb + (long long)j * bss + n), summ,
                            wpart[a]);
            dBpart[(((size_t)h * Bn + b) * S + t0 + j) * N + n] =
                acc[a][q] + summ;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float wsum = sum16(wpart[a]);
      if (tk == 0) sW[tr + 16 * a] = wsum;
    }
  }

  // ---- dC_i = R B + exp(cum_i) S_in dy_i, and the starting-state term
  //      of dcum_i: C_i . (exp(cum_i) S_in dy_i)      (dy back into sA)
  {
    __syncthreads();
    load_slab(sA, yb, ys, Qv, P);
    float ipart[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) ipart[a] = 0.f;
    for (int n0 = 0; n0 < N; n0 += SW) {
      const int w = min(SW, N - n0);
      __syncthreads();
      load_slab(sB, Bb + n0, bss, Qv, w);
      __syncthreads();
      float acc[8][4], s2[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = s2[a][q] = 0.f;
      for (int j = 0; j < Qv; ++j) {
        float rv[8], bv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) rv[a] = sR[(tr + 16 * a) * LDM + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = sB[j * LDS + tk + 16 * q];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[a][q] = fmaf(rv[a], bv[q], acc[a][q]);
      }
      for (int p = 0; p < P; ++p) {
        float yv[8], sv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) yv[a] = sA[(tr + 16 * a) * LDS + p];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + tk + 16 * q;
          sv[q] = n < N ? sSin[n * LDS + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) s2[a][q] = fmaf(yv[a], sv[q], s2[a][q]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = tr + 16 * a;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + tk + 16 * q;
          if (i < Qv && n < N) {
            const float inter = sec[i] * s2[a][q];
            ipart[a] = fmaf(__ldg(Cb + (long long)i * css + n), inter,
                            ipart[a]);
            dCpart[(((size_t)h * Bn + b) * S + t0 + i) * N + n] =
                acc[a][q] + inter;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float isum = sum16(ipart[a]);
      if (tk == 0) sI[tr + 16 * a] = isum;
    }
  }

  // ---- the recurrence's term of dcl: exp(cl) <S_in, G>, a fixed-order
  //      block sum
  {
    float part = 0.f;
    for (int e = tid; e < N * P; e += BT) {
      const int n = e / P, p = e % P;
      part = fmaf(sSin[n * LDS + p], sG[n * LDS + p], part);
    }
    red[tid] = part;
    __syncthreads();
    for (int o = BT / 2; o > 0; o >>= 1) {
      if (tid < o) red[tid] += red[tid + o];
      __syncthreads();
    }
  }
  // ---- dcum -> da (reverse cumsum over the chunk), ddt, dA's share
  if (tid == 0) {
    float dcl = red[0] * expf(clp.x);
    for (int j = 0; j < Qv; ++j) dcl += sW[j];
    const float Ah = __ldg(A + h);
    double run = dcl;  // cl = cum at the chunk's last step
    double da_dt = 0.0;
    for (int t = Qv - 1; t >= 0; --t) {
      run += (double)srow[t] - (double)scol[t] + (double)sI[t] -
             (double)sW[t];
      const float da = (float)run;
      ddt[((size_t)b * S + t0 + t) * H + h] = sdd[t] + da * Ah;
      da_dt += (double)da * (double)sdt[t];
    }
    dApart[bhc] = (float)da_dt;
  }
}

// 4. out[e] = sum over h of part[h][e], in order
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ out, int H,
    long long M) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= M) return;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += part[(size_t)h * M + e];
  out[e] = s;
}

__global__ void ssd_bwd_reduce_a_kernel(const float* __restrict__ dApart,
                                        float* __restrict__ dA, int B, int H,
                                        int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += dApart[((size_t)b * H + h) * nc + c];
  dA[h] = s;
}

}  // namespace

extern "C" {

// Inputs as ssd_scan_launch's: x (B,S,H,P), dt (B,S,H), B_/C_ (B,S,N)
// through strides in elements (innermost stride 1), A (H,); dy (B,S,H,P)
// contiguous; dstate (B,H,N,P) contiguous, or null for a zero gradient of
// the final state; states (B,H,chunks,N,P) and cum (B,H,chunks,Qp,2), the
// forward's scratch after its launch.  Outputs, contiguous: dx (B,S,H,P),
// ddt (B,S,H), dA (H), dB and dC (B,S,N).  Scratch: gbuf like states,
// dBpart and dCpart (H,B,S,N), dApart (B,H,chunks).  Q <= 128, P <= 64,
// N <= 128, both multiples of 4.  Six launches on the stream; returns
// the first cudaError_t (0 on success).
int ssd_bwd_launch(const float* x, long long xsb, long long xss,
                   long long xsh, const float* dt, long long dsb,
                   long long dss, long long dsh, const float* A,
                   const float* Bm, long long bsb, long long bss,
                   const float* Cm, long long csb, long long css,
                   const float* dy, const float* dstate, const float* states,
                   const float* cum, float* gbuf, float* dx, float* ddt,
                   float* dA, float* dB, float* dC, float* dBpart,
                   float* dCpart, float* dApart, int B, int S, int H, int P,
                   int N, int Q, void* stream) {
  if (Q < 1 || Q > QM || P < 4 || P > SW || N < 4 || N > 2 * SW || P % 4 ||
      N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, Qp = (Q + 15) & ~15, NP = N * P;
  const size_t smem_c = chunk_smem_bytes(), smem_a = adj_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_c);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_adj_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  const float2* cum2 = reinterpret_cast<const float2*>(cum);
  ssd_bwd_adj_kernel<<<dim3(nc, H, B), BT, smem_a, st>>>(
      Cm, csb, css, dy, cum2, gbuf, S, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<<<dim3((NP / 4 + PASS_THREADS - 1) / PASS_THREADS, H,
                             B),
                        PASS_THREADS, 0, st>>>(gbuf, cum2, dstate, H, NP, nc,
                                               Qp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<dim3(nc, H, B), BT, smem_c, st>>>(
      x, xsb, xss, xsh, dt, dsb, dss, dsh, A, Bm, bsb, bss, Cm, csb, css, dy,
      states, gbuf, cum2, dx, ddt, dBpart, dCpart, dApart, B, S, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long M = (long long)B * S * N;
  const int blocks = (int)((M + 255) / 256);
  ssd_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(dBpart, dB, H, M);
  ssd_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(dCpart, dC, H, M);
  ssd_bwd_reduce_a_kernel<<<(H + 127) / 128, 128, 0, st>>>(dApart, dA, B, H,
                                                           nc);
  return (int)cudaGetLastError();
}

const char* ssdb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
