// Mamba2 SSD chunked scan (train/prefill) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/ssd/kernel.py::_ssd_kernel (K7, via ssd_scan and ops.ssd_op)
// with ssd_scan_kernel, one block per (batch b, head h).  Per chunk of Q
// steps, all in f32 (as the TPU kernel and models/ssm.py::ssd_chunked):
//   cum   = cumsum(dt * A)                              (Q)
//   M     = (C B^T) * exp(cum_i - cum_j) * dt_j, i >= j (Q x Q)
//   y     = M x + exp(cum) * (C state)                  (Q x P)
//   state = exp(cum_last) * state + B^T (exp(cum_last - cum) * dt * x)
// and the (N x P) state is written out after the last chunk.
//
// Design.  The TPU kernel's grid runs the chunk axis in order on one core
// and carries the state in VMEM scratch reset at chunk 0; Hopper blocks run
// in no order, so the chunk loop lives inside the block and the state stays
// in shared memory from the first chunk to the last.  The chunk's x, B (in
// both orders), C, M and the state sit in dynamic shared memory (216,576
// bytes at Q = 128, N = P = 64; the wrapper refuses shapes over one
// block's 232,448).  Each product runs on register tiles — 8 x 8 of M,
// 8 x 4 of y, 4 x 4 of the state — fed by 16-byte shared-memory loads
// along the reduction index, so a multiply-add costs a quarter to a half
// of a load, not two.
// - exp(cum_i - cum_j) overflows for i < j (cum falls with j); JAX discards
//   it with a where, but here inf * 0 would be NaN, so only i >= j is
//   computed: M's tiles above the diagonal are never formed, and inside a
//   diagonal tile M is 0 above it.
// - B and C are shared by the heads (n_groups = 1): the block reads row b
//   of them, where ops.ssd_op broadcast them H times (2 x 235 MB at the
//   Zamba2-7B serving shape).
// - x, dt, B and C are read in the model's (B, S, H, P) / (B, S, H) /
//   (B, S, N) layouts through their strides (innermost stride 1), so the
//   caller neither transposes nor copies its split of the conv output.
// - Steps past S, and the rows that round a chunk up to 8, are loaded as
//   zeros with dt = 0: exact no-ops, as the JAX padding; their y is not
//   written.
// - Plain f32 FMAs on the CUDA cores, no TF32 and no fast-math, so the
//   kernel differs from the plain version only in summation order.
//
// What bounds it: ~2.1 M multiply-adds per chunk (the two Q x Q products
// on their lower triangle, C state and the state update), 30 GFLOP per
// launch at the Zamba2-7B serving shape (B = 4, S = 2048, H = 112,
// P = N = 64), 0.45 ms at the card's 67 TFLOP/s f32 rate, over the
// ~0.48 GB it must move (0.14 ms at 3.35 TB/s): operations.  One 212 KB
// block per SM leaves 8 warps to hide latency, and 448 blocks make 3.4
// waves on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int SSD_THREADS = 256;

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Q is the chunk length, Qp = Q rounded up to 8; rows Q..Qp-1 of a chunk
// and steps past S are zeros with dt = 0.  P and N are multiples of 4.
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_kernel(
    const float* __restrict__ x, long long xsb, long long xss, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dss, long long dsh,
    const float* __restrict__ A, const float* __restrict__ Bm, long long bsb,
    long long bss, const float* __restrict__ Cm, long long csb,
    long long css, float* __restrict__ y, float* __restrict__ state_out,
    int S, int H, int P, int N, int Q) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(smem4);
  const int Qp = (Q + 7) & ~7;
  const int ldt = Qp + 4;  // rows of the transposed B and C, 16-byte steps
  float* sx = sm;                 // Qp x P: x[j][p]
  float* sCt = sx + Qp * P;       // N x ldt: C[i][n] at [n][i]
  float* sBt = sCt + N * ldt;     // N x ldt: B[j][n] at [n][j]
  float* sB = sBt + N * ldt;      // Qp x N: B[j][n]
  float* sMt = sB + Qp * N;       // Qp x Qp: M[i][j] at [j][i]
  float* sS = sMt + Qp * Qp;      // N x P: the carried state
  float* sdt = sS + N * P;        // Qp
  float* scum = sdt + Qp;         // Qp
  float* sw = scum + Qp;          // Qp: exp(cum_last - cum_j) * dt_j

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float a = A[h];
  const int tid = threadIdx.x;
  const int nt = Qp / 8, np4 = P / 4;

  for (int i = tid; i < N * P; i += SSD_THREADS) sS[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    for (int i = tid; i < Qp * P; i += SSD_THREADS) {
      const int q = i / P, p = i % P, t = t0 + q;
      sx[i] = q < Q && t < S ? x[b * xsb + t * xss + h * xsh + p] : 0.f;
    }
    for (int i = tid; i < Qp * N; i += SSD_THREADS) {
      const int q = i / N, n = i % N, t = t0 + q;
      const bool live = q < Q && t < S;
      const float bv = live ? Bm[b * bsb + t * bss + n] : 0.f;
      sB[i] = bv;
      sBt[n * ldt + q] = bv;
      sCt[n * ldt + q] = live ? Cm[b * csb + t * css + n] : 0.f;
    }
    for (int q = tid; q < Qp; q += SSD_THREADS) {
      const int t = t0 + q;
      sdt[q] = q < Q && t < S ? dt[b * dsb + t * dss + h * dsh] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // Qp sequential adds: a small part of the chunk's work
      float acc = 0.f;
      for (int q = 0; q < Qp; ++q) {
        acc += sdt[q] * a;
        scum[q] = acc;
      }
    }
    __syncthreads();
    const float cum_last = scum[Qp - 1];  // pad rows add nothing
    for (int q = tid; q < Qp; q += SSD_THREADS)
      sw[q] = expf(cum_last - scum[q]) * sdt[q];
    // M on 8 x 8 tiles of (i, j) at or below the diagonal; a warp's
    // threads share j0 and walk i0, so their stores to M^T are contiguous
    for (int tt = tid; tt < nt * nt; tt += SSD_THREADS) {
      const int tj = tt / nt, ti = tt % nt;
      if (tj > ti) continue;
      const int i0 = ti * 8, j0 = tj * 8;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
        ld4(sCt + n * ldt + i0, cv);
        ld4(sCt + n * ldt + i0 + 4, cv + 4);
        ld4(sBt + n * ldt + j0, bv);
        ld4(sBt + n * ldt + j0 + 4, bv + 4);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] += cv[r] * bv[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k;
        float col[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
          col[r] = j <= i ? acc[r][k] * expf(scum[i] - scum[j]) * sdt[j] : 0.f;
        }
        st4(sMt + j * Qp + i0, col);
        st4(sMt + j * Qp + i0 + 4, col + 4);
      }
    }
    __syncthreads();
    // y on 8 x 4 tiles of (i, p): M x over j <= i (M^T is 0 above the
    // diagonal inside the diagonal tile) and C state over n
    for (int tt = tid; tt < nt * np4; tt += SSD_THREADS) {
      const int i0 = (tt / np4) * 8, p0 = (tt % np4) * 4;
      float intra[8][4], inter[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) intra[r][k] = inter[r][k] = 0.f;
      for (int j = 0; j < i0 + 8; ++j) {
        float mv[8], xv[4];
        ld4(sMt + j * Qp + i0, mv);
        ld4(sMt + j * Qp + i0 + 4, mv + 4);
        ld4(sx + j * P + p0, xv);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) intra[r][k] += mv[r] * xv[k];
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], sv[4];
        ld4(sCt + n * ldt + i0, cv);
        ld4(sCt + n * ldt + i0 + 4, cv + 4);
        ld4(sS + n * P + p0, sv);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) inter[r][k] += cv[r] * sv[k];
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + r, t = t0 + i;
        if (i < Q && t < S) {
          const float e = expf(scum[i]);
          float out[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) out[k] = intra[r][k] + inter[r][k] * e;
          st4(y + (((size_t)b * S + t) * H + h) * P + p0, out);
        }
      }
    }
    __syncthreads();  // every y read the state before it moves on
    // state on 4 x 4 tiles of (n, p)
    const float decay = expf(cum_last);
    for (int tt = tid; tt < (N / 4) * np4; tt += SSD_THREADS) {
      const int n0 = (tt / np4) * 4, p0 = (tt % np4) * 4;
      float upd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) upd[r][k] = 0.f;
      for (int j = 0; j < Qp; ++j) {
        float bv[4], xv[4];
        ld4(sB + j * N + n0, bv);
        ld4(sx + j * P + p0, xv);
        const float wj = sw[j];
#pragma unroll
        for (int k = 0; k < 4; ++k) xv[k] *= wj;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) upd[r][k] += bv[r] * xv[k];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float sv[4];
        ld4(sS + (n0 + r) * P + p0, sv);
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = sv[k] * decay + upd[r][k];
        st4(sS + (n0 + r) * P + p0, sv);
      }
    }
    __syncthreads();  // the next chunk overwrites x, B and C
  }
  for (int i = tid; i < N * P; i += SSD_THREADS)
    state_out[(size_t)bh * N * P + i] = sS[i];
}

// Dynamic shared memory of one block, in bytes (kernel.py::smem_bytes).
long long ssd_smem_bytes(int P, int N, int Q) {
  const long long Qp = (Q + 7) & ~7;
  return (long long)sizeof(float) *
         (Qp * P + 2LL * N * (Qp + 4) + Qp * N + Qp * Qp + (long long)N * P +
          3LL * Qp);
}

}  // namespace

extern "C" {

// x (B,S,H,P), dt (B,S,H), B_/C_ (B,S,N) f32 through strides in elements
// (innermost stride 1); A (H,); y (B,S,H,P) and state (B,H,N,P)
// contiguous.  Returns the launch's cudaError_t (0 on success).
int ssd_scan_launch(const float* x, long long xsb, long long xss,
                    long long xsh, const float* dt, long long dsb,
                    long long dss, long long dsh, const float* A,
                    const float* Bm, long long bsb, long long bss,
                    const float* Cm, long long csb, long long css, float* y,
                    float* state, int B, int S, int H, int P, int N, int Q,
                    void* stream) {
  const long long smem = ssd_smem_bytes(P, N, Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_scan_kernel<<<B * H, SSD_THREADS, (size_t)smem,
                    (cudaStream_t)stream>>>(
      x, xsb, xss, xsh, dt, dsb, dss, dsh, A, Bm, bsb, bss, Cm, csb, css, y,
      state, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
