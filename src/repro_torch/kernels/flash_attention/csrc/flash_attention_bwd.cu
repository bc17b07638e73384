// Backward attention for Hopper (sm_90a): the gradients dq, dk, dv of
// o = softmax(scale q k^T + mask) v, for f32 or bf16 q, k, v with any head
// dim that is a multiple of 8 up to 256.
//
// Replaces no TPU kernel.  The JAX package never differentiates its Pallas
// kernel (kernels/flash_attention/kernel.py::_flash_kernel, K6): it trains
// through the pure-JAX models/attention.py::chunked_attention, whose
// gradient XLA derives.  The port runs that function on the card as K6, so
// training on the card needs this backward, behind the autograd Function
// ops.FlashAttentionFn.
//
// Three kernels behind the one entry point flash_attention_bwd_launch, on
// the caller's stream (the FlashAttention-2 backward):
// 1. fa_bwd_pre_kernel, one warp a row: delta_i = rowsum(dO_i * O_i), f32.
// 2. fa_bwd_dkdv_kernel, one block per (key tile of BK keys, kv head kh,
//    b): K and V of the tile in shared memory once, then for each of the g
//    query heads of kh's group (GQA) and each query tile of BQ rows that
//    can see the tile: S = scale Q K^T and dP = dO V^T, P = exp(S - lse)
//    where the mask lets the key through, dS = P (dP - delta); then
//    dV += P^T dO and dK += dS^T Q into registers.  The group's heads sum
//    in the block, in a fixed order: no atomics.
// 3. fa_bwd_dq_kernel, one block per (query tile, head h, b): the same S
//    and dP over the key tiles the rows can see, dQ += dS K.
// dQ and dK take the scale once at the end.  Every output element is a sum
// that one thread forms in a fixed order, so two runs give the same bits.
//
// The masks are the forward's: causal (key j <= query position), a window
// (position - j < window when window > 0), query i at position
// i + Sk - Sq, keys >= Sk never seen; tiles outside the causal band or the
// window are not visited.  lse (B, H, Sq) f32 is the forward's per-row
// natural log-sum-exp of the scaled logits (flash_attention_wgmma.cu and
// flash_attention_tf32.cu write it when asked); the forward's v head dim
// other than q/k's is handled by the wrapper, which pads all of q, k, v,
// o and dO with zero columns to the wider width and cuts the gradients
// back.
//
// Products are f32 FMAs on the CUDA cores from tiles converted to f32 in
// shared memory (bf16 inputs are exact in f32), accumulated in f32, and
// the gradients are rounded to the input type once.  A thread holds a 2 x
// 2 block of S and dP and D / 8 columns of one row of dK and dV (or dQ).
//
// What bounds it: the five products (S recomputed, dP, dV, dK, dQ) are
// 10 B H Sq Sk D operations (halved when causal): at qwen2.5-32b's
// training shape (B 2, S 2048, 40 heads, D 128, causal) 215 GFLOP, 0.22
// ms at the tensor cores' 989 TFLOP/s in bf16.  This kernel runs seven
// products (dq's block recomputes S and dP) on the CUDA cores (67 TFLOP/s
// at most), reading two shared-memory words per FMA pair: it is bound by
// shared memory, tens of times its bound.  A tensor-core design (mma.sync
// or wgmma fed by TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows of a tile
constexpr int BK = 32;        // keys of a tile
constexpr int THREADS = 256;  // 16 x 16 threads over a 32 x 32 tile of S
constexpr int LDP = BK + 1;   // row stride of the P and dS tiles

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// shared memory of the dk/dv and dq kernels at padded width DM: four
// BQ or BK x (DM + 1) f32 tiles, P and dS, lse and delta
constexpr size_t smem_bytes(int DM) {
  return sizeof(float) *
         (size_t)(2 * BK * (DM + 1) + 2 * BQ * (DM + 1) + 2 * BQ * LDP +
                  2 * BQ);
}

__device__ __forceinline__ bool visible(int qi, int j, int Sk, int causal,
                                        int window) {
  bool live = j < Sk;
  if (causal) live = live && j <= qi;
  if (window > 0) live = live && qi - j < window;
  return live;
}

// rows [0, n) of an (S, heads, hd) tensor at (b, head, first row) into an
// n_max x LD f32 tile, zeros past n and past hd up to DM
template <typename T, int DM>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t row_stride, int n, int n_max,
                                          int hd) {
  constexpr int LD = DM + 1;
  for (int e = threadIdx.x; e < n_max * DM; e += THREADS) {
    const int r = e / DM, c = e % DM;
    dst[r * LD + c] =
        (r < n && c < hd) ? to_f<T>(src[(size_t)r * row_stride + c]) : 0.f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's 2 x 2 entries (rows ti,
// ti + 16 of the query tile; keys tj, tj + 16)
template <int DM>
__device__ __forceinline__ void tile_products(const float* sQ,
                                              const float* sO,
                                              const float* sK,
                                              const float* sV, int hd,
                                              float (&s)[2][2],
                                              float (&dp)[2][2]) {
  constexpr int LD = DM + 1;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float q0 = sQ[ti * LD + d], q1 = sQ[(ti + 16) * LD + d];
    const float o0 = sO[ti * LD + d], o1 = sO[(ti + 16) * LD + d];
    const float k0 = sK[tj * LD + d], k1 = sK[(tj + 16) * LD + d];
    const float v0 = sV[tj * LD + d], v1 = sV[(tj + 16) * LD + d];
    s[0][0] = fmaf(q0, k0, s[0][0]);
    s[0][1] = fmaf(q0, k1, s[0][1]);
    s[1][0] = fmaf(q1, k0, s[1][0]);
    s[1][1] = fmaf(q1, k1, s[1][1]);
    dp[0][0] = fmaf(o0, v0, dp[0][0]);
    dp[0][1] = fmaf(o0, v1, dp[0][1]);
    dp[1][0] = fmaf(o1, v0, dp[1][0]);
    dp[1][1] = fmaf(o1, v1, dp[1][1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fa_bwd_pre_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, int rows, int Sq, int H, int hd) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32)
    acc = fmaf(to_f<T>(o[base + c]), to_f<T>(dout[base + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int b = row / (Sq * H), i = (row / H) % Sq, h = row % H;
    delta[((size_t)b * H + h) * Sq + i] = acc;
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(THREADS) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Sk, int H, int KH, int hd, float scale, int causal,
    int window) {
  constexpr int LD = DM + 1;
  constexpr int NC = DM / 8;  // columns of dK and dV a thread holds
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;  // dO
  float* sP = sO + BQ * LD;
  float* sS = sP + BQ * LDP;  // dS
  float* sL = sS + BQ * LDP;  // lse
  float* sD = sL + BQ;        // delta
  const int g = H / KH, kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int j0 = blockIdx.x * BK, shift = Sk - Sq;
  const int nk = min(BK, Sk - j0);
  load_rows<T, DM>(sK, k + (((size_t)b * Sk + j0) * KH + kh) * hd,
                   (size_t)KH * hd, nk, BK, hd);
  load_rows<T, DM>(sV, v + (((size_t)b * Sk + j0) * KH + kh) * hd,
                   (size_t)KH * hd, nk, BK, hd);
  // the query rows that can see a key of this tile
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, j0 - shift);
  if (window > 0) i_hi = min(Sq, j0 + BK - 1 + window - shift);
  const int ar = tid >> 3, ac = tid & 7;  // accumulator row and columns
  const int ti = tid >> 4, tj = tid & 15;
  float acc_k[NC], acc_v[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc_k[m] = acc_v[m] = 0.f;

  for (int r = 0; r < g; ++r) {
    const int h = kh * g + r;
    for (int i0 = i_lo / BQ * BQ; i0 < i_hi; i0 += BQ) {
      const int nq = min(BQ, Sq - i0);
      __syncthreads();  // the last tile's P, dS, Q and dO are consumed
      load_rows<T, DM>(sQ, q + (((size_t)b * Sq + i0) * H + h) * hd,
                       (size_t)H * hd, nq, BQ, hd);
      load_rows<T, DM>(sO, dout + (((size_t)b * Sq + i0) * H + h) * hd,
                       (size_t)H * hd, nq, BQ, hd);
      if (tid < BQ) {
        const size_t row = ((size_t)b * H + h) * Sq + i0 + tid;
        sL[tid] = tid < nq ? lse[row] : 0.f;
        sD[tid] = tid < nq ? delta[row] : 0.f;
      }
      __syncthreads();
      float s[2][2], dp[2][2];
      tile_products<DM>(sQ, sO, sK, sV, hd, s, dp);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int il = ti + 16 * a, jl = tj + 16 * c;
          const bool live = il < nq && visible(i0 + il + shift, j0 + jl, Sk,
                                               causal, window);
          const float p = live ? expf(s[a][c] * scale - sL[il]) : 0.f;
          sP[il * LDP + jl] = p;
          sS[il * LDP + jl] = p * (dp[a][c] - sD[il]);
        }
      }
      __syncthreads();
      for (int il = 0; il < nq; ++il) {
        const float p = sP[il * LDP + ar], ds = sS[il * LDP + ar];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          acc_v[m] = fmaf(p, sO[il * LD + ac + 8 * m], acc_v[m]);
          acc_k[m] = fmaf(ds, sQ[il * LD + ac + 8 * m], acc_k[m]);
        }
      }
    }
  }
  if (ar < nk) {
    const size_t base = (((size_t)b * Sk + j0 + ar) * KH + kh) * hd;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = ac + 8 * m;
      if (c < hd) {
        dk[base + c] = from_f<T>(acc_k[m] * scale);
        dv[base + c] = from_f<T>(acc_v[m]);
      }
    }
  }
}

template <typename T, int DM>
__global__ void __launch_bounds__(THREADS) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
    int H, int KH, int hd, float scale, int causal, int window) {
  constexpr int LD = DM + 1;
  constexpr int NC = DM / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;
  float* sS = sO + BQ * LD + BQ * LDP;  // dS (the P tile is not needed)
  float* sL = sS + BQ * LDP;
  float* sD = sL + BQ;
  const int g = H / KH, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int kh = h / g, i0 = blockIdx.x * BQ, shift = Sk - Sq;
  const int nq = min(BQ, Sq - i0);
  load_rows<T, DM>(sQ, q + (((size_t)b * Sq + i0) * H + h) * hd,
                   (size_t)H * hd, nq, BQ, hd);
  load_rows<T, DM>(sO, dout + (((size_t)b * Sq + i0) * H + h) * hd,
                   (size_t)H * hd, nq, BQ, hd);
  if (tid < BQ) {
    const size_t row = ((size_t)b * H + h) * Sq + i0 + tid;
    sL[tid] = tid < nq ? lse[row] : 0.f;
    sD[tid] = tid < nq ? delta[row] : 0.f;
  }
  // the keys these rows can see
  int j_lo = 0, j_hi = Sk;
  if (causal) j_hi = min(Sk, max(0, i0 + nq - 1 + shift + 1));
  if (window > 0) j_lo = max(0, i0 + shift - window + 1);
  const int ar = tid >> 3, ac = tid & 7;
  const int ti = tid >> 4, tj = tid & 15;
  float acc[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) acc[m] = 0.f;

  for (int j0 = j_lo / BK * BK; j0 < j_hi; j0 += BK) {
    const int nk = min(BK, Sk - j0);
    __syncthreads();  // the last tile's K and dS are consumed
    load_rows<T, DM>(sK, k + (((size_t)b * Sk + j0) * KH + kh) * hd,
                     (size_t)KH * hd, nk, BK, hd);
    load_rows<T, DM>(sV, v + (((size_t)b * Sk + j0) * KH + kh) * hd,
                     (size_t)KH * hd, nk, BK, hd);
    __syncthreads();
    float s[2][2], dp[2][2];
    tile_products<DM>(sQ, sO, sK, sV, hd, s, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int il = ti + 16 * a, jl = tj + 16 * c;
        const bool live = il < nq && visible(i0 + il + shift, j0 + jl, Sk,
                                             causal, window);
        const float p = live ? expf(s[a][c] * scale - sL[il]) : 0.f;
        sS[il * LDP + jl] = p * (dp[a][c] - sD[il]);
      }
    }
    __syncthreads();
    for (int jl = 0; jl < nk; ++jl) {
      const float ds = sS[ar * LDP + jl];
#pragma unroll
      for (int m = 0; m < NC; ++m)
        acc[m] = fmaf(ds, sK[jl * LD + ac + 8 * m], acc[m]);
    }
  }
  if (ar < nq) {
    const size_t base = (((size_t)b * Sq + i0 + ar) * H + h) * hd;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      const int c = ac + 8 * m;
      if (c < hd) dq[base + c] = from_f<T>(acc[m] * scale);
    }
  }
}

template <typename T, int DM>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int H, int KH, int hd,
           float scale, int causal, int window, cudaStream_t st) {
  const int smem = (int)smem_bytes(DM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<T, DM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, DM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  fa_bwd_pre_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS,
                         0, st>>>((const T*)o, (const T*)dout, delta, rows,
                                  Sq, H, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dkdv_kernel<T, DM><<<dim3((Sk + BK - 1) / BK, KH, B), THREADS, smem,
                              st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, Sq, Sk, H, KH, hd, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fa_bwd_dq_kernel<T, DM><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, smem,
                            st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dq, Sq, Sk, H, KH, hd, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
                 int hd, float scale, int causal, int window,
                 cudaStream_t st) {
  switch ((hd + 63) / 64) {  // padded to 64, 128, 192 or 256 columns
    case 1:
      return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, H, KH, hd, scale, causal, window, st);
    case 2:
      return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KH, hd, scale, causal, window, st);
    case 3:
      return launch<T, 192>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KH, hd, scale, causal, window, st);
    default:
      return launch<T, 256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                            Sk, H, KH, hd, scale, causal, window, st);
  }
}

}  // namespace

extern "C" {

// q, o, dout, dq (B,Sq,H,hd) and k, v, dk, dv (B,Sk,KH,hd), contiguous,
// all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); lse (B,H,Sq) f32 from
// the forward; delta (B,H,Sq) f32 scratch.  hd a multiple of 8 up to 256,
// H % KH == 0.  Three launches on the stream; returns the first
// cudaError_t (0 on success).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int Sq, int Sk,
                               int H, int KH, int hd, float scale, int causal,
                               int window, int is_bf16, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || KH < 1 || H % KH != 0 || Sq < 1 ||
      Sk < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_width<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, Sq, Sk, H, KH, hd, scale,
                                       causal, window, st);
  return launch_width<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                             Sk, H, KH, hd, scale, causal, window, st);
}

const char* fab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
