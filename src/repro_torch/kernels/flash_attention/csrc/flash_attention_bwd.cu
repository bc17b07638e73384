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
// Two routes, one per input dtype, each behind its own C entry point; the
// wrapper (kernel.py::bwd_route) picks the route from the dtype alone.
// Both are three kernels on the caller's stream (the FlashAttention-2
// backward):
// 1. fa_bwd_pre_kernel, one warp a row: delta_i = rowsum(dO_i * O_i), f32.
// 2. a dK/dV kernel, one block per (key tile, kv head kh, b): K and V of
//    the tile in shared memory once, then for each of the g query heads of
//    kh's group (GQA) and each query tile that can see the tile, in a fixed
//    order: S = scale Q K^T and dP = dO V^T, P = exp(S - lse) where the
//    mask lets the key through, dS = P (dP - delta); then dV += P^T dO and
//    dK += dS^T Q.  The group's heads sum in the block: no atomics.
// 3. a dQ kernel, one block per (query tile, head h, b): the same S and dP
//    over the key tiles the rows can see, dQ += dS K.
// dQ and dK take the scale once at the end.  Every output element is a sum
// that one thread forms in a fixed order, so two runs give the same bits.
// The dQ kernel recomputes S and dP: the call runs seven products where
// the function needs five, which costs less than a per-key-tile dQ buffer
// would move (B H Sk/BM Sq D f32 words, ~2.7 GB at qwen2.5-32b's shape).
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
// Both routes share one layout.  Each warp owns 16 rows of the block's
// fixed tile (keys in the dK/dV kernel, queries in the dQ kernel) and
// sweeps the streamed tile's rows, which cp.async copies in two stages,
// the next tile in flight while this one is used; so the probabilities
// stay in registers: in the dK/dV kernel the warp forms S^T = K Q^T and
// dP^T = V dO^T (keys as rows), and the accumulator fragments of P^T =
// exp(scale S^T - lse) and dS^T = P^T (dP^T - delta) are the A operands of
// dV += P^T dO and dK += dS^T Q; in the dQ kernel dS feeds dQ += dS K the
// same way.  At D 192 and 256 a block holds half of dK's and dV's columns
// (the grid's y covers both halves, each block forming S and dP over all
// of D), so their accumulators fit in registers.  The loops run over the
// padded width: the tiles hold zeros past hd.  A warp skips a streamed
// tile wholly outside its mask and evaluates the mask only where a tile
// crosses it.
//
// bf16 route (flash_attention_bwd_bf16_launch: fa_bwd_dkdv_mma_kernel,
// fa_bwd_dq_mma_kernel): every product is mma.sync.m16n8k16 with bf16
// operands and f32 accumulators, fed by ldmatrix (.trans for the operands
// stored k-major) from bf16 tiles.  An m16n8k16 accumulator pair has the A
// fragment's layout, so P and dS, rounded to bf16, are A operands as they
// stand.  The logits and the softmax stay in f32; only P and dS are
// rounded to bf16 before their products, where the bf16 plain version
// rounds q k and p.  Tiles (MmaCfg): at D 64 and 128 blocks of 4 warps (64
// fixed rows), 64 streamed query rows (dK/dV) or 32 keys (dQ), two blocks
// an SM; at D 192 and 256 blocks of 8 warps (128 fixed rows) and 32
// streamed rows.  Rows are padded by 8 bf16 so ldmatrix's eight 16-byte
// rows hit distinct banks.
//
// f32 route (flash_attention_bwd_tf32_launch: fa_bwd_dkdv_tf32_kernel,
// fa_bwd_dq_tf32_kernel): every product in split TF32 on
// mma.sync.m16n8k8, the forward's form (flash_attention_tf32.cu): an f32
// operand a = hi + lo, hi = a cut to TF32 (a's own bits: the tensor cores
// read a .tf32 operand's top 19) and lo = a - hi, and a product lo*hi +
// hi*lo + hi*hi, which keeps the f32 contract where one TF32 product would
// not.  The threads load the fragments from f32 tiles (rows padded to LD =
// D + 4 floats, LD = 4 mod 32, so every fragment load hits 32 distinct
// banks) and split them in registers.  Two things differ from bf16:
// - The m16n8k8 accumulator is not the TF32 A fragment: a thread holds P^T
//   (or dS^T, dS) at columns (2t, 2t + 1) of each 8-column group, rows g and
//   g + 8, where the A fragment wants k-positions (t, t + 4).  The sum over
//   the streamed rows is order-free, so k-position t stands for streamed row
//   2t and t + 4 for row 2t + 1, and the B fragments of dO, Q (dK/dV
//   kernel) and K (dQ kernel) load those rows: P and dS never leave
//   registers.  A card test whose streamed rows are all distinct pins this
//   (tests/test_torch_cuda.py).
// - The tensor cores add into their accumulator with truncation at its
//   magnitude, so no accumulator takes many of their adds: S and dP go to a
//   fresh one every four k-steps (12 adds), dV and dK, four n-tiles at a
//   time, to a fresh one every pass of SUB query rows (3 SUB / 8 adds), dQ
//   every stage of BS keys (3 BS / 8); f32 adds sum those.
// Tiles (Tf32Cfg, each instance static_asserts its shared memory: the
// fixed K and V, or Q and dO, and two stages of the streamed pair with
// their lse and delta): D 64 blocks of 8 warps (128 fixed rows) and 64
// streamed rows, the dK/dV kernel in passes of 32, 140 KB; D 128 8 warps
// and 32 rows, the dK/dV kernel in passes of 16 (at 32 its 128
// accumulators a thread and P^T's and dS^T's registers spill), 203 KB;
// D 192 4 warps and 32 rows, 201 KB; D 256 4 warps and 16 rows, 200 KB;
// one block an SM.
// The CUDA-core kernels of the first design (fa_bwd_dkdv_kernel,
// fa_bwd_dq_kernel: f32 FMAs from tiles in shared memory, a thread a 2 x 2
// block of S and dP and D / 8 columns of one row of dK and dV or dQ, 32 x
// 32 tiles) stay behind flash_attention_bwd_f32_launch as the f32 referee
// that chip_smoke.py launches raw; no input is routed to them.
//
// What bounds it: the five products (S recomputed, dP, dV, dK, dQ) are
// 10 B H Sq Sk D operations (halved when causal): at qwen2.5-32b's
// training shape (B 2, S 2048, 40 heads, D 128, causal) 215 GFLOP, 0.22
// ms at the tensor cores' 989 TFLOP/s in bf16, and 1.30 ms in f32 as three
// TF32 products each at 495 TFLOP/s (3.21 ms as f32 FMAs at 67 TFLOP/s).
// Both routes run seven products on mma.sync, whose warps each read their
// B operands from shared memory, so shared memory, not the tensor cores,
// sets their pace; wgmma with TMA-fed tiles is the next step.

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

// ---------------------------------------------------------------- bf16
// Fragments of m16n8k16 (g = lane / 4, t = lane % 4), two bf16 a register,
// the lower column in the low half: A a0 (row g, k 2t..), a1 (g + 8, 2t),
// a2 (g, 2t + 8), a3 (g + 8, 2t + 8); B b0 (k 2t.., n g), b1 (k 2t + 8, n
// g); C c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8).  So the
// accumulators of two neighbouring n-tiles, packed to bf16 pairs, are the
// A fragment of the 16 k-columns they cover.

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

template <int D_, int DC_, int BQ_, int BT_, int WARPS_>
struct MmaCfg {
  static constexpr int D = D_;    // padded head dim
  static constexpr int DC = DC_;  // dK/dV columns a block holds
  static constexpr int BQ = BQ_;  // query rows of a dK/dV kernel's stage
  static constexpr int BT = BT_;  // keys of a dQ kernel's stage
  static constexpr int NSPLIT = D / DC;
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;  // the block's fixed rows
  static constexpr int LD = D + 8;       // bf16 a row: 16 bytes of padding
  static constexpr int DKDV_SMEM =
      2 * (2 * BM * LD + 2 * 2 * BQ * LD) + 4 * 2 * 2 * BQ;
  static constexpr int DQ_SMEM = 2 * (2 * BM * LD + 2 * 2 * BT * LD);
};

using Mma64 = MmaCfg<64, 64, 64, 32, 4>;
using Mma128 = MmaCfg<128, 128, 64, 32, 4>;
using Mma192 = MmaCfg<192, 96, 32, 32, 8>;
using Mma256 = MmaCfg<256, 128, 32, 32, 8>;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block, sm_90
static_assert(Mma128::DKDV_SMEM <= SMEM_LIMIT && Mma128::DQ_SMEM <= SMEM_LIMIT,
              "D = 128: shared memory");
static_assert(Mma192::DKDV_SMEM <= SMEM_LIMIT && Mma192::DQ_SMEM <= SMEM_LIMIT,
              "D = 192: shared memory");
static_assert(Mma256::DKDV_SMEM <= SMEM_LIMIT && Mma256::DQ_SMEM <= SMEM_LIMIT,
              "D = 256: shared memory");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
// 4 bytes where live, else a zero stored
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  if (live) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src));
  } else {
    *dst = 0.f;
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of an accumulator 16 x (8 NT) (rows, k), rounded to bf16
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4],
                                     const float (&c)[NT][4]) {
#pragma unroll
  for (int k = 0; k < NT / 2; ++k) {
    a[k][0] = pack_bf16(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack_bf16(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack_bf16(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack_bf16(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// rows [0, n_max) of a (rows, heads, hd) bf16 tensor from src (its first
// row, stride rs elements) into a tile of row stride LD by cp.async,
// zeros in rows past n and columns past hd up to D
template <class C>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               size_t rs, int n_max, int n,
                                               int hd) {
  constexpr int CH = C::D / 8;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < n_max * CH; e += C::THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    bf16* d = dst + r * C::LD + c;
    if (r < n && c < hd)
      cp_async16(d, src + (size_t)r * rs + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[NT] (16 x 8 NT) = A B^T over the padded width: A's 16 rows at a
// (row stride LD), B's 8 NT rows at b, both k-contiguous (ldmatrix, no
// transpose).  Columns past hd are zeros in the tiles, so the loops run
// over the whole padded width, with no branch between the products.
template <int NT, int KD, int LD>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const bf16* a,
                                        const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[NC] (16 x 8 NC) += A B: A from registers (16 x 16 KS), B's 16 KS
// rows at b (row stride LD, n-contiguous: ldmatrix.trans), columns of B
// from b's own column 0
template <int KS, int NC, int LD>
__device__ __forceinline__ void mma_ab(float (&acc)[NC][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (k * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a[k], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a[k], bf[2], bf[3]);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) fa_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int KH, int hd, float scale, int causal, int window) {
  constexpr int BM = C::BM, BQ = C::BQ, LD = C::LD, DC = C::DC;
  constexpr int NS = BQ / 8;  // n-tiles of S^T and dP^T
  constexpr int NA = DC / 8;  // n-tiles of dK and dV
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + BM * LD;
  bf16* sQ = sV + BM * LD;  // stage s: Q at sQ + 2 s BQ LD, then dO
  float* sLD = reinterpret_cast<float*>(sQ + 4 * BQ * LD);  // stage s: lse, delta
  const int g = H / KH, kh = blockIdx.y / C::NSPLIT, b = blockIdx.z;
  const int dc0 = (blockIdx.y % C::NSPLIT) * DC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * BM, shift = Sk - Sq, jw = j0 + 16 * warp;
  load_rows_bf16<C>(sK, k + (((size_t)b * Sk + j0) * KH + kh) * hd,
                    (size_t)KH * hd, BM, Sk - j0, hd);
  load_rows_bf16<C>(sV, v + (((size_t)b * Sk + j0) * KH + kh) * hd,
                    (size_t)KH * hd, BM, Sk - j0, hd);
  cp_async_commit();
  // the query tiles whose rows can see a key of this tile
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, j0 - shift);
  if (window > 0) i_hi = min(Sq, j0 + BM - 1 + window - shift);
  const int t_lo = i_lo / BQ;
  const int n_t = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - t_lo : 0;
  const int steps = g * n_t;  // (head, query tile), heads outer
  auto issue = [&](int s) {
    const int h = kh * g + s / n_t, i0 = (t_lo + s % n_t) * BQ;
    bf16* tQ = sQ + (s & 1) * 2 * BQ * LD;
    const size_t off = (((size_t)b * Sq + i0) * H + h) * hd;
    load_rows_bf16<C>(tQ, q + off, (size_t)H * hd, BQ, Sq - i0, hd);
    load_rows_bf16<C>(tQ + BQ * LD, dout + off, (size_t)H * hd, BQ, Sq - i0,
                      hd);
    if (tid < BQ) {
      const size_t row = ((size_t)b * H + h) * Sq + i0 + tid;
      float* tl = sLD + (s & 1) * 2 * BQ;
      cp_async4(tl + tid, lse + row, i0 + tid < Sq);
      cp_async4(tl + BQ + tid, delta + row, i0 + tid < Sq);
    }
    cp_async_commit();
  };
  const float sl2 = scale * LOG2E;
  float accK[NA][4], accV[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[n][e] = accV[n][e] = 0.f;

  if (steps > 0) issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = (t_lo + s % n_t) * BQ;
    const bf16* tQ = sQ + (s & 1) * 2 * BQ * LD;
    const bf16* tO = tQ + BQ * LD;
    const float* tl = sLD + (s & 1) * 2 * BQ;
    const float* td = tl + BQ;
    const bool dead = jw >= Sk || (causal && i0 + BQ - 1 + shift < jw) ||
                      (window > 0 && i0 + shift - (jw + 15) >= window);
    if (!dead) {
      const bool full = i0 + BQ <= Sq && jw + 16 <= Sk &&
                        (!causal || jw + 15 <= i0 + shift) &&
                        (window <= 0 || i0 + BQ - 1 + shift - jw < window);
      // P^T = exp(scale K Q^T - lse), keys as rows
      float p[NS][4];
      mma_abt<NS, C::D / 16, LD>(p, sK + 16 * warp * LD, tQ);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * tq + (e & 1);
          const int j = jw + gr + (e >> 1) * 8;
          float x = exp2f(fmaf(p[n][e], sl2, -tl[ql] * LOG2E));
          if (!full && !(i0 + ql < Sq &&
                         visible(i0 + ql + shift, j, Sk, causal, window)))
            x = 0.f;
          p[n][e] = x;
        }
      }
      uint32_t pa[NS / 2][4];
      to_a<NS>(pa, p);
      mma_ab<NS / 2, NA, LD>(accV, pa, tO + dc0);  // dV += P^T dO
      // dS^T = P^T (V dO^T - delta)
      float ds[NS][4];
      mma_abt<NS, C::D / 16, LD>(ds, sV + 16 * warp * LD, tO);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - td[n * 8 + 2 * tq + (e & 1)]);
      to_a<NS>(pa, ds);
      mma_ab<NS / 2, NA, LD>(accK, pa, tQ + dc0);  // dK += dS^T Q
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int c = dc0 + n * 8 + 2 * tq;
    if (c >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = jw + gr + 8 * half;
      if (j >= Sk) continue;
      const size_t at = (((size_t)b * Sk + j) * KH + kh) * hd + c;
      *reinterpret_cast<uint32_t*>(dk + at) = pack_bf16(
          accK[n][2 * half] * scale, accK[n][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(accV[n][2 * half], accV[n][2 * half + 1]);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) fa_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int KH, int hd, float scale,
    int causal, int window) {
  constexpr int BM = C::BM, BT = C::BT, LD = C::LD;
  constexpr int NS = BT / 8;      // n-tiles of S and dP
  constexpr int NQ = C::D / 8;    // n-tiles of dQ
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sO = sQ + BM * LD;        // dO
  bf16* sKV = sO + BM * LD;       // stage s: K at sKV + 2 s BT LD, then V
  const int g = H / KH, h = blockIdx.y, kh = h / g, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // query tiles last to first: under the causal mask the last see the most
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BM, shift = Sk - Sq;
  const int nq = min(BM, Sq - i0), iw = i0 + 16 * warp;
  const size_t qoff = (((size_t)b * Sq + i0) * H + h) * hd;
  load_rows_bf16<C>(sQ, q + qoff, (size_t)H * hd, BM, nq, hd);
  load_rows_bf16<C>(sO, dout + qoff, (size_t)H * hd, BM, nq, hd);
  cp_async_commit();
  float lrow[2], drow[2];  // rows iw + gr and iw + gr + 8
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = iw + gr + 8 * e;
    const size_t row = ((size_t)b * H + h) * Sq + i;
    lrow[e] = i < Sq ? lse[row] * LOG2E : 0.f;
    drow[e] = i < Sq ? delta[row] : 0.f;
  }
  // the key tiles these rows can see
  int j_lo = 0, j_hi = Sk;
  if (causal) j_hi = min(Sk, max(0, i0 + nq + shift));
  if (window > 0) j_lo = max(0, i0 + shift - window + 1);
  const int t_lo = j_lo / BT;
  const int n_t = j_hi > j_lo ? (j_hi + BT - 1) / BT - t_lo : 0;
  auto issue = [&](int s) {
    const int j0 = (t_lo + s) * BT;
    bf16* tK = sKV + (s & 1) * 2 * BT * LD;
    const size_t off = (((size_t)b * Sk + j0) * KH + kh) * hd;
    load_rows_bf16<C>(tK, k + off, (size_t)KH * hd, BT, Sk - j0, hd);
    load_rows_bf16<C>(tK + BT * LD, v + off, (size_t)KH * hd, BT, Sk - j0,
                      hd);
    cp_async_commit();
  };
  const float sl2 = scale * LOG2E;
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (n_t > 0) issue(0);
  for (int s = 0; s < n_t; ++s) {
    if (s + 1 < n_t) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = (t_lo + s) * BT;
    const bf16* tK = sKV + (s & 1) * 2 * BT * LD;
    const bf16* tV = tK + BT * LD;
    const bool dead = iw >= Sq || (causal && j0 > iw + 15 + shift) ||
                      (window > 0 && iw + shift - (j0 + BT - 1) >= window);
    if (!dead) {
      const bool full = iw + 16 <= Sq && j0 + BT <= Sk &&
                        (!causal || j0 + BT - 1 <= iw + shift) &&
                        (window <= 0 || iw + 15 + shift - j0 < window);
      float p[NS][4];
      mma_abt<NS, C::D / 16, LD>(p, sQ + 16 * warp * LD, tK);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + n * 8 + 2 * tq + (e & 1);
          const int i = iw + gr + (e >> 1) * 8;
          float x = exp2f(fmaf(p[n][e], sl2, -lrow[e >> 1]));
          if (!full && !(i < Sq && visible(i + shift, j, Sk, causal, window)))
            x = 0.f;
          p[n][e] = x;
        }
      }
      float ds[NS][4];
      mma_abt<NS, C::D / 16, LD>(ds, sO + 16 * warp * LD, tV);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - drow[e >> 1]);
      uint32_t da[NS / 2][4];
      to_a<NS>(da, ds);
      mma_ab<NS / 2, NQ, LD>(acc, da, tK);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int c = n * 8 + 2 * tq;
    if (c >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = iw + gr + 8 * half;
      if (i >= Sq) continue;
      *reinterpret_cast<uint32_t*>(dq + (((size_t)b * Sq + i) * H + h) * hd +
                                   c) =
          pack_bf16(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

template <class C>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
               int hd, float scale, int causal, int window, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DKDV_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq_mma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  fa_bwd_pre_kernel<bf16><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                            THREADS, 0, st>>>((const bf16*)o,
                                              (const bf16*)dout, delta, rows,
                                              Sq, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv_mma_kernel<C><<<dim3((Sk + C::BM - 1) / C::BM, KH * C::NSPLIT,
                                   B),
                              C::THREADS, C::DKDV_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H, KH, hd, scale, causal, window);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dq_mma_kernel<C><<<dim3((Sq + C::BM - 1) / C::BM, H, B), C::THREADS,
                            C::DQ_SMEM, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dq, Sq, Sk, H, KH, hd, scale, causal, window);
  return (int)cudaGetLastError();
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

int launch_mma_width(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int B,
                     int Sq, int Sk, int H, int KH, int hd, float scale,
                     int causal, int window, cudaStream_t st) {
  switch ((hd + 63) / 64) {  // padded to 64, 128, 192 or 256 columns
    case 1:
      return launch_mma<Mma64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               Sq, Sk, H, KH, hd, scale, causal, window, st);
    case 2:
      return launch_mma<Mma128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Sk, H, KH, hd, scale, causal, window, st);
    case 3:
      return launch_mma<Mma192>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Sk, H, KH, hd, scale, causal, window, st);
    default:
      return launch_mma<Mma256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                Sq, Sk, H, KH, hd, scale, causal, window, st);
  }
}

// ---------------------------------------------------------------- f32
// Fragments of m16n8k8 TF32 (g = lane / 4, t = lane % 4): A a0 (row g, k
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1
// (k t + 4, n g); C c0 (row g, column 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).

template <int D_, int DC_, int WARPS_, int BS_, int SUB_>
struct Tf32Cfg {
  static constexpr int D = D_;    // padded head dim
  static constexpr int DC = DC_;  // dK/dV columns a block holds
  static constexpr int NSPLIT = D / DC;
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 16 * WARPS;  // the block's fixed rows
  static constexpr int BS = BS_;  // streamed rows a stage: queries or keys
  // query rows of a stage a dK/dV pass takes: passes of 16 keep P^T's and
  // dS^T's registers few enough that D = 128's 128 accumulators a thread
  // do not spill, while a stage still loads 32 rows between barriers
  static constexpr int SUB = SUB_;
  static constexpr int LD = D + 4;  // floats a row: LD = 4 mod 32
  // the fixed pair, two stages of the streamed pair, lse and delta a stage
  static constexpr int SMEM = 4 * (2 * BM * LD + 2 * 2 * BS * LD + 2 * 2 * BS);
};

using Tf32_64 = Tf32Cfg<64, 64, 8, 64, 32>;
using Tf32_128 = Tf32Cfg<128, 128, 8, 32, 16>;
using Tf32_192 = Tf32Cfg<192, 96, 4, 32, 32>;
using Tf32_256 = Tf32Cfg<256, 128, 4, 16, 16>;
static_assert(Tf32_64::SMEM <= SMEM_LIMIT, "f32, D = 64: shared memory");
static_assert(Tf32_128::SMEM <= SMEM_LIMIT, "f32, D = 128: shared memory");
static_assert(Tf32_192::SMEM <= SMEM_LIMIT, "f32, D = 192: shared memory");
static_assert(Tf32_256::SMEM <= SMEM_LIMIT, "f32, D = 256: shared memory");

// v = hi + lo in TF32: hi is v's own bits (the tensor cores read the top
// 19), lo = v - hi (exact, |lo| < 2^-10 |v|), read the same way there
__device__ __forceinline__ uint32_t lo_tf32(float v) {
  return __float_as_uint(v - __uint_as_float(__float_as_uint(v) & 0xffffe000u));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hi[k] = __float_as_uint(v[k]);
    lo[k] = lo_tf32(v[k]);
  }
}

// d = a b + d, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32 for the B fragment (b0, b1), split here: lo*hi,
// hi*lo, then hi*hi, each n-tile's three products in a row (one B
// fragment's registers live at a time, which keeps the D = 128 dK/dV
// kernel from spilling)
__device__ __forceinline__ void mma3_tf32(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0,
                                          float b1) {
  const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, lo_tf32(b0), lo_tf32(b1));
  mma_tf32(d, ah, h0, h1);
}

// rows [0, n_max) of a (rows, heads, hd) f32 tensor from src (its first
// row, stride rs elements) into a tile of row stride LD by cp.async,
// zeros in rows past n and columns past hd up to D
template <class C>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t rs, int n_max, int n,
                                              int hd) {
  constexpr int CH = C::D / 4;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < n_max * CH; e += C::THREADS) {
    const int r = e / CH, c = (e % CH) * 4;
    float* d = dst + r * C::LD + c;
    if (r < n && c < hd)
      cp_async16(d, src + (size_t)r * rs + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc[NT] (16 x 8 NT) = A B^T over the padded width D in split TF32: A's
// 16 rows at a, B's 8 NT rows at b, both k-contiguous (row stride LD).
// Four k-steps at a time go to a fresh accumulator (12 truncating adds)
// that f32 adds put into acc.
template <int NT, int D, int LD>
__device__ __forceinline__ void mma_abt_tf32(float (&acc)[NT][4],
                                             const float* a, const float* b) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const float* ar = a + gr * LD + tq;
  const float* br = b + gr * LD + tq;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D / 8; k0 += 4) {
    float d[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
    for (int kc = k0; kc < k0 + 4; ++kc) {
      uint32_t ah[4], al[4];
      const float av[4] = {ar[8 * kc], ar[8 * LD + 8 * kc], ar[8 * kc + 4],
                           ar[8 * LD + 8 * kc + 4]};
      split4(av, ah, al);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma3_tf32(d[n], ah, al, br[n * 8 * LD + 8 * kc],
                  br[n * 8 * LD + 8 * kc + 4]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += d[n][e];
  }
}

// acc[NC] (16 x 8 NC) += A B in split TF32, A the 16 x 8 KS accumulator
// c as it stands: k-position t of k-step kk is c's column 2t of n-tile
// kk and t + 4 its column 2t + 1, so B's fragment loads rows 8 kk + 2t and
// 8 kk + 2t + 1 of b (row stride LD, n-contiguous; columns from b's own
// column 0).  Four n-tiles at a time go to a fresh accumulator over the KS
// k-steps (3 KS truncating adds) that f32 adds put into acc.
template <int KS, int NC, int LD>
__device__ __forceinline__ void mma_ab_tf32(float (&acc)[NC][4],
                                            const float (&c)[KS][4],
                                            const float* b) {
  constexpr int NG = 4;
  static_assert(NC % NG == 0, "n-tiles in groups of four");
  const int lane = threadIdx.x & 31, gr = lane >> 2, tq = lane & 3;
  const float* br = b + 2 * tq * LD + gr;
#pragma unroll
  for (int n0 = 0; n0 < NC; n0 += NG) {
    float d[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ah[4], al[4];
      const float av[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
      split4(av, ah, al);
      const float* vb = br + 8 * kk * LD + 8 * n0;
#pragma unroll
      for (int j = 0; j < NG; ++j)
        mma3_tf32(d[j], ah, al, vb[8 * j], vb[LD + 8 * j]);
    }
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + j][e] += d[j][e];
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) fa_bwd_dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int KH, int hd, float scale, int causal, int window) {
  constexpr int BM = C::BM, BS = C::BS, LD = C::LD, DC = C::DC;
  constexpr int SUB = C::SUB;
  constexpr int NS = SUB / 8;  // n-tiles of S^T and dP^T a pass
  constexpr int NA = DC / 8;   // n-tiles of dK and dV
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BM * LD;
  float* sQ = sV + BM * LD;       // stage s: Q at sQ + 2 s BS LD, then dO
  float* sLD = sQ + 4 * BS * LD;  // stage s: lse, delta
  const int g = H / KH, kh = blockIdx.y / C::NSPLIT, b = blockIdx.z;
  const int dc0 = (blockIdx.y % C::NSPLIT) * DC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * BM, shift = Sk - Sq, jw = j0 + 16 * warp;
  load_rows_f32<C>(sK, k + (((size_t)b * Sk + j0) * KH + kh) * hd,
                   (size_t)KH * hd, BM, Sk - j0, hd);
  load_rows_f32<C>(sV, v + (((size_t)b * Sk + j0) * KH + kh) * hd,
                   (size_t)KH * hd, BM, Sk - j0, hd);
  cp_async_commit();
  // the query tiles whose rows can see a key of this tile
  int i_lo = 0, i_hi = Sq;
  if (causal) i_lo = max(0, j0 - shift);
  if (window > 0) i_hi = min(Sq, j0 + BM - 1 + window - shift);
  const int t_lo = i_lo / BS;
  const int n_t = i_hi > i_lo ? (i_hi + BS - 1) / BS - t_lo : 0;
  const int steps = g * n_t;  // (head, query tile), heads outer
  auto issue = [&](int s) {
    const int h = kh * g + s / n_t, i0 = (t_lo + s % n_t) * BS;
    float* tQ = sQ + (s & 1) * 2 * BS * LD;
    const size_t off = (((size_t)b * Sq + i0) * H + h) * hd;
    load_rows_f32<C>(tQ, q + off, (size_t)H * hd, BS, Sq - i0, hd);
    load_rows_f32<C>(tQ + BS * LD, dout + off, (size_t)H * hd, BS, Sq - i0,
                     hd);
    if (tid < BS) {
      const size_t row = ((size_t)b * H + h) * Sq + i0 + tid;
      float* tl = sLD + (s & 1) * 2 * BS;
      cp_async4(tl + tid, lse + row, i0 + tid < Sq);
      cp_async4(tl + BS + tid, delta + row, i0 + tid < Sq);
    }
    cp_async_commit();
  };
  const float sl2 = scale * LOG2E;
  float accK[NA][4], accV[NA][4];
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[n][e] = accV[n][e] = 0.f;

  if (steps > 0) issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the stage's query rows in passes of SUB, from row i0 + r0
#pragma unroll 1
    for (int r0 = 0; r0 < BS; r0 += SUB) {
      const int i0 = (t_lo + s % n_t) * BS + r0;
      const float* tQ = sQ + (s & 1) * 2 * BS * LD + r0 * LD;
      const float* tO = tQ + BS * LD;
      const float* tl = sLD + (s & 1) * 2 * BS + r0;
      const float* td = tl + BS;
      const bool dead = jw >= Sk || i0 >= Sq ||
                        (causal && i0 + SUB - 1 + shift < jw) ||
                        (window > 0 && i0 + shift - (jw + 15) >= window);
      if (dead) continue;
      const bool full = i0 + SUB <= Sq && jw + 16 <= Sk &&
                        (!causal || jw + 15 <= i0 + shift) &&
                        (window <= 0 || i0 + SUB - 1 + shift - jw < window);
      // P^T = exp(scale K Q^T - lse), keys as rows
      float p[NS][4];
      mma_abt_tf32<NS, C::D, LD>(p, sK + 16 * warp * LD, tQ);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * tq + (e & 1);
          const int j = jw + gr + (e >> 1) * 8;
          float x = exp2f(fmaf(p[n][e], sl2, -tl[ql] * LOG2E));
          if (!full && !(i0 + ql < Sq &&
                         visible(i0 + ql + shift, j, Sk, causal, window)))
            x = 0.f;
          p[n][e] = x;
        }
      }
      mma_ab_tf32<NS, NA, LD>(accV, p, tO + dc0);  // dV += P^T dO
      // dS^T = P^T (V dO^T - delta)
      float ds[NS][4];
      mma_abt_tf32<NS, C::D, LD>(ds, sV + 16 * warp * LD, tO);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - td[n * 8 + 2 * tq + (e & 1)]);
      mma_ab_tf32<NS, NA, LD>(accK, ds, tQ + dc0);  // dK += dS^T Q
    }
    __syncthreads();  // the stage is refilled two steps on
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NA; ++n) {
    const int c = dc0 + n * 8 + 2 * tq;
    if (c >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = jw + gr + 8 * half;
      if (j >= Sk) continue;
      const size_t at = (((size_t)b * Sk + j) * KH + kh) * hd + c;
      *reinterpret_cast<float2*>(dk + at) = make_float2(
          accK[n][2 * half] * scale, accK[n][2 * half + 1] * scale);
      *reinterpret_cast<float2*>(dv + at) =
          make_float2(accV[n][2 * half], accV[n][2 * half + 1]);
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) fa_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int H, int KH, int hd,
    float scale, int causal, int window) {
  constexpr int BM = C::BM, BS = C::BS, LD = C::LD;
  constexpr int NS = BS / 8;    // n-tiles of S and dP
  constexpr int NQ = C::D / 8;  // n-tiles of dQ
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BM * LD;   // dO
  float* sKV = sO + BM * LD;  // stage s: K at sKV + 2 s BS LD, then V
  const int g = H / KH, h = blockIdx.y, kh = h / g, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  // query tiles last to first: under the causal mask the last see the most
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BM, shift = Sk - Sq;
  const int nq = min(BM, Sq - i0), iw = i0 + 16 * warp;
  const size_t qoff = (((size_t)b * Sq + i0) * H + h) * hd;
  load_rows_f32<C>(sQ, q + qoff, (size_t)H * hd, BM, nq, hd);
  load_rows_f32<C>(sO, dout + qoff, (size_t)H * hd, BM, nq, hd);
  cp_async_commit();
  float lrow[2], drow[2];  // rows iw + gr and iw + gr + 8
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = iw + gr + 8 * e;
    const size_t row = ((size_t)b * H + h) * Sq + i;
    lrow[e] = i < Sq ? lse[row] * LOG2E : 0.f;
    drow[e] = i < Sq ? delta[row] : 0.f;
  }
  // the key tiles these rows can see
  int j_lo = 0, j_hi = Sk;
  if (causal) j_hi = min(Sk, max(0, i0 + nq + shift));
  if (window > 0) j_lo = max(0, i0 + shift - window + 1);
  const int t_lo = j_lo / BS;
  const int n_t = j_hi > j_lo ? (j_hi + BS - 1) / BS - t_lo : 0;
  auto issue = [&](int s) {
    const int j0 = (t_lo + s) * BS;
    float* tK = sKV + (s & 1) * 2 * BS * LD;
    const size_t off = (((size_t)b * Sk + j0) * KH + kh) * hd;
    load_rows_f32<C>(tK, k + off, (size_t)KH * hd, BS, Sk - j0, hd);
    load_rows_f32<C>(tK + BS * LD, v + off, (size_t)KH * hd, BS, Sk - j0,
                     hd);
    cp_async_commit();
  };
  const float sl2 = scale * LOG2E;
  float acc[NQ][4];
#pragma unroll
  for (int n = 0; n < NQ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (n_t > 0) issue(0);
  for (int s = 0; s < n_t; ++s) {
    if (s + 1 < n_t) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = (t_lo + s) * BS;
    const float* tK = sKV + (s & 1) * 2 * BS * LD;
    const float* tV = tK + BS * LD;
    const bool dead = iw >= Sq || (causal && j0 > iw + 15 + shift) ||
                      (window > 0 && iw + shift - (j0 + BS - 1) >= window);
    if (!dead) {
      const bool full = iw + 16 <= Sq && j0 + BS <= Sk &&
                        (!causal || j0 + BS - 1 <= iw + shift) &&
                        (window <= 0 || iw + 15 + shift - j0 < window);
      float p[NS][4];
      mma_abt_tf32<NS, C::D, LD>(p, sQ + 16 * warp * LD, tK);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + n * 8 + 2 * tq + (e & 1);
          const int i = iw + gr + (e >> 1) * 8;
          float x = exp2f(fmaf(p[n][e], sl2, -lrow[e >> 1]));
          if (!full && !(i < Sq && visible(i + shift, j, Sk, causal, window)))
            x = 0.f;
          p[n][e] = x;
        }
      }
      float ds[NS][4];
      mma_abt_tf32<NS, C::D, LD>(ds, sO + 16 * warp * LD, tV);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[n][e] = p[n][e] * (ds[n][e] - drow[e >> 1]);
      mma_ab_tf32<NS, NQ, LD>(acc, ds, tK);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int c = n * 8 + 2 * tq;
    if (c >= hd) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = iw + gr + 8 * half;
      if (i >= Sq) continue;
      *reinterpret_cast<float2*>(dq + (((size_t)b * Sq + i) * H + h) * hd +
                                 c) =
          make_float2(acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
  }
}

template <class C>
int launch_tf32(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int B, int Sq, int Sk, int H, int KH,
                int hd, float scale, int causal, int window, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_tf32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fa_bwd_dq_tf32_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * Sq * H;
  fa_bwd_pre_kernel<float><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                             THREADS, 0, st>>>((const float*)o,
                                               (const float*)dout, delta,
                                               rows, Sq, H, hd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dkdv_tf32_kernel<C><<<dim3((Sk + C::BM - 1) / C::BM,
                                    KH * C::NSPLIT, B),
                               C::THREADS, C::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, Sq, Sk, H, KH, hd, scale, causal,
      window);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fa_bwd_dq_tf32_kernel<C><<<dim3((Sq + C::BM - 1) / C::BM, H, B),
                             C::THREADS, C::SMEM, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dq, Sq, Sk, H, KH, hd, scale, causal, window);
  return (int)cudaGetLastError();
}

int launch_tf32_width(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int B,
                      int Sq, int Sk, int H, int KH, int hd, float scale,
                      int causal, int window, cudaStream_t st) {
  switch ((hd + 63) / 64) {  // padded to 64, 128, 192 or 256 columns
    case 1:
      return launch_tf32<Tf32_64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                                  Sq, Sk, H, KH, hd, scale, causal, window,
                                  st);
    case 2:
      return launch_tf32<Tf32_128>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Sk, H, KH, hd, scale, causal,
                                   window, st);
    case 3:
      return launch_tf32<Tf32_192>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Sk, H, KH, hd, scale, causal,
                                   window, st);
    default:
      return launch_tf32<Tf32_256>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                   B, Sq, Sk, H, KH, hd, scale, causal,
                                   window, st);
  }
}

bool bad_shape(int B, int Sq, int Sk, int H, int KH, int hd) {
  return hd % 8 != 0 || hd < 8 || hd > 256 || KH < 1 || H % KH != 0 ||
         B < 1 || Sq < 1 || Sk < 1;
}

}  // namespace

extern "C" {

// q, o, dout, dq (B,Sq,H,hd) and k, v, dk, dv (B,Sk,KH,hd), contiguous;
// lse (B,H,Sq) f32 from the forward; delta (B,H,Sq) f32 scratch.  hd a
// multiple of 8 up to 256, H % KH == 0.  Three launches on the stream;
// each returns the first cudaError_t (0 on success).
// bf16 tensors, on the tensor cores; every tensor 16-byte aligned
int flash_attention_bwd_bf16_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    float* delta, void* dq, void* dk,
                                    void* dv, int B, int Sq, int Sk, int H,
                                    int KH, int hd, float scale, int causal,
                                    int window, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH, hd)) return (int)cudaErrorInvalidValue;
  return launch_mma_width(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                          Sk, H, KH, hd, scale, causal, window,
                          (cudaStream_t)stream);
}

// f32 tensors, on the tensor cores in split TF32; every tensor 16-byte
// aligned
int flash_attention_bwd_tf32_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const float* lse,
                                    float* delta, void* dq, void* dk,
                                    void* dv, int B, int Sq, int Sk, int H,
                                    int KH, int hd, float scale, int causal,
                                    int window, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH, hd)) return (int)cudaErrorInvalidValue;
  return launch_tf32_width(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                           Sk, H, KH, hd, scale, causal, window,
                           (cudaStream_t)stream);
}

// f32 tensors, on the CUDA cores: the referee, which no input is routed to
int flash_attention_bwd_f32_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KH,
                                   int hd, float scale, int causal,
                                   int window, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KH, hd)) return (int)cudaErrorInvalidValue;
  return launch_width<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq,
                             Sk, H, KH, hd, scale, causal, window,
                             (cudaStream_t)stream);
}

const char* fab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
