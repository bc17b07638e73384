// Forward attention with an f32 online softmax for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::_flash_kernel (K6, via
//   flash_attention and ops.flash_attention_op)
// with flash_fwd_kernel for f32 inputs and for bf16 with hd in (128, 256];
// bf16 with hd <= 128 (Zamba2-7B's 112) goes to flash_fwd_wgmma_kernel
// (flash_attention_wgmma.cu), on the tensor cores.  The wrapper (kernel.py)
// picks the kernel from the dtype and hd alone.
// One block per (q tile, kv head, batch row): the
// tile is FQ = 64 "folded" rows f = qi * g + gi — query position qi of
// each of the g heads that share kv head kh (GQA) — as the TPU kernel
// folds the group into its q block.  The block streams K/V in tiles of
// FK = 64 keys through shared memory and keeps, per row, the running max
// m, the denominator l and the (hd) accumulator in f32, as the TPU kernel
// does: q·k and p·v both run in f32 (p is not rounded to v's dtype).
//
// Design, against what the TPU kernel assumes:
// - Ragged lengths: the TPU kernel asserts Sq % blk_q == 0 and
//   Sk % blk_k == 0.  Here the last q tile and the last K/V tile are
//   masked (rows f >= g*Sq are not written, keys kj >= Sk get NEG), so any
//   length works.
// - The q offset: query position is qi + (Sk - Sq), so a short query block
//   sits at the end of a longer K/V (prefill tail).
// - Masks: causal kj <= pos and, where window > 0, pos - kj < window; a
//   masked logit is NEG = -1e30, as in the JAX code.  K/V tiles wholly
//   above the diagonal of the q tile are skipped.
// - hd is a run-time value up to 256 (112 at Zamba2-7B, 256 at gemma);
//   the kernel is instantiated for hd <= 64, 128 and 256, and the
//   wrapper refuses hd > 256 (222 KB of shared memory at 256).
// - The denominator is max(l, 1e-30), as in the JAX code.
// - Plain f32 FMAs on the CUDA cores and expf without fast-math.
//
// Work split: thread (rg, cg) of 16 x 16 owns rows 4rg..4rg+3 of the tile,
// their scores against keys 4cg..4cg+3 of a K tile (a 4 x 4 register
// tile fed by two 16-byte loads of the transposed Q and K per head-dim
// step) and their output columns cg, cg + 16, ... (p read as 16 bytes of
// the transposed P per key).  A row group's 16 threads are one half-warp,
// so the row max and sum are shuffles and P needs no block barrier.
//
// What bounds it: at the Zamba2-7B serving shape (B = 4, Sq = Sk = 2048,
// 32 heads, hd = 112, causal) the two products are ~120 GFLOP of the
// tensor cores' kind, 0.12 ms at 989 TFLOP/s bf16, over 235 MB of q, k,
// v and o (0.07 ms at 3.35 TB/s): operations.  This version runs them on
// the CUDA cores in f32 (at most 67 TFLOP/s, 1.8 ms), so it sits far above
// that bound.  Moving these routes to the tensor cores (TF32 or split bf16
// for f32, wider tiles for hd > 128) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FQ = 64;           // folded rows per block
constexpr int FK = 64;           // keys per K/V tile
constexpr int FA_THREADS = 256;  // 16 row groups x 16 key/column groups
constexpr int LDT = FQ + 4;      // rows of the transposed Q, K and P
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

size_t fa_smem_bytes(int hd) {
  return sizeof(float) * (2 * (size_t)hd * LDT + (size_t)FK * hd +
                          (size_t)FK * LDT);
}

// Thread (rg, cg) = (tid / 16, tid % 16) owns rows 4rg..4rg+3 of the tile:
// their scores against keys 4cg..4cg+3 and their output columns
// cg, cg + 16, ...; a row group's 16 threads are one half-warp.
// DPT >= ceil(hd / 16): output columns per thread.
template <typename T, int DPT>
__global__ void __launch_bounds__(FA_THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
    int KH, int hd, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* sQt = reinterpret_cast<float*>(smem4);  // hd x LDT, pre-scaled
  float* sKt = sQt + hd * LDT;                    // hd x LDT
  float* sV = sKt + hd * LDT;                     // FK x hd
  float* sPt = sV + FK * hd;                      // FK x LDT: p[r][j] at [j][r]

  const int g = H / KH;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int R = g * Sq;  // folded rows f = qi * g + gi of (b, kh)
  const int row0 = blockIdx.x * FQ;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 4) * 4;  // the thread's first row
  const int cg = tid & 15;
  const int j0 = cg * 4;  // its first key of a tile
  const int shift = Sk - Sq;

  for (int i = tid; i < FQ * hd; i += FA_THREADS) {
    const int rr = i / hd, d = i % hd, f = row0 + rr;
    float val = 0.f;
    if (f < R)
      val = to_f32(q[(((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd +
                     d]) *
            scale;
    sQt[d * LDT + rr] = val;
  }
  int pos[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = row0 + r0 + r;
    pos[r] = (f < R ? f / g : 0) + shift;
  }
  const int last_pos = (min(row0 + FQ, R) - 1) / g + shift;
  int n_tiles = (Sk + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, last_pos < 0 ? 0 : last_pos / FK + 1);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int u = 0; u < DPT; ++u) acc[r][u] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * FK;
    __syncthreads();  // Q is in; the last tile's K/V/P reads are done
    for (int i = tid; i < FK * hd; i += FA_THREADS) {
      const int j = i / hd, d = i % hd, kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        const size_t off = (((size_t)b * Sk + kj) * KH + kh) * hd + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sKt[d * LDT + j] = kv;
      sV[i] = vv;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
      ld4(sQt + d * LDT + r0, qv);
      ld4(sKt + d * LDT + j0, kv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float tmax = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + j0 + c;
        bool live = kj < Sk;
        if (causal) live = live && kj <= pos[r];
        if (window > 0) live = live && pos[r] - kj < window;
        s[r][c] = live ? s[r][c] : NEG;
        tmax = fmaxf(tmax, s[r][c]);
      }
      // the row group's 16 threads are lanes of one half-warp
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, w));
      const float m_new = fmaxf(m[r], tmax);
      const float alpha = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        psum += s[r][c];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, w);
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int u = 0; u < DPT; ++u) acc[r][u] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(sPt + (j0 + c) * LDT + r0) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncwarp();  // a row group's p, written by its half-warp, is read by it
#pragma unroll 2
    for (int j = 0; j < FK; ++j) {
      float pv[4];
      ld4(sPt + j * LDT + r0, pv);
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        const int d = cg + 16 * u;
        if (d < hd) {
          const float vv = sV[j * hd + d];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][u] += pv[r] * vv;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int f = row0 + r0 + r;
    if (f < R) {
      const float den = fmaxf(l[r], 1e-30f);
      T* orow = o + (((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd;
#pragma unroll
      for (int u = 0; u < DPT; ++u) {
        const int d = cg + 16 * u;
        if (d < hd) orow[d] = from_f32<T>(acc[r][u] / den);
      }
    }
  }
}

template <typename T, int DPT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int g = H / KH;
  const dim3 grid((g * Sq + FQ - 1) / FQ, KH, B);
  flash_fwd_kernel<T, DPT><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, hd, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KH, int hd, float scale, int causal,
              int window, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal,
                        window, stream);
  if (hd <= 128)
    return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal,
                        window, stream);
  return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal,
                       window, stream);
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Sk,KH,hd) and o (B,Sq,H,hd), contiguous, all f32
// (bf16 = 0) or all bf16 (bf16 = 1); hd <= 256, H % KH == 0.  Returns the
// launch's cudaError_t (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int bf16, int B, int Sq, int Sk, int H,
                           int KH, int hd, float scale, int causal,
                           int window, void* stream) {
  if (bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale,
                                    causal, window, (cudaStream_t)stream);
  return launch_hd<float>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal,
                          window, (cudaStream_t)stream);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
