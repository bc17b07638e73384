// Forward attention in f32 on Hopper's tensor cores (sm_90a), split TF32.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::_flash_kernel (K6, via
//   flash_attention and ops.flash_attention_op)
// with flash_fwd_tf32_kernel for f32 q, k, v (hd a multiple of 8 up to
// 256); bf16 goes to flash_fwd_wgmma_kernel (flash_attention_wgmma.cu).
// The wrapper (kernel.py) picks the kernel from the dtype alone.  It
// computes what the Pallas kernel computes: both products of f32 values,
// the online-softmax state (running max m, denominator l, accumulator) in
// f32, NEG = -1e30 for a masked logit, causal and window masks, query i
// at position i + Sk - Sq, the denominator max(l, 1e-30).
// flash_fwd_kernel (flash_attention.cu), which runs the same function as
// f32 FMAs on the CUDA cores, is kept as the f32 referee of the checks.
//
// What bounds it: at the Zamba2-7B shape in f32 (B = 4, Sq = Sk = 2048,
// 32 heads, hd = 112, causal) the two products are 120.3 GFLOP.  As f32
// FMAs on the CUDA cores they take 1.80 ms at 67 TFLOP/s; here each runs
// as three TF32 products, 361 GFLOP, 0.73 ms at the tensor cores' 495
// TFLOP/s, over 470 MB of q, k, v and o (0.14 ms at 3.35 TB/s):
// operations.
//
// Split TF32, the form of the SSD scan (ssd.cu): an f32 operand
// a = hi + lo with hi = a cut to TF32 (the tensor cores read a .tf32
// operand's top 19 bits, so hi is a's own bits) and lo = a - hi, and a
// product lo*hi + hi*lo + hi*hi (lo*lo and lo's own cut, ~2^-20
// relative, are dropped): the f32 contract, which one TF32 product (10
// mantissa bits) would not keep.  p is split the same way before p V.
// The tensor cores add into their accumulator with truncation at its
// magnitude, so no accumulator takes many of their adds: S goes to a
// fresh one every four k-steps (12 adds) and O, in groups of NG n-tiles,
// to a fresh one every tile of keys (3 FK / 8 adds); f32 adds sum those.
//
// Products on mma.sync.m16n8k8 (TF32), with fragments loaded by the
// threads from shared memory, not wgmma:
// - wgmma reads a TF32 operand from shared memory only K-major (there is
//   no transpose bit for TF32), and V (B, Sk, KH, hd) is MN-major for
//   p V.  The other two ways cost more than they save at this slice: a
//   pre-pass that writes V^T (a second kernel and a V-sized scratch), or
//   a transpose through shared memory; and wgmma also reads its operands
//   as stored, so hi and lo of K and V^T would each need their own copy in
//   shared memory, twice the f32 tiles.  Thread-loaded fragments split
//   each value in registers as they are loaded (an AND and a
//   subtraction), with K and V tiles in shared memory as they came.
// - The S accumulator fragment is not the TF32 A fragment: a thread holds
//   S at keys (2t, 2t + 1) of each 8-key group, rows g and g + 8, where the
//   k8 A fragment wants k-positions (t, t + 4).  The sum over keys is
//   order-free, so k-position t stands for key 2t and t + 4 for key
//   2t + 1, and the thread loads V's B fragment from keys 2t and 2t + 1
//   to match: p never leaves registers.  A card test on a V whose keys are
//   all distinct pins this (tests/test_torch_cuda.py).
//
// Layout: a block takes BM = 16 x WARPS folded rows f = qi * g + gi of one
// (kv head, batch row), 16 rows a warp (the mma's M), as the TPU kernel
// folds the GQA group into its q block; blocks are issued longest first.
// Q stays in shared memory for the block's life; K and V tiles of FK keys
// arrive by cp.async in two stages, the next tile's copies in flight while
// this one is used.  Rows are padded to LD = D + 4 floats (LD = 4 mod 32),
// so every fragment load of Q, K and V hits 32 distinct banks.  Keys past
// Sk are stored as zeros; columns past hd are never read.  Each instance
// static_asserts its shared memory:
//   D = 64:  8 warps, FK = 64: Q 34.8 KB + 2 x (K, V) 69.6 KB
//   D = 128: 8 warps, FK = 64: Q 67.6 KB + 2 x (K, V) 135.2 KB = 202.8 KB
//   D = 256: 4 warps, FK = 32: Q 66.6 KB + 2 x (K, V) 133.1 KB = 199.7 KB
// Registers: the O accumulator is D / 2 a thread (128 at D = 256), S
// FK / 2 and p's split FK; at most 255 with one block an SM.  A p V pass
// keeps NG n-tiles' accumulators apart (8, or 4 at D = 256), so NG
// independent mma chains are in flight and no branch sits between them.  Only tiles that cross the end
// of K, a warp's diagonal or a window evaluate the masks, and K/V tiles
// wholly above a block's diagonal are never loaded (a warp skips those
// above its own).  exp2f on logits scaled by scale * log2(e); no fast
// math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
// a block may use 232,448 bytes of dynamic shared memory on sm_90
constexpr int SMEM_LIMIT = 232448;

template <int D_, int WARPS_, int FK_, int NG_>
struct Cfg {
  static constexpr int D = D_;          // padded head dim (O columns)
  static constexpr int WARPS = WARPS_;  // 16 folded rows a warp
  static constexpr int BM = 16 * WARPS;
  static constexpr int FK = FK_;  // keys per K/V tile
  static constexpr int NG = NG_;  // O n-tiles a pass of p V keeps apart
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 4;  // floats a row: LD = 4 mod 32
  static constexpr int Q_FLOATS = BM * LD;
  static constexpr int KV_FLOATS = FK * LD;  // K or V of one stage
  static constexpr int STAGES = 2;
  static constexpr int SMEM = 4 * (Q_FLOATS + 2 * STAGES * KV_FLOATS);
};

using Cfg64 = Cfg<64, 8, 64, 8>;
using Cfg128 = Cfg<128, 8, 64, 8>;
using Cfg256 = Cfg<256, 4, 32, 4>;
static_assert(Cfg64::SMEM <= SMEM_LIMIT, "D = 64: shared memory");
static_assert(Cfg128::SMEM <= SMEM_LIMIT, "D = 128: shared memory");
static_assert(Cfg256::SMEM <= SMEM_LIMIT, "D = 256: shared memory");

// v = hi + lo in TF32: the tensor cores read a .tf32 operand's top 19
// bits, so v's own bits are hi = v cut to 10 mantissa bits, and
// lo = v - hi (exact, |lo| < 2^-10 |v|) is cut the same way there: two
// instructions a value, ~2^-20 |v| lost
__device__ __forceinline__ uint32_t lo_tf32(float v) {
  return __float_as_uint(v - __uint_as_float(__float_as_uint(v) & 0xffffe000u));
}

// d = a b + d, m16n8k8, TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    hi[k] = __float_as_uint(v[k]);
    lo[k] = lo_tf32(v[k]);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4,
// n g); C c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, int hd,
    float scale, int causal, int window) {
  constexpr int FK = C::FK;
  constexpr int LD = C::LD;
  constexpr int NS = FK / 8;     // n-tiles of S: 8 keys each
  constexpr int NO = C::D / 8;   // n-tiles of O: 8 columns each
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + C::Q_FLOATS;  // stage s: K, then V

  const int g = H / KH;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int R = g * Sq;  // folded rows of (b, kh)
  const int row0 = (gridDim.x - 1 - blockIdx.x) * C::BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int shift = Sk - Sq;
  const int last_pos = (min(row0 + C::BM, R) - 1) / g + shift;
  int n_tiles = (Sk + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, last_pos < 0 ? 0 : last_pos / FK + 1);
  const int chunks = hd / 4;  // 16-byte pieces of a row
  const int hd8 = hd / 8;     // k-steps of S, live n-tiles of O

  // K and V of tile t into stage t % 2 (zeros past Sk), one commit group
  auto load = [&](int t) {
    float* sK = sKV + (t % C::STAGES) * 2 * C::KV_FLOATS;
    float* sV = sK + C::KV_FLOATS;
    const int k0 = t * FK;
    for (int i = tid; i < FK * chunks; i += C::THREADS) {
      const int j = i / chunks;
      const int c4 = (i % chunks) * 4;
      if (k0 + j < Sk) {
        const size_t off = (((size_t)b * Sk + k0 + j) * KH + kh) * hd + c4;
        cp_async16(sK + j * LD + c4, k + off);
        cp_async16(sV + j * LD + c4, v + off);
      } else {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(sK + j * LD + c4) = z;
        *reinterpret_cast<float4*>(sV + j * LD + c4) = z;
      }
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load(0);

  // Q rows of the block (zeros past R)
  for (int i = tid; i < C::BM * chunks; i += C::THREADS) {
    const int r = i / chunks;
    const int c4 = (i % chunks) * 4;
    const int f = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < R)
      val = *reinterpret_cast<const float4*>(
          q + (((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd + c4);
    *reinterpret_cast<float4*>(sQ + r * LD + c4) = val;
  }

  const int wrow0 = row0 + warp * 16;  // this warp's first row
  const bool w_live = wrow0 < R;
  const int w_last_pos = (min(wrow0 + 16, R) - 1) / g + shift;
  const int w_first_pos = wrow0 / g + shift;
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = wrow0 + gq + 8 * i;
    pos[i] = (f < R ? f / g : 0) + shift;
  }
  // logits in base 2: exp(x * scale - m) = exp2(x * scale * log2(e) - m')
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* qa = sQ + (warp * 16 + gq) * LD + tq;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const int k0 = t * FK;
    if (w_live && !(causal && k0 > w_last_pos)) {
      const float* sK = sKV + (t % C::STAGES) * 2 * C::KV_FLOATS;
      const float* sV = sK + C::KV_FLOATS;
      // S = Q K^T over hd / 8 k-steps, four at a time into a fresh
      // accumulator (12 truncating adds, ~1.4e-6 |S| at most) that f32 adds
      // put into S
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const float* kb = sK + gq * LD + tq;
      for (int kc0 = 0; kc0 < hd8; kc0 += 4) {
        float d[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
        for (int kc = kc0; kc < kc0 + 4; ++kc) {
          if (kc < hd8) {
            uint32_t ah[4], al[4];
            const float av[4] = {qa[8 * kc], qa[8 * LD + 8 * kc],
                                 qa[8 * kc + 4], qa[8 * LD + 8 * kc + 4]};
            split4(av, ah, al);
            uint32_t bh0[NS], bl0[NS], bh1[NS], bl1[NS];
#pragma unroll
            for (int n = 0; n < NS; ++n) {
              const float b0 = kb[n * 8 * LD + 8 * kc];
              const float b1 = kb[n * 8 * LD + 8 * kc + 4];
              bh0[n] = __float_as_uint(b0);
              bl0[n] = lo_tf32(b0);
              bh1[n] = __float_as_uint(b1);
              bl1[n] = lo_tf32(b1);
            }
#pragma unroll
            for (int n = 0; n < NS; ++n) mma_tf32(d[n], al, bh0[n], bh1[n]);
#pragma unroll
            for (int n = 0; n < NS; ++n) mma_tf32(d[n], ah, bl0[n], bl1[n]);
#pragma unroll
            for (int n = 0; n < NS; ++n) mma_tf32(d[n], ah, bh0[n], bh1[n]);
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[n][c] += d[n][c];
        }
      }

      // online softmax on the fragment: rows gq (i = 0) and gq + 8 (i = 1)
      const bool masked = k0 + FK > Sk || window > 0 ||
                          (causal && k0 + FK - 1 > w_first_pos);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = NEG;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[n][2 * i + c];
            if (masked) {
              const int kj = k0 + 8 * n + 2 * tq + c;
              bool live = kj < Sk;
              if (causal) live = live && kj <= pos[i];
              if (window > 0) live = live && pos[i] - kj < window;
              x = live ? x * scale_log2 : NEG;
            } else {
              x *= scale_log2;
            }
            tmax = fmaxf(tmax, x);
          }
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[i], tmax);
        const float alpha = exp2f(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[n][2 * i + c];
            x = exp2f(x - m_new);
            psum += x;
          }
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
      }

      // O += p V, 8 keys a k-step: k-position t is key 2t and t + 4 is key
      // 2t + 1, in p's A fragment (from S's accumulator) and V's B
      // fragment.  NG n-tiles of O at a time, over the tile's keys into a
      // fresh accumulator (3 FK / 8 truncating adds) that f32 adds put
      // into O; groups wholly past hd are skipped
      uint32_t ph[NS][4], pl[NS][4];
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float pa[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
        split4(pa, ph[kk], pl[kk]);
      }
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += C::NG) {
        if (8 * n0 < hd) {
          float d[C::NG][4];
#pragma unroll
          for (int j = 0; j < C::NG; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < NS; ++kk) {
            const float* vb = sV + (8 * kk + 2 * tq) * LD + 8 * n0 + gq;
            uint32_t bh0[C::NG], bl0[C::NG], bh1[C::NG], bl1[C::NG];
#pragma unroll
            for (int j = 0; j < C::NG; ++j) {
              const float b0 = vb[8 * j];
              const float b1 = vb[LD + 8 * j];
              bh0[j] = __float_as_uint(b0);
              bl0[j] = lo_tf32(b0);
              bh1[j] = __float_as_uint(b1);
              bl1[j] = lo_tf32(b1);
            }
#pragma unroll
            for (int j = 0; j < C::NG; ++j) mma_tf32(d[j], pl[kk], bh0[j], bh1[j]);
#pragma unroll
            for (int j = 0; j < C::NG; ++j) mma_tf32(d[j], ph[kk], bl0[j], bl1[j]);
#pragma unroll
            for (int j = 0; j < C::NG; ++j) mma_tf32(d[j], ph[kk], bh0[j], bh1[j]);
          }
#pragma unroll
          for (int j = 0; j < C::NG; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[n0 + j][c] += d[j][c];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before a refill
  }

  // normalise and write rows f < R, columns < hd: two floats a store
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int f = wrow0 + gq + 8 * i;
    if (lse != nullptr && tq == 0 && f < R)  // natural log: m is base 2
      lse[((size_t)b * H + kh * g + f % g) * Sq + f / g] =
          (m[i] + log2f(den)) * 0.6931471805599453f;
    if (f < R) {
      float* orow = o + (((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        if (n < hd8)
          *reinterpret_cast<float2*>(orow + 8 * n + 2 * tq) =
              make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
      }
    }
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KH, int hd, float scale,
           int causal, int window, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((H / KH * Sq + C::BM - 1) / C::BM, KH, B);
  flash_fwd_tf32_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Sk, H, KH, hd, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Sk,KH,hd) and o (B,Sq,H,hd), contiguous f32, each
// 16-byte aligned; hd a multiple of 8 up to 256, H % KH == 0.  lse, when
// not null, gets each row's log-sum-exp of the scaled logits (B,H,Sq) for
// the backward; o is the same either way.  Returns the launch's
// cudaError_t (0 on success).
int flash_attention_tf32_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int B, int Sq, int Sk,
                                int H, int KH, int hd, float scale,
                                int causal, int window, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (hd <= 64)
    return launch<Cfg64>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                          causal, window, st);
  if (hd <= 128)
    return launch<Cfg128>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                          causal, window, st);
  return launch<Cfg256>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                          causal, window, st);
}

const char* fat_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
