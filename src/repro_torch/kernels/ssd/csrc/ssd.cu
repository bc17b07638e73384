// Mamba2 SSD chunked scan (train/prefill) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/ssd/kernel.py::_ssd_kernel (K7, via ssd_scan and ops.ssd_op).
// Per chunk of Q steps and head h, all in f32 (as the TPU kernel and
// models/ssm.py::ssd_chunked):
//   cum   = cumsum(dt * A_h)                              (Q)
//   S_c   = B^T (exp(cum_last - cum) * dt * x)            (N x P)
//   state = exp(cum_last) * state + S_c, over the chunks  (N x P)
//   y     = (C B^T * exp(cum_i - cum_j) * dt_j, i >= j) x
//           + exp(cum) * (C state_before)                 (Q x P)
// and the state after the last chunk is the final state.
//
// Design: Mamba2's own chunked decomposition (Dao & Gu, "Transformers are
// SSMs", section 6), three kernels behind the one entry point
// ssd_scan_launch, launched back to back on the caller's stream:
// 1. ssd_state_kernel, one block per (b, chunk, 4 heads): the chunk's B
//    in shared memory once; per head cum by a warp-shuffle scan in f64,
//    w = exp(cum_last - cum) * dt, and the chunk state S_c = (B^T w) x
//    (w scales the A operand); it writes S_c and cum, as f32 (hi, lo)
//    pairs, to two scratch tensors the wrapper allocates (B*H*chunks*N*P
//    and B*H*chunks*Qp*2 f32).
// 2. ssd_pass_kernel, one thread per 4 state elements of one (b, h): the
//    short serial recurrence over the chunks, elementwise over N x P, the
//    next chunk's loads issued before this one's store.  It overwrites
//    each S_c with the state that chunk starts from and writes the final
//    state.
// 3. ssd_output_kernel, one block per (b, chunk, 16 heads): G = C B^T on
//    and below the diagonal, formed ONCE per (b, chunk) for the group (B
//    and C are per batch row: n_groups = 1), held in registers, and reused
//    for every head of the group; then per head
//    y = (G * exp(cum_i - cum_j) * dt_j) x + exp(cum_i) (C state).
// The TPU kernel ran the chunk axis in order on one core; here the chunks
// of every (b, h) run in parallel and only the N x P recurrence is serial.
//
// Products run on the tensor cores, mma.sync.m16n8k8 in TF32 in split
// form: each f32 operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi),
// and lo*hi + hi*lo + hi*hi accumulated in f32 (lo*lo and the cut of lo,
// ~2^-21 relative, are dropped).  That keeps the f32 contract, which one
// TF32 product (10 mantissa bits) would not.  The tensor cores add into
// their accumulator with truncation at its magnitude, so each k-step's
// three passes go to a fresh accumulator and f32 adds sum the k-steps.
// Each product issues its three passes over eight independent n-tiles, so
// no pass waits on the one before.  Each warp of the output kernel owns
// two 16-row tiles of the chunk, r and Qp/16 - 1 - r, so the triangle's
// work is even over the warps; G's accumulator fragments become the A
// operand of the next product directly, with the reduction index permuted
// the same way in the B operand (x rows j0 + 2t, j0 + 2t + 1), so G never
// goes through shared memory.  Q <= 128 (G is 18 fragments a warp); the
// wrapper refuses longer chunks.
// - Besides that accumulation, cum bounds the accuracy: it reaches hundreds
//   at Q = 128, where one f32 unit in the last place is ~3e-5, and
//   exp(cum_i - cum_j) turns an error in the exponent into a relative
//   error of y.  A scan in f32 (a tree of sums) rounds cum_i and cum_j
//   apart, and even correctly rounded f32 values lose that much in their
//   difference.  So the scan runs in f64, w takes its exponent from the
//   f64 values, and the output kernel gets cum as (hi, lo) pairs whose
//   difference is good to f32 relative to itself (cum_diff).  With the
//   fresh accumulators above, the kernel lands several times closer to an
//   f64 run of the plain version than the f32 plain version does.
// - exp(cum_i - cum_j) overflows for i < j (cum falls with j); JAX discards
//   it with a where, and here too the value is selected, never multiplied
//   by a 0 mask, so no inf * 0 appears.
// - x, dt, B and C are read in the model's (B, S, H, P) / (B, S, H) /
//   (B, S, N) layouts through their strides (innermost stride 1), so the
//   caller neither transposes nor copies its split of the conv output.
//   Tiles go to shared memory by cp.async (16-byte copies where a view's
//   base and strides allow, else 4-byte ones), 64 columns at a time with
//   rows padded to conflict-free strides; N and P of any multiple of 4 run
//   in 64-wide slabs, so the output kernel's block takes 87 KB at Q = 128
//   whatever N and P, and the state kernel's 73 KB at N = 64 and 105 KB
//   at N = 128: two or three blocks an SM.
// - Steps past S, and the rows that round a chunk up to 16, are zeros with
//   dt = 0: exact no-ops, as the JAX padding; their y is not written.
//
// What bounds it (Zamba2-7B serving shape, B = 4, S = 2048, H = 112,
// P = N = 64, Q = 128): 22.7 GFLOP (C B^T counted once per (b, chunk)),
// three TF32 products each, 0.14 ms at the tensor cores' 495 TFLOP/s; the
// function's bytes (x, dt, B, C read and y, the state written once,
// ~0.48 GB) take 0.14 ms at 3.35 TB/s.  The design's own traffic is
// larger: x is read twice, and the chunk states (117 MB) are written,
// read and written, and read again.  mma.sync is Hopper's older tensor
// path and a warp issues it well below the card's TF32 peak; wgmma, with
// TMA-fed tiles, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SSD_THREADS = 128;   // four warps: state and output kernels
constexpr int STATE_HEADS = 4;     // heads per block of the state kernel
constexpr int OUT_HEADS = 16;      // and of the output kernel (G reused)
constexpr int Q_MAX = 128;         // longest chunk: G lives in registers
constexpr int SLOTS = Q_MAX / 8 + 2;  // G's 16 x 8 fragments a warp
constexpr int SLAB = 64;           // columns of a tile in shared memory
constexpr int LDT = SLAB + 4;      // its row stride: conflict-free fragments
constexpr int PASS_THREADS = 256;  // state passing, 4 elements a thread

// v = hi + lo in TF32: hi rounds v to 10 mantissa bits (half away from
// zero, by an integer add on the bits: 2 instructions where cvt.rna takes
// several on sm_90; inputs are finite), v - hi is exact, and lo goes to
// the tensor cores as it is: they read a .tf32 operand's top 19 bits, so
// lo is cut to 10 mantissa bits there (|v - hi - lo| <= 2^-21 |v|; masking
// its low 13 bits first gives bit-identical products)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

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
  for (int k = 0; k < 4; ++k) split_tf32(v[k], hi[k], lo[k]);
}

// The B operands of eight n-tiles (8 columns each), split.
struct BFrags {
  uint32_t h0[8], l0[8], h1[8], l1[8];
};

// B fragments of a row-major tile: b0 = t[k0 + r0][n], b1 = t[k0 + r1][n]
// for n = nt*8 + g
__device__ __forceinline__ void load_b(BFrags& f, const float* t, int ld,
                                       int r0, int r1, int g) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    split_tf32(t[r0 * ld + nt * 8 + g], f.h0[nt], f.l0[nt]);
    split_tf32(t[r1 * ld + nt * 8 + g], f.h1[nt], f.l1[nt]);
  }
}

__device__ __forceinline__ void zero8(float (&acc)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
}

// acc[nt] += A B[nt] in split TF32 for the eight n-tiles, one k-step: the
// three passes (the small terms first, then hi * hi) go to a fresh
// accumulator, which f32 adds then put into acc.  The tensor cores add
// into an accumulator with truncation at its own magnitude, so a running
// sum fed every k-step that way drifts toward zero by about one unit in
// its last place a step; each pass's eight products are independent.
__device__ __forceinline__ void mma3x8(float (&acc)[8][4],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const BFrags& f) {
  float t[8][4];
  zero8(t);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma_tf32(t[nt], al, f.h0[nt], f.h1[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma_tf32(t[nt], ah, f.l0[nt], f.l1[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) mma_tf32(t[nt], ah, f.h0[nt], f.h1[nt]);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] += t[nt][q];
  }
}

// A fragment of a row-major tile: rows r, r + 8; columns k, k + 4; split
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4],
                                       const float* t, int ld, int r, int k) {
  float v[4];
  v[0] = t[r * ld + k];
  v[1] = t[(r + 8) * ld + k];
  v[2] = t[r * ld + k + 4];
  v[3] = t[(r + 8) * ld + k + 4];
  split4(v, ah, al);
}

// asynchronous copies of 4 and 16 bytes to shared memory where live; a
// plain store of zeros where not
__device__ __forceinline__ void cp4(float* dst, const float* src, bool live) {
  if (live) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(src));
  } else {
    *dst = 0.f;
  }
}

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool live) {
  if (live) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(src));
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// rows x cols (cols <= SLAB, a multiple of 4) of a strided f32 tile into
// dst (row stride ld, a multiple of 4): src[r * rs + c] where r < rows_live
// and c < cols_live (a multiple of 4 where it is < cols), else zero.  By
// 16-byte copies where src and rs allow (vec), else by 4-byte ones: the
// model's views need not be 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long rs, int rows, int cols,
                                          int rows_live, int cols_live,
                                          bool vec) {
  if (vec) {
    const int c = threadIdx.x % (SLAB / 4) * 4;
    if (c >= cols) return;
    for (int r = threadIdx.x / (SLAB / 4); r < rows;
         r += SSD_THREADS / (SLAB / 4))
      cp16(dst + r * ld + c, src + r * rs + c, r < rows_live && c < cols_live);
  } else {
    const int c = threadIdx.x % SLAB;
    if (c >= cols) return;
    for (int r = threadIdx.x / SLAB; r < rows; r += SSD_THREADS / SLAB)
      cp4(dst + r * ld + c, src + r * rs + c, r < rows_live && c < cols_live);
  }
}

// cum_i - cum_j from cum held as f32 pairs (hi, lo), hi + lo the f64
// scan's value: hi_i - hi_j is exact where the two are within a factor of 2
// (and else rounded relative to the difference), so the decay's exponent is
// good to f32 relative to itself, not to |cum|, which reaches hundreds
__device__ __forceinline__ float cum_diff(float2 a, float2 b) {
  return (a.x - b.x) + (a.y - b.y);
}

// The state kernel.  Block (chunk c, head group, b); the chunk's B in
// shared memory once, then per head: x, dt, the scan, w, and each warp's
// state rows n (m-tiles warp, warp + 4, ...) over all P.  vec: bit 0, x
// takes 16-byte copies; bit 1, B does.
__global__ void __launch_bounds__(SSD_THREADS) ssd_state_kernel(
    const float* __restrict__ x, long long xsb, long long xss, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dss, long long dsh,
    const float* __restrict__ A, const float* __restrict__ Bm, long long bsb,
    long long bss, float* __restrict__ states, float2* __restrict__ cum_out,
    int S, int H, int P, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];  // 16-byte aligned
  float* sm = reinterpret_cast<float*>(smem4);
  const int Qp = (Q + 15) & ~15, Nm = (N + 15) & ~15;
  const int Pw = (P + SLAB - 1) / SLAB * SLAB;  // x's columns, zero-padded
  const int ldb = Nm + 8, ldx = Pw + 8;  // conflict-free fragment reads
  float* sB = sm;               // Qp x ldb: B[j][n]
  float* sx = sB + Qp * ldb;    // Qp x ldx: x[j][p]
  float* sdt = sx + Qp * ldx;   // Qp
  float* sw = sdt + Qp;         // Qp: exp(cum_last - cum_j) * dt_j
  double* stot = reinterpret_cast<double*>(sw + Qp);  // 4 warp totals
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const float* Bb = Bm + b * bsb + (long long)t0 * bss;
  for (int n0 = 0; n0 < Nm; n0 += SLAB)
    load_tile(sB + n0, ldb, Bb + n0, bss, Qp, min(SLAB, Nm - n0), Qv, N - n0,
              vec & 2);
  const int wl = (Qp - 1) >> 5;  // the warp of the chunk's last row
  const int h_end = min(H, (blockIdx.y + 1) * STATE_HEADS);
  for (int h = blockIdx.y * STATE_HEADS; h < h_end; ++h) {
    const float* xb = x + b * xsb + (long long)t0 * xss + h * xsh;
    for (int p0 = 0; p0 < Pw; p0 += SLAB)
      load_tile(sx + p0, ldx, xb + p0, xss, Qp, SLAB, Qv, P - p0, vec & 1);
    if (tid < Qp)
      cp4(sdt + tid, dt + b * dsb + (long long)(t0 + tid) * dss + h * dsh,
          tid < Qv);
    cp_wait();
    __syncthreads();
    // inclusive scan of dt * A over the chunk, in f64: within each warp
    // by shuffles, then the totals of the warps before.  In f32 this tree
    // of sums rounds cum_i and cum_j apart (a running sum rounds only the
    // steps between them), and exp(cum_i - cum_j) took that error into y,
    // well past the f32 plain version's distance from the exact answer
    const float dq = tid < Qp ? sdt[tid] : 0.f;
    double v = (double)dq * (double)__ldg(A + h);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) stot[warp] = v;
    __syncthreads();
    // cum_last, the last row's cum by the same additions as its own thread
    // (pad rows add dt = 0, so the last warp's total is its last row's)
    double last = stot[wl];
    for (int w = 0; w < wl; ++w) last += stot[w];
    for (int w = 0; w < warp; ++w) v += stot[w];
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    if (tid < Qp) {
      const float hi = (float)v;
      cum_out[bhc * Qp + tid] = make_float2(hi, (float)(v - hi));
      sw[tid] = expf((float)(last - v)) * dq;
    }
    __syncthreads();

    // S_c (N x P) = (B^T w) x: A = B^T scaled by w along k = j, rows n
    float* st = states + bhc * N * P;
    for (int n0 = warp * 16; n0 < Nm; n0 += 64) {
      for (int p0 = 0; p0 < Pw; p0 += SLAB) {
        float acc[8][4];
        zero8(acc);
        for (int j0 = 0; j0 < Qp; j0 += 8) {
          const int ja = j0 + tq, jb = ja + 4;
          const float wa = sw[ja], wb = sw[jb];
          float av[4];
          av[0] = sB[ja * ldb + n0 + g] * wa;
          av[1] = sB[ja * ldb + n0 + g + 8] * wa;
          av[2] = sB[jb * ldb + n0 + g] * wb;
          av[3] = sB[jb * ldb + n0 + g + 8] * wb;
          uint32_t ah[4], al[4];
          split4(av, ah, al);
          BFrags f;
          load_b(f, sx + j0 * ldx + p0, ldx, tq, tq + 4, g);
          mma3x8(acc, ah, al, f);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int p = p0 + k * 8 + 2 * tq, na = n0 + g, nb = na + 8;
          if (p < P) {
            if (na < N)
              *reinterpret_cast<float2*>(st + (size_t)na * P + p) =
                  make_float2(acc[k][0], acc[k][1]);
            if (nb < N)
              *reinterpret_cast<float2*>(st + (size_t)nb * P + p) =
                  make_float2(acc[k][2], acc[k][3]);
          }
        }
      }
    }
    __syncthreads();  // the next head overwrites x, dt and w
  }
}

// State passing: thread (element quad e4, head h, b) walks the chunks,
// the next chunk's loads issued before this chunk's store.
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass_kernel(
    float* __restrict__ states, const float2* __restrict__ cum,
    float* __restrict__ state_out, int H, int NP, int nc, int Qp) {
  const int e4 = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (e4 * 4 >= NP) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float4* sp = reinterpret_cast<float4*>(states + bh * nc * NP) + e4;
  const float2* cl = cum + bh * nc * Qp + Qp - 1;
  const size_t step = NP / 4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 nxt = sp[0];
  float cn = __ldg(cl).x;
  for (int c = 0; c < nc; ++c) {
    const float4 sc = nxt;
    const float d = expf(cn);
    if (c + 1 < nc) {
      nxt = sp[(c + 1) * step];
      cn = __ldg(cl + (size_t)(c + 1) * Qp).x;
    }
    sp[c * step] = s;  // the state chunk c starts from
    s.x = s.x * d + sc.x;
    s.y = s.y * d + sc.y;
    s.z = s.z * d + sc.z;
    s.w = s.w * d + sc.w;
  }
  reinterpret_cast<float4*>(state_out + bh * NP)[e4] = s;
}

// The output kernel.  Block (chunk c, head group, b); warp w owns the row
// tiles rA = w and rB = nt - 1 - w (nt = Qp / 16).  Its G fragments: slot
// s < jA is tile rA's column tile s; slot jA <= s < js is tile rB's column
// tile js - 1 - s.  Shared memory: a SLAB-column tile of C, one of x (B
// while G forms), one of the state before the chunk, cum and dt.
__global__ void __launch_bounds__(SSD_THREADS) ssd_output_kernel(
    const float* __restrict__ x, long long xsb, long long xss, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dss, long long dsh,
    const float* __restrict__ Bm, long long bsb, long long bss,
    const float* __restrict__ Cm, long long csb, long long css,
    const float* __restrict__ states, const float2* __restrict__ cum,
    float* __restrict__ y, int S, int H, int P, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int Qp = (Q + 15) & ~15, Nk = (N + 7) & ~7;
  const int lds = SLAB + 8;
  float* sC = sm;                // Qp x LDT: C[i][n], one n-slab
  float* sx = sC + Qp * LDT;     // Qp x LDT: x[j][p] (B[j][n] for G)
  float* sS = sx + Qp * LDT;     // SLAB x lds: state[n][p]
  float2* scum = reinterpret_cast<float2*>(sS + SLAB * lds);  // Qp pairs
  float* sdt = reinterpret_cast<float*>(scum + Qp);           // Qp
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const float* Bb = Bm + b * bsb + (long long)t0 * bss;
  const float* Cb = Cm + b * csb + (long long)t0 * css;
  const int nt = Qp / 16;
  const bool active = warp < (nt + 1) / 2;
  const int rA = warp, rB = nt - 1 - warp;
  const bool two = rA != rB;
  const int jA = 2 * rA + 2, js = two ? 2 * nt + 2 : jA;
  const int iA = rA * 16 + g, iB = rB * 16 + g;  // rows; + 8 for a1, a3

  // G = C B^T on the warp's tiles, at and below the diagonal, over n-slabs
  float G[SLOTS][4];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) G[s][0] = G[s][1] = G[s][2] = G[s][3] = 0.f;
  for (int n0 = 0; n0 < Nk; n0 += SLAB) {
    const int w = min(SLAB, Nk - n0);
    load_tile(sC, LDT, Cb + n0, css, Qp, w, Qv, N - n0, vec & 4);
    load_tile(sx, LDT, Bb + n0, bss, Qp, w, Qv, N - n0, vec & 2);
    cp_wait();
    __syncthreads();
    if (active) {
      for (int k0 = 0; k0 < w; k0 += 8) {
        uint32_t aAh[4], aAl[4], aBh[4], aBl[4];
        load_a(aAh, aAl, sC, LDT, iA, k0 + tq);
        load_a(aBh, aBl, sC, LDT, iB, k0 + tq);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s < js) {
            const float* bj = sx + ((s < jA ? s : js - 1 - s) * 8 + g) * LDT;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bj[k0 + tq], bh0, bl0);
            split_tf32(bj[k0 + tq + 4], bh1, bl1);
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // as in mma3x8
            if (s < jA) {
              mma_tf32(t, aAl, bh0, bh1);
              mma_tf32(t, aAh, bl0, bl1);
              mma_tf32(t, aAh, bh0, bh1);
            } else {
              mma_tf32(t, aBl, bh0, bh1);
              mma_tf32(t, aBh, bl0, bl1);
              mma_tf32(t, aBh, bh0, bh1);
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) G[s][q] += t[q];
          }
        }
      }
    }
    __syncthreads();  // sC and sx are overwritten next
  }
  // with one n-slab, sC holds the chunk's C for every head
  const bool c_resident = Nk <= SLAB;

  const int NP = N * P;
  const int h_end = min(H, (blockIdx.y + 1) * OUT_HEADS);
  for (int h = blockIdx.y * OUT_HEADS; h < h_end; ++h) {
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    const float* xb = x + b * xsb + (long long)t0 * xss + h * xsh;
    const float* st = states + bhc * NP;
    float* yh = y + ((size_t)b * S + t0) * H * P + (size_t)h * P;
    if (tid < Qp) {
      const float* src = reinterpret_cast<const float*>(cum + bhc * Qp + tid);
      float* dst = reinterpret_cast<float*>(scum + tid);
      cp4(dst, src, true);
      cp4(dst + 1, src + 1, true);
      cp4(sdt + tid, dt + b * dsb + (long long)(t0 + tid) * dss + h * dsh,
          tid < Qv);
    }
    for (int p0 = 0; p0 < P; p0 += SLAB) {
      load_tile(sx, LDT, xb + p0, xss, Qp, SLAB, Qv, P - p0, vec & 1);
      float accA[8][4], accB[8][4];
      zero8(accA);
      zero8(accB);
      // C (state before the chunk), over n-slabs
      for (int n0 = 0; n0 < Nk; n0 += SLAB) {
        const int w = min(SLAB, Nk - n0);
        if (!c_resident)
          load_tile(sC, LDT, Cb + n0, css, Qp, w, Qv, N - n0, vec & 4);
        for (int i = tid; i < w * (SLAB / 4); i += SSD_THREADS) {
          const int n = i / (SLAB / 4), p = (i - n * (SLAB / 4)) * 4;
          cp16(sS + n * lds + p, st + (size_t)(n0 + n) * P + p0 + p,
               n0 + n < N && p0 + p < P);
        }
        cp_wait();
        __syncthreads();
        if (active) {
          for (int k0 = 0; k0 < w; k0 += 8) {
            BFrags f;
            load_b(f, sS + k0 * lds, lds, tq, tq + 4, g);
            uint32_t ah[4], al[4];
            load_a(ah, al, sC, LDT, iA, k0 + tq);
            mma3x8(accA, ah, al, f);
            if (two) {
              load_a(ah, al, sC, LDT, iB, k0 + tq);
              mma3x8(accB, ah, al, f);
            }
          }
        }
        if (n0 + SLAB < Nk) __syncthreads();  // sC and sS are overwritten
      }
      if (active) {
        const float2 cA = scum[iA], cA8 = scum[iA + 8];
        const float2 cB = scum[iB], cB8 = scum[iB + 8];
        const float eA = expf(cA.x), eA8 = expf(cA8.x);
        const float eB = expf(cB.x), eB8 = expf(cB8.x);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          accA[k][0] *= eA;
          accA[k][1] *= eA;
          accA[k][2] *= eA8;
          accA[k][3] *= eA8;
          accB[k][0] *= eB;
          accB[k][1] *= eB;
          accB[k][2] *= eB8;
          accB[k][3] *= eB8;
        }
        // + (G * exp(cum_i - cum_j) * dt_j) x over j <= i: G's fragment
        // holds columns j0 + 2 tq, j0 + 2 tq + 1, the A operand's k slots
        // tq and tq + 4, so the B operand reads x rows ja, jb
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s < js) {
            const bool ownA = s < jA;
            const int i = ownA ? iA : iB;
            const float2 ci = ownA ? cA : cB, ci8 = ownA ? cA8 : cB8;
            const int ja = (ownA ? s : js - 1 - s) * 8 + 2 * tq, jb = ja + 1;
            const float2 ca = scum[ja], cb = scum[jb];
            const float da = sdt[ja], db = sdt[jb];
            float lv[4];
            lv[0] = ja <= i ? G[s][0] * expf(cum_diff(ci, ca)) * da : 0.f;
            lv[1] = ja <= i + 8 ? G[s][2] * expf(cum_diff(ci8, ca)) * da : 0.f;
            lv[2] = jb <= i ? G[s][1] * expf(cum_diff(ci, cb)) * db : 0.f;
            lv[3] = jb <= i + 8 ? G[s][3] * expf(cum_diff(ci8, cb)) * db : 0.f;
            uint32_t ah[4], al[4];
            split4(lv, ah, al);
            BFrags f;
            load_b(f, sx + (ja - 2 * tq) * LDT, LDT, 2 * tq, 2 * tq + 1, g);
            if (ownA) mma3x8(accA, ah, al, f);
            else mma3x8(accB, ah, al, f);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int p = p0 + k * 8 + 2 * tq;
          if (p < P) {
            if (iA < Qv)
              *reinterpret_cast<float2*>(yh + (size_t)iA * H * P + p) =
                  make_float2(accA[k][0], accA[k][1]);
            if (iA + 8 < Qv)
              *reinterpret_cast<float2*>(yh + (size_t)(iA + 8) * H * P + p) =
                  make_float2(accA[k][2], accA[k][3]);
            if (two && iB < Qv)
              *reinterpret_cast<float2*>(yh + (size_t)iB * H * P + p) =
                  make_float2(accB[k][0], accB[k][1]);
            if (two && iB + 8 < Qv)
              *reinterpret_cast<float2*>(yh + (size_t)(iB + 8) * H * P + p) =
                  make_float2(accB[k][2], accB[k][3]);
          }
        }
      }
      __syncthreads();  // the next slab or head overwrites the tiles
    }
  }
}

// Dynamic shared memory of one block of each kernel, in bytes
// (kernel.py::smem_bytes): the state kernel's and the output kernel's.
long long ssd_state_smem_bytes(int P, int N, int Q) {
  const long long Qp = (Q + 15) & ~15, Nm = (N + 15) & ~15;
  const long long Pw = (P + SLAB - 1) / SLAB * SLAB;
  return 4LL * (Qp * (Nm + 8) + Qp * (Pw + 8) + 2 * Qp + 8);
}

long long ssd_output_smem_bytes(int Q) {
  const long long Qp = (Q + 15) & ~15;
  return 4LL * (2 * Qp * LDT + SLAB * (SLAB + 8) + 3 * Qp);
}

}  // namespace

extern "C" {

// x (B,S,H,P), dt (B,S,H), B_/C_ (B,S,N) f32 through strides in elements
// (innermost stride 1); A (H,); y (B,S,H,P) and state (B,H,N,P)
// contiguous; scratch: states (B,H,chunks,N,P) and cum (B,H,chunks,Qp,2)
// (hi, lo pairs), Qp = Q rounded up to 16.  Q <= 128, P and N multiples
// of 4.  Three launches on the stream; returns the first cudaError_t (0 on
// success).
int ssd_scan_launch(const float* x, long long xsb, long long xss,
                    long long xsh, const float* dt, long long dsb,
                    long long dss, long long dsh, const float* A,
                    const float* Bm, long long bsb, long long bss,
                    const float* Cm, long long csb, long long css, float* y,
                    float* state, float* states, float* cum, int B, int S,
                    int H, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > Q_MAX || P % 4 || N % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, Qp = (Q + 15) & ~15;
  const long long smem1 = ssd_state_smem_bytes(P, N, Q);
  const long long smem3 = ssd_output_smem_bytes(Q);
  cudaError_t err = cudaSuccess;
  if (smem1 > 48 * 1024)
    err = cudaFuncSetAttribute(ssd_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem1);
  if (err == cudaSuccess && smem3 > 48 * 1024)
    err = cudaFuncSetAttribute(ssd_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where a view's base and row strides allow them
  auto aligned = [](const float* p, long long s0, long long s1,
                    long long s2) {
    return (uintptr_t)p % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
           s2 % 4 == 0;
  };
  const int vec = (aligned(x, xsb, xss, xsh) ? 1 : 0) |
                  (aligned(Bm, bsb, bss, 0) ? 2 : 0) |
                  (aligned(Cm, csb, css, 0) ? 4 : 0);
  ssd_state_kernel<<<dim3(nc, (H + STATE_HEADS - 1) / STATE_HEADS, B),
                     SSD_THREADS, (size_t)smem1, st>>>(
      x, xsb, xss, xsh, dt, dsb, dss, dsh, A, Bm, bsb, bss, states,
      reinterpret_cast<float2*>(cum), S, H, P, N, Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NP = N * P;
  ssd_pass_kernel<<<dim3((NP / 4 + PASS_THREADS - 1) / PASS_THREADS, H, B),
                    PASS_THREADS, 0, st>>>(
      states, reinterpret_cast<const float2*>(cum), state, H, NP, nc, Qp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_output_kernel<<<dim3(nc, (H + OUT_HEADS - 1) / OUT_HEADS, B),
                      SSD_THREADS, (size_t)smem3, st>>>(
      x, xsb, xss, xsh, dt, dsb, dss, dsh, Bm, bsb, bss, Cm, csb, css,
      states, reinterpret_cast<const float2*>(cum), y, S, H, P, N, Q, vec);
  return (int)cudaGetLastError();
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
