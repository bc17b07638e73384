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
//   dB_j  = sum_{i>=j} R_ij C_i + w_j dt_j G x_j,  R_ij = L_ij dt_j (dy_i . x_j)
//   dC_i  = sum_{j<=i} R_ij B_j + exp(cum_i) S_in dy_i
//   dcum  from every exp(.) above, da = the reverse cumsum of dcum in the
//   chunk, dA_h = sum over (b, steps) of da dt.
// B and C are shared across heads, so C B^T is one matrix per (b, chunk),
// and dB and dC are sums over heads: dB = (sum_h R_h)^T C + sum_h (w dt
// x)_h G_h^T, and dC alike, so the Q x Q products with C and B run once
// for a group of heads on the sum of their R.
//
// Design, five kernels behind the one entry point ssd_bwd_launch (counted
// as one ssd_bwd launch), on the caller's stream:
// 1. ssd_bwd_adj_kernel, one block per (chunk, group of HEAD_GROUP heads,
//    b): the chunk's C in shared memory once, then per head U_c = sum_i
//    exp(cum_i) C_i dy_i^T (N x P) into the scratch gbuf.
// 2. ssd_bwd_pass_kernel, one thread per 4 state elements of one (b, h):
//    the reverse recurrence over the chunks; it overwrites each U_c with
//    G, the gradient of the state the chunk ends with.
// 3. ssd_bwd_chunk_kernel, one block per (chunk, group of HEAD_GROUP
//    heads, b), 16 warps:
//    a. C B^T on and below the diagonal, ONCE for the group: the
//       triangle's 16 x 8 tiles (Q = 128: 72) dealt round-robin to the
//       warps, 5 at most each, kept in registers;
//    b. per head, in a fixed order: (dy x^T)^T on the same tiles, then M
//       = C B^T o L into shared memory tile by tile, R added into the
//       group's sum of R (shared memory, each value's own thread), T = C
//       B^T o R (its row and column sums, per tile, feed dcum); u = M^T dy
//       + w G^T B (each warp two row tiles, r and Q/16 - 1 - r, and a
//       quarter of P, so the triangle's work is even; an accumulator tile
//       of M is an A operand as it stands), dx, x . u and the chunk-state
//       term of dcum; C S_in and the starting-state term of dcum;
//       <S_in, G>; the reverse cumsum into da, ddt and dA's share (warp 0,
//       f64 shuffles);
//    c. once for the group: dB = (sum R)^T C + sum_h (w dt x)_h G_h^T and
//       dC = (sum R) B + sum_h (exp(cum) dy)_h S_in,h^T, warp (row tile,
//       64-column slab of N), written as the group's share.
// 4. ssd_bwd_reduce_kernel twice: dB and dC, the groups' shares added in
//    order; and ssd_bwd_reduce_a_kernel: dA.
// No atomics anywhere: every sum has one owner and a fixed order, so two
// runs give the same bits.  A head count that HEAD_GROUP does not divide
// leaves the last group short.
// The chunk-boundary states S_in and cum come from the forward (ssd.cu
// keeps both in its scratch: each chunk's starting state, and cum as f32
// (hi, lo) pairs from its f64 scan), so exp(cum_i - cum_j) is taken from
// the same f64 cum as in the forward (cum_diff), and the recurrence uses
// the forward's exp(hi of cl).  Steps past S (a ragged last chunk) are
// zeros with dt = 0, as in the forward: exact no-ops.
//
// Products run on the tensor cores, mma.sync.m16n8k8 in split TF32 as in
// ssd.cu: each f32 operand a = hi + lo, and lo*hi + hi*lo + hi*hi into a
// fresh accumulator each k-step, which f32 adds then sum (the tensor cores
// truncate what they add into an accumulator at its magnitude).  Where an
// operand is formed in registers (L-weighted C B^T, sum R) or read from
// device memory (B, C, x, dy rows), its k-slots t and t + 4 may stand for
// columns 2t and 2t + 1, with the other operand read to match: the sum
// over k is order-free, and the shared-memory reads stay conflict-free.
// Tiles reach shared memory by cp.async, 64 columns at a time, rows padded
// to conflict-free strides, each stage's tiles in one batch; the next
// head's x and dy, and step c's per-head tiles, load while the block
// computes on others.  The chunk kernel holds a Q x Q f32 region (M, two
// staging slabs, then the group's sum of R), three 64-column slabs, the
// sum of R by tile, and the vectors: 227 KB, one block of 16 warps an SM,
// 128 registers a thread and no spills (the k-loops are not unrolled);
// the adjoint kernel 103 KB, two blocks.
//
// What bounds it: at Mamba2-2.7B's training shape (B 2, S 2048, H 80, P
// 64, N 128, Q 128) the function moves x, dt, B, C, dy in and dx, ddt, dB,
// dC out, ~0.35 GB (0.10 ms at 3.35 TB/s), and its products (C B^T once
// per (b, chunk), the others per head as the plain version forms them)
// are ~38 GFLOP, three TF32 products each: 0.23 ms at 495 TFLOP/s,
// operations.  This design runs fewer (the products with C and B once a
// group), but on mma.sync, whose operands each warp loads itself; its own
// traffic adds the state gradients (written, read and written, and
// read), the groups' dB and dC shares, and second reads of x, dy, G and
// S_in in step c.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 256;          // threads of an adjoint block
constexpr int QM = 128;          // longest chunk (the forward's Q_MAX)
constexpr int HEAD_GROUP = 4;    // heads of an adjoint or chunk block
constexpr int CHUNK_WARPS = 16;  // warps of a chunk block
constexpr int CHUNK_THREADS = 32 * CHUNK_WARPS;
constexpr int TILES = (QM / 16) * (QM / 16 + 1);  // 16 x 8 triangle tiles
constexpr int SLAB = 64;         // columns of a staged tile
constexpr int LS = SLAB + 4;     // its row stride
constexpr int LU = QM + 4;       // row stride of the Q x Q matrix and of C
// the chunk kernel's Q x Q matrix, or two slabs
constexpr int U_FLOATS = QM * LU > 2 * QM * LS ? QM * LU : 2 * QM * LS;
constexpr int PASS_THREADS = 256;

// ---- split TF32 on mma.sync, as ssd.cu
// v = hi + lo in TF32: hi rounds v to 10 mantissa bits (half away from
// zero, by an integer add on the bits), v - hi is exact, and the tensor
// cores read lo's top 19 bits (|v - hi - lo| <= 2^-21 |v|)
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

// acc += A B for one k-step of one n-tile in split TF32: the three passes
// (the small terms first, then hi * hi) go to a fresh accumulator, which
// an f32 add puts into acc
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// cum_i - cum_j from cum held as f32 pairs (hi, lo), hi + lo the forward's
// f64 scan: good to f32 relative to the difference, not to |cum|
__device__ __forceinline__ float cum_diff(float2 a, float2 b) {
  return (a.x - b.x) + (a.y - b.y);
}

// the sum over the four threads of a quad (t = lane % 4), in a fixed order
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of the committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// rows x cols (cols <= SLAB, a multiple of 4) of a strided f32 tile into
// dst (row stride ld): src[r * rs + c] where r < rows_live and c <
// cols_live (a multiple of 4), else zero; 16-byte copies where src and rs
// allow (vec), else 4-byte ones
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long rs, int rows, int cols,
                                          int rows_live, int cols_live,
                                          bool vec) {
  if (vec) {
    const int c = threadIdx.x % (SLAB / 4) * 4;
    if (c >= cols) return;
    for (int r = threadIdx.x / (SLAB / 4); r < rows;
         r += blockDim.x / (SLAB / 4))
      cp16(dst + r * ld + c, src + r * rs + c, r < rows_live && c < cols_live);
  } else {
    const int c = threadIdx.x % SLAB;
    if (c >= cols) return;
    for (int r = threadIdx.x / SLAB; r < rows; r += blockDim.x / SLAB)
      cp4(dst + r * ld + c, src + r * rs + c, r < rows_live && c < cols_live);
  }
}

size_t chunk_smem_bytes() {
  constexpr int W = CHUNK_WARPS;
  return sizeof(float) *
         (size_t)(U_FLOATS + 3 * QM * LS + TILES * (128 + 24) +
                  2 * (W / 4) * QM + (W / 8) * QM + 2 * HEAD_GROUP * QM +
                  2 * QM + 8 * QM + W);
}

size_t adj_smem_bytes() {
  return sizeof(float) * (size_t)(QM * LU + QM * LS + QM);
}

// 1. Per head of the group, U_c = sum_i exp(cum_i) C_i dy_i^T (N x P):
// warp w the rows n of 16-row tile w, the k-slots t, t + 4 columns i =
// k0 + 2t, k0 + 2t + 1.
__global__ void __launch_bounds__(BT, 2) ssd_bwd_adj_kernel(
    const float* __restrict__ Cm, long long csb, long long css,
    const float* __restrict__ dy, const float2* __restrict__ cum,
    float* __restrict__ gbuf, int S, int H, int P, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  float* sC = reinterpret_cast<float*>(smem4);  // QM x LU: C[i][n]
  float* sY = sC + QM * LU;                     // QM x LS: dy[i][p]
  float* se = sY + QM * LS;                     // exp(cum_i)
  const int c = blockIdx.x, b = blockIdx.z, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const int Qp = (Q + 15) & ~15, N16 = (N + 15) & ~15;
  const int h0 = blockIdx.y * HEAD_GROUP, hn = min(HEAD_GROUP, H - h0);
  const float* Cb = Cm + b * csb + (long long)t0 * css;
  for (int n0 = 0; n0 < N16; n0 += SLAB)
    load_tile(sC + n0, LU, Cb + n0, css, Qp, min(SLAB, N16 - n0), Qv, N - n0,
              vec & 4);
  const int nr = 16 * warp + gr;  // rows nr, nr + 8
  for (int hl = 0; hl < hn; ++hl) {
    const int h = h0 + hl;
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    __syncthreads();  // the last head's dy and exp(cum) are spent
    if (tid < QM) {
      float e = 0.f;
      if (tid < Qv) {
        const float2 ci = cum[bhc * Qp + tid];
        e = expf(ci.x + ci.y);
      }
      se[tid] = e;
    }
    load_tile(sY, LS, dy + (((size_t)b * S + t0) * H + h) * P,
              (long long)H * P, Qp, SLAB, Qv, P, vec & 8);
    cp_wait();
    __syncthreads();
    if (16 * warp >= N16) continue;
    float acc[8][4];
    zero(acc);
    for (int k0 = 0; k0 < Qp; k0 += 8) {
      const int ia = k0 + 2 * tq, ib = ia + 1;
      const float ea = se[ia], eb = se[ib];
      float av[4];
      av[0] = sC[ia * LU + nr] * ea;
      av[1] = sC[ia * LU + nr + 8] * ea;
      av[2] = sC[ib * LU + nr] * eb;
      av[3] = sC[ib * LU + nr + 8] * eb;
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int n = 0; n < 8; ++n)  // columns past P are zeros
        mma3(acc[n], ah, al, sY[ia * LS + n * 8 + gr],
             sY[ib * LS + n * 8 + gr]);
    }
    float* out = gbuf + bhc * N * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int p = n * 8 + 2 * tq;
      if (p >= P) continue;
      if (nr < N)
        *reinterpret_cast<float2*>(out + (size_t)nr * P + p) =
            make_float2(acc[n][0], acc[n][1]);
      if (nr + 8 < N)
        *reinterpret_cast<float2*>(out + (size_t)(nr + 8) * P + p) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

// 2. The reverse pass: G = d final_state, then for c = nc-1 .. 0 the
// chunk's G is stored over its U_c and G = exp(cl_c) G + U_c, the next
// chunk's loads issued before this one's store.
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
  float4 nxt = gp[(nc - 1) * step];
  float cn = __ldg(cl + (size_t)(nc - 1) * Qp).x;
  for (int c = nc - 1; c >= 0; --c) {
    const float4 U = nxt;
    const float d = expf(cn);
    if (c > 0) {
      nxt = gp[(c - 1) * step];
      cn = __ldg(cl + (size_t)(c - 1) * Qp).x;
    }
    gp[c * step] = G;  // the gradient of the state chunk c ends with
    G.x = G.x * d + U.x;
    G.y = G.y * d + U.y;
    G.z = G.z * d + U.z;
    G.w = G.w * d + U.w;
  }
}

// 3. One chunk of a group of heads, CHUNK_WARPS warps.  The triangle's
// tiles are 16 rows j by 8 columns i >= j (the upper triangle of the
// transposed matrices: j the rows, i the columns), numbered row-major;
// warp w takes tiles w, w + CHUNK_WARPS, ..  Fragments of m16n8k8 (g =
// lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g); C c0 (g, 2t), c1
// (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).  Shared memory: sU,
// the Q x Q matrix or two slabs U0, U1; three slabs sV0, sV1, sV2; each
// stage of the kernel loads every tile it needs in one batch of cp.async.
// vec: 16-byte copies for x (bit 0), B (1), C (2), dy (3), and the states
// and their gradients (4).
__global__ void __launch_bounds__(CHUNK_THREADS, 1) ssd_bwd_chunk_kernel(
    const float* __restrict__ x, long long xsb, long long xss, long long xsh,
    const float* __restrict__ dt, long long dsb, long long dss,
    long long dsh, const float* __restrict__ A, const float* __restrict__ Bm,
    long long bsb, long long bss, const float* __restrict__ Cm,
    long long csb, long long css, const float* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gbuf,
    const float2* __restrict__ cum, float* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dBpart,
    float* __restrict__ dCpart, float* __restrict__ dApart, int Bn, int S,
    int H, int P, int N, int Q, int vec) {
  constexpr int W = CHUNK_WARPS, T = CHUNK_THREADS;
  constexpr int SLOTS = (72 + W - 1) / W;  // triangle tiles a warp
  constexpr int UG = W / 4;                // column groups of u and G^T B
  constexpr int UN = 8 / UG;               // their n-tiles of P
  constexpr int CG = W / 8;                // column groups of C S_in
  constexpr int CN = 8 / CG;               // its n-tiles of P
  constexpr int NSL = 2 / CG;              // N slabs a warp of step c
  extern __shared__ float4 smem4[];
  float* sU = reinterpret_cast<float*>(smem4);  // QM x LU, or U0 and U1
  float* sU1 = sU + QM * LS;
  float* sV0 = sU + U_FLOATS;                   // QM x LS slabs
  float* sV1 = sV0 + QM * LS;
  float* sV2 = sV1 + QM * LS;
  float* sRs = sV2 + QM * LS;  // per tile: the group's sum of R
  float* sTp = sRs + TILES * 128;   // per tile: T's 16 row and 8 column sums
  float* sXu = sTp + TILES * 24;    // per column group: x . u by j
  float* sWx = sXu + UG * QM;       // per column group: W_j
  float* sIp = sWx + UG * QM;       // per column group: dy_i . (C S_in)_i
  float* sWD = sIp + CG * QM;       // [head][QM]: w_j dt_j
  float* sEC = sWD + HEAD_GROUP * QM;  // [head][QM]: exp(cum_i)
  float2* scum = reinterpret_cast<float2*>(sEC + HEAD_GROUP * QM);
  float* sdt = reinterpret_cast<float*>(scum + QM);
  float* swl = sdt + QM;   // exp(cl - cum_j)
  float* sec = swl + QM;   // exp(cum_i)
  float* srow = sec + QM;  // sum_j T_ij
  float* scol = srow + QM; // sum_i T_ij
  float* sdd = scol + QM;  // x . u
  float* sW = sdd + QM;    // the chunk-state term of dcum_j
  float* sI = sW + QM;     // the starting-state term of dcum_i
  float* red = sI + QM;    // per warp: <S_in, G>

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nc = gridDim.x, t0 = c * Q, Qv = min(Q, S - t0);
  const int Qp = (Q + 15) & ~15, nt = Qp / 16;
  // N in whole slabs: tiles are zero past N and P, so every k-loop over
  // them runs its full, static length
  const int Nz = (N + SLAB - 1) / SLAB * SLAB;
  const bool two_slabs = Nz > SLAB;
  const int h0 = grp * HEAD_GROUP, hn = min(HEAD_GROUP, H - h0);
  const float* Cb = Cm + b * csb + (long long)t0 * css;
  const float* Bb = Bm + b * bsb + (long long)t0 * bss;
  const long long ys = (long long)H * P;
  // the two 64-column slabs of B or C into d0 and d1 (d1 only for N > 64)
  auto load_bc = [&](float* d0, float* d1, const float* src, long long rs,
                     int v) {
    load_tile(d0, LS, src, rs, Qp, SLAB, Qv, N, v);
    if (two_slabs) load_tile(d1, LS, src + SLAB, rs, Qp, SLAB, Qv, N - SLAB, v);
  };

  // the warp's triangle tiles, slot k: rows j from 16 r, columns i from
  // 8 c, packed as r | c << 4 | kept << 8; a slot past the triangle (Q <
  // 128) runs on tile 0 and is not kept, so the product loops hold no
  // branch
  int slot[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    int rem = warp + W * k, r = 0;
    slot[k] = 0;
    if (rem < nt * (nt + 1)) {
      while (rem >= 2 * (nt - r)) rem -= 2 * (nt - r++);
      slot[k] = r | (2 * r + rem) << 4 | 1 << 8;
    }
  }
  auto sr = [&](int k) { return slot[k] & 15; };
  auto sc = [&](int k) { return (slot[k] >> 4) & 15; };
  auto sv = [&](int k) { return slot[k] >> 8; };
  // u's layout: row tiles pp and nt - 1 - pp (rB = rA where there is one),
  // the n-tiles of column group ug
  const int pp = warp & 3, ug = warp >> 2;
  const int rA = pp, rB = max(rA, nt - 1 - pp);
  const bool act = rA < nt && rA <= nt - 1 - pp, two = rA < rB;
  // C S_in's and step c's layout: row tile rt, column group (or slab) cg
  const int rt = warp & 7, cg = warp >> 3;
  const bool row_act = rt < nt;
  const int ra = 16 * rt + gr, rb = ra + 8;

  // ---- a. (C B^T)^T on the tiles: A = B rows j (sV0, sV1), B operand C
  // rows i (sV2, U0)
  float cb[SLOTS][4];
  zero(cb);
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (sv(k)) sRs[(warp + W * k) * 128 + 32 * e + lane] = 0.f;
  load_bc(sV0, sV1, Bb, bss, vec & 2);
  load_bc(sV2, sU, Cb, css, vec & 4);
  cp_wait();
  __syncthreads();
  for (int n0 = 0; n0 < Nz; n0 += SLAB) {
    const float* tB = n0 ? sV1 : sV0;
    const float* tC = n0 ? sU : sV2;
#pragma unroll 1
    for (int k0 = 0; k0 < SLAB; k0 += 8) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const float* ar = tB + (16 * sr(k) + gr) * LS + k0 + tq;
        const float av[4] = {ar[0], ar[8 * LS], ar[4], ar[8 * LS + 4]};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* br = tC + (8 * sc(k) + gr) * LS + k0 + tq;
        mma3(cb[k], ah, al, br[0], br[4]);
      }
    }
  }

  // ---- b. the heads
  for (int hl = 0; hl < hn; ++hl) {
    const int h = h0 + hl;
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    const float* xb = x + b * xsb + (long long)t0 * xss + h * xsh;
    const float* yb = dy + (((size_t)b * S + t0) * H + h) * P;
    __syncthreads();  // the last head's vectors, sums and tiles are spent
    if (hl == 0) {  // later heads' x and dy are in flight already
      load_tile(sV0, LS, xb, xss, Qp, SLAB, Qv, P, vec & 1);
      load_tile(sV1, LS, yb, ys, Qp, SLAB, Qv, P, vec & 8);
    }
    const float2 clp = cum[bhc * Qp + Qp - 1];
    if (tid < QM) {
      const float2 ci = tid < Qv ? cum[bhc * Qp + tid] : clp;
      const float d =
          tid < Qv ? __ldg(dt + b * dsb + (long long)(t0 + tid) * dss +
                           h * dsh)
                   : 0.f;
      const float e = tid < Qv ? expf(ci.x + ci.y) : 0.f;
      const float wl = tid < Qv ? expf(cum_diff(clp, ci)) : 0.f;
      scum[tid] = ci;
      sdt[tid] = d;
      sec[tid] = e;
      swl[tid] = wl;
      sWD[hl * QM + tid] = wl * d;
      sEC[hl * QM + tid] = e;
    }
    cp_wait();
    __syncthreads();

    // (dy x^T)^T on the tiles; then M = C B^T o L into sU (tile by tile,
    // each thread's four values at 32 e + lane), R = L dt_j (dy x^T)
    // summed over the group's heads, T = C B^T o R
    float dd[SLOTS][4];
    zero(dd);
#pragma unroll 1
    for (int k0 = 0; k0 < SLAB; k0 += 8) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const float* ar = sV0 + (16 * sr(k) + gr) * LS + k0 + tq;
        const float av[4] = {ar[0], ar[8 * LS], ar[4], ar[8 * LS + 4]};
        uint32_t ah[4], al[4];
        split4(av, ah, al);
        const float* br = sV1 + (8 * sc(k) + gr) * LS + k0 + tq;
        mma3(dd[k], ah, al, br[0], br[4]);
      }
    }
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      if (!sv(k)) continue;
      const int jr = 16 * sr(k), ic = 8 * sc(k);
      float ti[2] = {0.f, 0.f}, tj[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ic + 2 * tq + (e & 1), j = jr + gr + 8 * (e >> 1);
        float m = 0.f, r = 0.f, t = 0.f;
        if (i >= j) {
          const float L = expf(cum_diff(scum[i], scum[j]));
          m = cb[k][e] * L;
          r = L * sdt[j] * dd[k][e];
          t = cb[k][e] * r;
        }
        sU[(warp + W * k) * 128 + 32 * e + lane] = m;
        sRs[(warp + W * k) * 128 + 32 * e + lane] += r;
        ti[e & 1] += t;
        tj[e >> 1] += t;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ti[0] += __shfl_xor_sync(0xffffffffu, ti[0], o);
        ti[1] += __shfl_xor_sync(0xffffffffu, ti[1], o);
      }
      tj[0] = quad_sum(tj[0]);
      tj[1] = quad_sum(tj[1]);
      float* tp = sTp + (warp + W * k) * 24;  // rows j, then columns i
      if (gr == 0) {
        tp[16 + 2 * tq] = ti[0];
        tp[16 + 2 * tq + 1] = ti[1];
      }
      if (tq == 0) {
        tp[gr] = tj[0];
        tp[gr + 8] = tj[1];
      }
    }
    __syncthreads();  // M is in sU

    // u = M^T dy on the warp's row tiles and column group: tile (r, c) of
    // M is the A operand of k-step c, its k-slots t, t + 4 the columns i =
    // 8c + 2t, 8c + 2t + 1 (the accumulator's e = 0, 1; e = 2, 3 for rows
    // + 8)
    float u[2][UN][4];
    zero(u[0]);
    zero(u[1]);
    if (act) {
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        if (t2 == 1 && !two) continue;
        const int r = t2 ? rB : rA;
        const float* mt = sU + (2 * r * nt - r * (r - 1) - 2 * r) * 128 + lane;
        for (int c2 = 2 * r; c2 < 2 * nt; ++c2) {
          const float* m = mt + c2 * 128;
          const float av[4] = {m[0], m[64], m[32], m[96]};
          const int ia = 8 * c2 + 2 * tq, ib = ia + 1;
          uint32_t ah[4], al[4];
          split4(av, ah, al);
#pragma unroll
          for (int n = 0; n < UN; ++n) {
            const int p0 = (ug * UN + n) * 8 + gr;
            mma3(u[t2][n], ah, al, sV1[ia * LS + p0], sV1[ib * LS + p0]);
          }
        }
      }
    }

    // + w_j G^T B_j: G (N x P) into sV2, B's slabs into U0 and U1 (M is
    // spent); x stays in sV0 and dy in sV1
    __syncthreads();
    load_tile(sV2, LS, gbuf + bhc * N * P, P, Nz, SLAB, N, P, vec & 16);
    load_bc(sU, sU1, Bb, bss, vec & 2);
    cp_wait();
    __syncthreads();
    if (act) {
#pragma unroll
      for (int t2 = 0; t2 < 2; ++t2) {
        if (t2 == 1 && !two) continue;
        const int ja = 16 * (t2 ? rB : rA) + gr, jb = ja + 8;
        float gb[UN][4];
        zero(gb);
        for (int n0 = 0; n0 < Nz; n0 += SLAB) {
          const float* tB = n0 ? sU1 : sU;
#pragma unroll 1
          for (int k0 = 0; k0 < SLAB; k0 += 8) {
            const int na = k0 + 2 * tq, nb = na + 1;
            const float av[4] = {tB[ja * LS + na], tB[jb * LS + na],
                                 tB[ja * LS + nb], tB[jb * LS + nb]};
            uint32_t ah[4], al[4];
            split4(av, ah, al);
#pragma unroll
            for (int n = 0; n < UN; ++n) {
              const int p0 = (ug * UN + n) * 8 + gr;
              mma3(gb[n], ah, al, sV2[(n0 + na) * LS + p0],
                   sV2[(n0 + nb) * LS + p0]);
            }
          }
        }
        // u += w GB; dx = dt u; x . u and W_j = dt_j x_j . (w GB)_j
        float xu[2] = {0.f, 0.f}, wx[2] = {0.f, 0.f};
#pragma unroll
        for (int n = 0; n < UN; ++n) {
          const int p = (ug * UN + n) * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = half ? jb : ja;
            const float w = swl[j];
            const float g0 = w * gb[n][2 * half];
            const float g1 = w * gb[n][2 * half + 1];
            const float u0 = u[t2][n][2 * half] + g0;
            const float u1 = u[t2][n][2 * half + 1] + g1;
            const float x0 = sV0[j * LS + p], x1 = sV0[j * LS + p + 1];
            xu[half] = fmaf(x1, u1, fmaf(x0, u0, xu[half]));
            wx[half] = fmaf(x1, g1, fmaf(x0, g0, wx[half]));
            if (p < P && j < Qv)
              *reinterpret_cast<float2*>(
                  dx + (((size_t)b * S + t0 + j) * H + h) * P + p) =
                  make_float2(sdt[j] * u0, sdt[j] * u1);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xu[r] = quad_sum(xu[r]);
          wx[r] = quad_sum(wx[r]);
        }
        if (tq == 0) {
          sXu[ug * QM + ja] = xu[0];
          sXu[ug * QM + jb] = xu[1];
          sWx[ug * QM + ja] = sdt[ja] * wx[0];
          sWx[ug * QM + jb] = sdt[jb] * wx[1];
        }
      }
    }

    // S_in into sV0 (x is spent), C's slabs into U0 and U1: <S_in, G>,
    // C S_in and the starting-state term of dcum_i, exp(cum_i) dy_i .
    // (C S_in)_i, dy still in sV1
    __syncthreads();
    load_tile(sV0, LS, states + bhc * N * P, P, Nz, SLAB, N, P, vec & 16);
    load_bc(sU, sU1, Cb, css, vec & 4);
    cp_wait();
    __syncthreads();
    {
      float part = 0.f;
      for (int e = tid; e < N * P; e += T) {
        const int n = e / P, p = e - n * P;
        part = fmaf(sV0[n * LS + p], sV2[n * LS + p], part);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
    }
    if (row_act) {
      float cs[CN][4];
      zero(cs);
      for (int n0 = 0; n0 < Nz; n0 += SLAB) {
        const float* tC = n0 ? sU1 : sU;
#pragma unroll 1
        for (int k0 = 0; k0 < SLAB; k0 += 8) {
          const int na = k0 + 2 * tq, nb = na + 1;
          const float av[4] = {tC[ra * LS + na], tC[rb * LS + na],
                               tC[ra * LS + nb], tC[rb * LS + nb]};
          uint32_t ah[4], al[4];
          split4(av, ah, al);
#pragma unroll
          for (int n = 0; n < CN; ++n) {
            const int p0 = (cg * CN + n) * 8 + gr;
            mma3(cs[n], ah, al, sV0[(n0 + na) * LS + p0],
                 sV0[(n0 + nb) * LS + p0]);
          }
        }
      }
      float ip[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const int p = (cg * CN + n) * 8 + 2 * tq;
        ip[0] += sV1[ra * LS + p] * cs[n][0] + sV1[ra * LS + p + 1] * cs[n][1];
        ip[1] += sV1[rb * LS + p] * cs[n][2] + sV1[rb * LS + p + 1] * cs[n][3];
      }
      ip[0] = quad_sum(ip[0]);
      ip[1] = quad_sum(ip[1]);
      if (tq == 0) {
        sIp[cg * QM + ra] = ip[0];
        sIp[cg * QM + rb] = ip[1];
      }
    }
    __syncthreads();
    if (hl + 1 < hn) {  // the next head's x and dy, while this one ends
      load_tile(sV0, LS, xb + xsh, xss, Qp, SLAB, Qv, P, vec & 1);
      load_tile(sV1, LS, yb + P, ys, Qp, SLAB, Qv, P, vec & 8);
    }
    if (tid < Qp) {
      float si = 0.f, sj = 0.f, xu = 0.f, wx = 0.f, ip = 0.f;
      // T's sums over the tiles of column tid / 8 (rows r <= tid / 16)
      // and of row tile tid / 16, tile (r, c) numbered row-major
      const int ct = tid >> 3, rt_ = tid >> 4;
      for (int r = 0, base = 0; 2 * r <= ct; base += 2 * (nt - r), ++r)
        si += sTp[(base + ct - 2 * r) * 24 + 16 + (tid & 7)];
      int base = 0;
      for (int r = 0; r < rt_; ++r) base += 2 * (nt - r);
      for (int c2 = 2 * rt_; c2 < 2 * nt; ++c2)
        sj += sTp[(base + c2 - 2 * rt_) * 24 + (tid & 15)];
      for (int g = 0; g < UG; ++g) {
        xu += sXu[g * QM + tid];
        wx += sWx[g * QM + tid];
      }
      for (int g = 0; g < CG; ++g) ip += sIp[g * QM + tid];
      srow[tid] = si;
      scol[tid] = sj;
      sdd[tid] = xu;
      sW[tid] = wx;
      sI[tid] = sec[tid] * ip;
    }
    __syncthreads();
    // dcum -> da (the reverse cumsum over the chunk, in f64), ddt, dA's
    // share: warp 0, lane l the steps 4l .. 4l + 3, fixed-order shuffles
    if (warp == 0) {
      double v[4], own = 0.0, wsum = 0.0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * lane + q;
        v[q] = t < Qv ? (double)srow[t] - (double)scol[t] + (double)sI[t] -
                            (double)sW[t]
                      : 0.0;
        own += v[q];
        wsum += t < Qv ? (double)sW[t] : 0.0;
      }
      double suf = own;  // the sum over lanes >= this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
      wsum = __shfl_sync(0xffffffffu, wsum, 0);  // one value for every lane
      double after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.0;
      // dcl: the recurrence's term exp(cl) <S_in, G> and the chunk-state
      // terms; cl = cum at the chunk's last step
      float sg = 0.f;
      for (int w = 0; w < W; ++w) sg += red[w];
      double run = (double)(sg * expf(clp.x) + (float)wsum) + after;
      const float Ah = __ldg(A + h);
      double da_dt = 0.0;
#pragma unroll
      for (int q = 3; q >= 0; --q) {
        const int t = 4 * lane + q;
        run += v[q];
        if (t < Qv) {
          const float da = (float)run;
          ddt[((size_t)b * S + t0 + t) * H + h] = sdd[t] + da * Ah;
          da_dt += (double)da * (double)sdt[t];
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        da_dt += __shfl_xor_sync(0xffffffffu, da_dt, o);
      if (lane == 0) dApart[bhc] = (float)da_dt;
    }
  }

  // ---- c. the group's dB and dC: its sum of R into sU as U[i][j]; warp
  // (rt, cg) the rows of tile rt and the slabs of N that cg picks
  __syncthreads();  // every read of the last head is done
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    if (!sv(k)) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sU[(8 * sc(k) + 2 * tq + (e & 1)) * LU + 16 * sr(k) + gr +
         8 * (e >> 1)] = sRs[(warp + W * k) * 128 + 32 * e + lane];
  }
  float acc[2][NSL][8][4];  // dB, dC
#pragma unroll
  for (int q = 0; q < NSL; ++q) {
    zero(acc[0][q]);
    zero(acc[1][q]);
  }
  // dB += (sum R)^T C over i >= j, k-slots i = k0 + 2t, k0 + 2t + 1;
  // dC += (sum R) B over j <= i, k-slots j = k0 + t, k0 + t + 4; C's, then
  // B's slabs in sV0 and sV2
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    const bool is_b = pass == 0;
    __syncthreads();  // sum R is in sU; the last slabs are spent
    load_bc(sV0, sV2, is_b ? Cb : Bb, is_b ? css : bss,
            vec & (is_b ? 4 : 2));
    cp_wait();
    __syncthreads();
    if (!row_act) continue;
    const int k_lo = is_b ? 16 * rt : 0, k_hi = is_b ? Qp : 16 * rt + 16;
    for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
      int ka, kb;
      float av[4];
      if (is_b) {
        ka = k0 + 2 * tq;
        kb = ka + 1;
        av[0] = sU[ka * LU + ra];
        av[1] = sU[ka * LU + rb];
        av[2] = sU[kb * LU + ra];
        av[3] = sU[kb * LU + rb];
      } else {
        ka = k0 + tq;
        kb = ka + 4;
        av[0] = sU[ra * LU + ka];
        av[1] = sU[rb * LU + ka];
        av[2] = sU[ra * LU + kb];
        av[3] = sU[rb * LU + kb];
      }
      uint32_t ah[4], al[4];
      split4(av, ah, al);
#pragma unroll
      for (int q = 0; q < NSL; ++q) {
        const float* tX = (cg * NSL + q) ? sV2 : sV0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma3(acc[pass][q][n], ah, al, tX[ka * LS + n * 8 + gr],
               tX[kb * LS + n * 8 + gr]);
      }
    }
  }
  // + sum over the group's heads of (w dt x)_h G_h^T (dB) and (exp(cum)
  // dy)_h S_in,h^T (dC): x_h and G_h in sV1 and sV0, dy_h and S_in,h in U0
  // and sV2 (sum R is spent), each pair loaded while the other is used
  auto stage = [&](int hl, bool is_b) {
    const int h = h0 + hl;
    const size_t bhc = ((size_t)b * H + h) * nc + c;
    if (is_b) {
      load_tile(sV0, LS, gbuf + bhc * N * P, P, Nz, SLAB, N, P, vec & 16);
      load_tile(sV1, LS, x + b * xsb + (long long)t0 * xss + h * xsh, xss,
                Qp, SLAB, Qv, P, vec & 1);
    } else {
      load_tile(sV2, LS, states + bhc * N * P, P, Nz, SLAB, N, P, vec & 16);
      load_tile(sU, LS, dy + (((size_t)b * S + t0) * H + h) * P, ys, Qp,
                SLAB, Qv, P, vec & 8);
    }
    cp_commit();
  };
  __syncthreads();  // sum R and the slabs are spent
  stage(0, true);
  stage(0, false);
  for (int hl = 0; hl < hn; ++hl) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      // in flight: this pair, the other pair of this head (pass 0) or the
      // next head's first pair (pass 1, but the last head's)
      if (pass == 0 || hl + 1 < hn)
        cp_wait_group<1>();
      else
        cp_wait_group<0>();
      __syncthreads();
      if (row_act) {
        const float* tA = pass ? sU : sV1;
        const float* tS = pass ? sV2 : sV0;
        const float* fv = (pass ? sEC : sWD) + hl * QM;
        const float fa = fv[ra], fb = fv[rb];
#pragma unroll 1
        for (int k0 = 0; k0 < SLAB; k0 += 8) {
          const int p0 = k0 + tq, p1 = p0 + 4;
          const float av[4] = {tA[ra * LS + p0] * fa, tA[rb * LS + p0] * fb,
                               tA[ra * LS + p1] * fa, tA[rb * LS + p1] * fb};
          uint32_t ah[4], al[4];
          split4(av, ah, al);
#pragma unroll
          for (int q = 0; q < NSL; ++q) {
            const int n0 = (cg * NSL + q) * SLAB;
#pragma unroll
            for (int n = 0; n < 8; ++n)
              mma3(acc[pass][q][n], ah, al, tS[(n0 + n * 8 + gr) * LS + p0],
                   tS[(n0 + n * 8 + gr) * LS + p1]);
          }
        }
      }
      __syncthreads();  // this pair's tiles are spent
      if (hl + 1 < hn) stage(hl + 1, pass == 0);
    }
  }
  if (!row_act) return;
  const size_t share = ((size_t)grp * Bn + b) * S + t0;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float* out = (pass ? dCpart : dBpart) + share * N;
#pragma unroll
    for (int q = 0; q < NSL; ++q) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = (cg * NSL + q) * SLAB + n * 8 + 2 * tq;
        if (col >= N) continue;
        if (ra < Qv)
          *reinterpret_cast<float2*>(out + (size_t)ra * N + col) =
              make_float2(acc[pass][q][n][0], acc[pass][q][n][1]);
        if (rb < Qv)
          *reinterpret_cast<float2*>(out + (size_t)rb * N + col) =
              make_float2(acc[pass][q][n][2], acc[pass][q][n][3]);
      }
    }
  }
}

// 4. out[e] = sum over the shares of part[s][e], in order
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ out, int shares,
    long long M) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e >= M) return;
  float s = 0.f;
  for (int g = 0; g < shares; ++g) s += part[(size_t)g * M + e];
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
// dBpart and dCpart (ceil(H / HEAD_GROUP),B,S,N), dApart (B,H,chunks).
// Q <= 128, P <= 64, N <= 128, both multiples of 4.  Six launches on the
// stream; returns the first cudaError_t (0 on success).
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
  if (Q < 1 || Q > QM || P < 4 || P > SLAB || N < 4 || N > 2 * SLAB ||
      P % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + Q - 1) / Q, Qp = (Q + 15) & ~15, NP = N * P;
  const int groups = (H + HEAD_GROUP - 1) / HEAD_GROUP;
  const size_t smem_c = chunk_smem_bytes(), smem_a = adj_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_c);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_adj_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where a tensor's base and row strides allow them
  auto aligned = [](const float* p, long long s0, long long s1,
                    long long s2) {
    return (uintptr_t)p % 16 == 0 && s0 % 4 == 0 && s1 % 4 == 0 &&
           s2 % 4 == 0;
  };
  const int vec = (aligned(x, xsb, xss, xsh) ? 1 : 0) |
                  (aligned(Bm, bsb, bss, 0) ? 2 : 0) |
                  (aligned(Cm, csb, css, 0) ? 4 : 0) |
                  (aligned(dy, 0, 0, 0) ? 8 : 0) |
                  (aligned(states, 0, 0, 0) && aligned(gbuf, 0, 0, 0) ? 16
                                                                     : 0);
  const float2* cum2 = reinterpret_cast<const float2*>(cum);
  ssd_bwd_adj_kernel<<<dim3(nc, groups, B), BT, smem_a, st>>>(
      Cm, csb, css, dy, cum2, gbuf, S, H, P, N, Q, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_pass_kernel<<<dim3((NP / 4 + PASS_THREADS - 1) / PASS_THREADS, H,
                             B),
                        PASS_THREADS, 0, st>>>(gbuf, cum2, dstate, H, NP, nc,
                                               Qp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<<<dim3(nc, groups, B), CHUNK_THREADS, smem_c, st>>>(
      x, xsb, xss, xsh, dt, dsb, dss, dsh, A, Bm, bsb, bss, Cm, csb, css, dy,
      states, gbuf, cum2, dx, ddt, dBpart, dCpart, dApart, B, S, H, P, N, Q,
      vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long M = (long long)B * S * N;
  const int blocks = (int)((M + 255) / 256);
  ssd_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(dBpart, dB, groups, M);
  ssd_bwd_reduce_kernel<<<blocks, 256, 0, st>>>(dCpart, dC, groups, M);
  ssd_bwd_reduce_a_kernel<<<(H + 127) / 128, 128, 0, st>>>(dApart, dA, B, H,
                                                           nc);
  return (int)cudaGetLastError();
}

const char* ssdb_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
