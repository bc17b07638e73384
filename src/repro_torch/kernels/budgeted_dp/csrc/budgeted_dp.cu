// Budgeted DP of ESDP (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/budgeted_dp/kernel.py::_dp_kernel          (K1, one instance)
//   kernels/budgeted_dp/kernel.py::_dp_kernel_batched  (K2, a seed fleet)
// with ONE __global__ forward launched one block per instance, and moves the
// eq.-17 s* rule and the packed-word backtrack (a lax.scan in
// kernels/budgeted_dp/ops.py::_solve/_solve_batched) into a second kernel,
// so a dispatch slot needs no host sync and no per-edge launches.
//
// Forward.  The whole (S x C) int32 value plane sits in dynamic shared
// memory (44 KB at the paper's Table-2 instance, 160 KB at the fig-6
// c_hi = 4 sweep point; smem_bytes() in kernel.py is the gate).  Edges run
// E-1 ... 0 inside the block; per edge every cell (s, c) computes
//   take = V[max(s - u_e, 0), c - off_e] + sig_e   (NEG if c < off_e, the
//          state is infeasible or the edge is not allowed)
//   dec  = take > V,   V = max(V, take).
// The update reads cells that other threads write in the same edge step.
// Every read goes to a linear index s'*C + c' <= s*C + c (s' <= s, c' <= c),
// so the plane is swept in chunks of THREADS*ITEMS cells from the top index
// down: a chunk stages its new values in registers, and after one
// __syncthreads writes them back.  A chunk reads only cells below its upper
// end, which are either its own (still old, staged) or lower chunks' (not yet
// written), so no second plane copy is needed — that is what lets the 160 KB
// plane run at all (two copies would take 320 KB).
// Decision bits go straight into the packed output words, as K1 does: the
// block zeroes its words first and ORs bit e % 32 into word e / 32 of a cell
// only where take > V.
//
// What bounds it.  One instance moves ~180 KB of device memory at Table 2
// (v0, feasibility, V, the words), ~50 ns at 3.35 TB/s, and does ~3.6 M
// integer operations; neither is the limit.  The limit is the serial chain
// of E block-wide steps, each a chunk sweep plus a barrier, in one SM per
// instance.  A fleet (B = 64) runs one block per instance on its own SM.
// The int32 arithmetic with NEG = -2^29 keeps every NEG-seeded chain below
// zero for sums < 2^29 (the f32 Pallas kernel stopped at 2^24).
//
// Epilogue.  One block per instance: a block-wide first-index argmax of
// s + sqrtf((float)v) over the feasible s <= s_limit, then one thread walks
// the E edges from (s*, full_state).  It must be compiled WITHOUT
// --use_fast_math: the score needs IEEE-rounded sqrtf or s* flips.
//
// wgmma, TMA and clusters are of no use to this integer shift-and-max DP.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
constexpr int FWD_THREADS = 1024;
constexpr int ITEMS = 8;  // cells a thread stages per chunk
constexpr int EPI_THREADS = 256;

__global__ void __launch_bounds__(FWD_THREADS)
dp_forward_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
                  const int* __restrict__ alw,  // (B, E) or nullptr
                  const int* __restrict__ feas, const int* __restrict__ offs,
                  const int* __restrict__ v0, int* __restrict__ vout,
                  unsigned* __restrict__ words, int E, int S, int C) {
  extern __shared__ int plane[];
  const int b = blockIdx.x;
  const int SC = S * C;
  const int W = (E + 31) >> 5;
  const int* ups_b = ups + (size_t)b * E;
  const int* sig_b = sig + (size_t)b * E;
  const int* alw_b = alw == nullptr ? nullptr : alw + (size_t)b * E;
  unsigned* words_b = words + (size_t)b * W * SC;

  for (int i = threadIdx.x; i < SC; i += blockDim.x) plane[i] = v0[i];
  for (int i = threadIdx.x; i < W * SC; i += blockDim.x) words_b[i] = 0u;
  __syncthreads();

  const int chunk = blockDim.x * ITEMS;
  for (int e = E - 1; e >= 0; --e) {
    const int u = max(ups_b[e], 0);
    const int sg = sig_b[e];
    const int off = offs[e];
    const bool on = alw_b == nullptr || alw_b[e] != 0;
    const int* feas_e = feas + (size_t)e * C;
    unsigned* word = words_b + (size_t)(e >> 5) * SC;
    const unsigned bit = 1u << (e & 31);
    for (int hi = SC; hi > 0; hi -= chunk) {
      const int lo = max(hi - chunk, 0);
      int staged[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = lo + k * blockDim.x + threadIdx.x;
        if (i < hi) {
          const int s = i / C;
          const int c = i - s * C;
          const int v = plane[i];
          int take = NEG;
          if (on && c >= off && feas_e[c] != 0) {
            take = plane[max(s - u, 0) * C + (c - off)] + sg;
          }
          staged[k] = max(v, take);
          if (take > v) word[i] |= bit;
        }
      }
      __syncthreads();  // every read of this chunk precedes its writes
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = lo + k * blockDim.x + threadIdx.x;
        if (i < hi) plane[i] = staged[k];
      }
    }
    __syncthreads();  // the next edge reads the whole updated plane
  }

  int* vout_b = vout + (size_t)b * SC;
  for (int i = threadIdx.x; i < SC; i += blockDim.x) vout_b[i] = plane[i];
}

__global__ void __launch_bounds__(EPI_THREADS)
dp_epilogue_kernel(const int* __restrict__ vout,
                   const unsigned* __restrict__ words,
                   const int* __restrict__ ups, const int* __restrict__ offs,
                   const int* __restrict__ s_limit, int full_state, int E,
                   int S, int C, int* __restrict__ x,
                   int* __restrict__ s_star, int* __restrict__ value_row) {
  __shared__ float best_score[EPI_THREADS];
  __shared__ int best_s[EPI_THREADS];
  const int b = blockIdx.x;
  const int SC = S * C;
  const int W = (E + 31) >> 5;
  const int* v_b = vout + (size_t)b * SC;
  const int lim = s_limit[b];

  // each thread scans s in increasing order, so a strict > keeps the first
  float best = -INFINITY;
  int arg = S;  // sentinel above every index
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = v_b[s * C + full_state];
    value_row[(size_t)b * S + s] = v >= 0 ? v : NEG;
    if (v >= 0 && s <= lim) {
      const float score = (float)s + sqrtf((float)v);
      if (score > best) {
        best = score;
        arg = s;
      }
    }
  }
  best_score[threadIdx.x] = best;
  best_s[threadIdx.x] = arg;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      const float o = best_score[threadIdx.x + half];
      const int os = best_s[threadIdx.x + half];
      const float m = best_score[threadIdx.x];
      if (o > m || (o == m && os < best_s[threadIdx.x])) {
        best_score[threadIdx.x] = o;
        best_s[threadIdx.x] = os;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    // no feasible s: argmax over an all -inf score row is index 0
    const int star = best_s[0] == S ? 0 : best_s[0];
    const unsigned* words_b = words + (size_t)b * W * SC;
    const int* ups_b = ups + (size_t)b * E;
    int s = star;
    int cs = full_state;
    for (int e = 0; e < E; ++e) {
      const unsigned w = words_b[(size_t)(e >> 5) * SC + s * C + cs];
      const int d = (int)((w >> (e & 31)) & 1u);
      x[(size_t)b * E + e] = d;
      if (d) {
        s = max(s - ups_b[e], 0);
        cs -= offs[e];
      }
    }
    s_star[b] = star;
  }
}

}  // namespace

extern "C" {

// Forward for B instances, one block each.  alw may be null (every edge
// allowed).  Returns the cudaError_t of the launch (0 on success).
int dp_forward_launch(const int* ups, const int* sig, const int* alw,
                      const int* feas, const int* offs, const int* v0,
                      int* vout, unsigned* words, int B, int E, int S, int C,
                      void* stream) {
  const size_t smem = (size_t)S * C * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dp_forward_kernel<<<B, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      ups, sig, alw, feas, offs, v0, vout, words, E, S, C);
  return (int)cudaGetLastError();
}

int dp_epilogue_launch(const int* vout, const unsigned* words, const int* ups,
                       const int* offs, const int* s_limit, int full_state,
                       int B, int E, int S, int C, int* x, int* s_star,
                       int* value_row, void* stream) {
  dp_epilogue_kernel<<<B, EPI_THREADS, 0, (cudaStream_t)stream>>>(
      vout, words, ups, offs, s_limit, full_state, E, S, C, x, s_star,
      value_row);
  return (int)cudaGetLastError();
}

const char* dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
