// Budgeted DP of ESDP (paper Algorithm 2) for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels (kernels/budgeted_dp/)
//   kernel.py::_dp_kernel, _dp_kernel_batched     (K1, K2)  dp_forward_kernel
//   kernel.py::_edge_tile_kernel, _edge_stile_kernel (K3)   dp_edge_kernel
//   kernel.py::_fused_chunk_kernel, _batched_fused_kernel
//                                                 (K4, K5)  dp_chunk_kernel
// and moves the eq.-17 s* rule and the packed-word backtrack (a lax.scan in
// kernels/budgeted_dp/ops.py::_solve/_solve_batched) into dp_epilogue_kernel,
// so a dispatch slot needs no host sync.  Every forward is batch-first: B
// instances share the feasibility plane, the offsets and the seed plane and
// mask their own `allowed` in the kernel.  Per edge every cell (s, c) does
//   take = V[max(s - u_e, 0), c - off_e] + sig_e   (NEG if c < off_e, the
//          state is infeasible or the edge is not allowed)
//   dec  = take > V,   V = max(V, take),
// and ORs bit e % 32 of word e / 32 where dec holds.
//
// Whole-plane forward (dp_forward_kernel).  The (S x C) int32 plane sits in
// dynamic shared memory, one block per instance, for all E edges (44 KB at
// the paper's Table-2 instance, 160 KB at the fig-6 c_hi = 4 point; the
// limit is one block's 232,448 bytes, tiling.py).  The update reads cells
// that other threads write in the same edge step, but every read goes to a
// linear index s'*C + c' <= s*C + c, so the plane is swept in chunks of
// THREADS*ITEMS cells from the top index down: a chunk stages its new values
// in registers and writes them back after one __syncthreads.  No second
// plane copy is needed, which is what lets the 160 KB plane run at all.
//
// Per-edge forward (dp_edge_kernel).  One launch per edge; one thread per
// cell, EDGE_THREADS cells per block and a grid row of blocks per instance,
// reads the plane `vin` in device memory and writes `vout` (the host
// ping-pongs two buffers), so it runs a plane of any size.  The TPU kernel's
// halos become plain reads of the input plane, so the JAX tiling knobs
// (block_s, block_c) only pick this pipeline and do not shape the grid,
// which fills the card at any tiling.  What bounds it: each edge moves the
// plane and its word through device memory (~1.2 MB at fig-6 c_hi = 6),
// ~0.4 us at 3.35 TB/s, below one launch's latency; it is the pipeline of
// last resort.
//
// Fused forward (dp_chunk_kernel).  One cooperative launch per chunk of
// <= 32 edges, its grid every block the card holds at once (occupancy x
// SMs, at most one thread per cell).  The B*S*C cells of all instances
// are spread over the grid, and each thread keeps the same cells for the
// whole chunk.  Per edge it applies the update above from one plane in
// device memory to the other (vout and a scratch plane, ping-ponged so
// that the last edge writes vout), ORs the edge's bit into its own cells'
// word (the owner is the only writer, so no atomics), and the grid meets
// at cooperative_groups' grid barrier before the next edge.  The TPU
// kernel's halos and tiles become plain reads of the input plane, as in
// the per-edge kernel, so the JAX tiling knobs only pick this pipeline.
// The TPU kernel ran an instance's tiles in order on one core; a block per
// instance walking them here would keep one SM busy for ~72 us an edge
// while the others idle, so an edge is instead one pass of the whole card
// over the planes, which stay in L2 at B = 1 (0.4 MB each at fig-6
// c_hi = 6).  What bounds it: the grid barrier per edge (a few us) at
// B = 1; at B = 64 the planes (26 MB each) and words move through L2 and
// device memory once per edge.  Int32 max and add do not depend on order,
// so the result is bit-exact.
//
// Epilogue.  One block per instance: a block-wide first-index argmax of
// s + sqrtf((float)v) over the feasible s <= s_limit, then one thread walks
// the E edges from (s*, full_state).  It must be compiled WITHOUT
// --use_fast_math: the score needs IEEE-rounded sqrtf or s* flips.
//
// The int32 arithmetic with NEG = -2^29 keeps every NEG-seeded chain below
// zero for sums < 2^29 (the f32 Pallas kernels stopped at 2^24).  wgmma, TMA
// and clusters are of no use to this integer shift-and-max DP.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
constexpr int FWD_THREADS = 1024;
constexpr int ITEMS = 8;  // cells a thread stages per chunk
constexpr int EPI_THREADS = 256;
constexpr int EDGE_THREADS = 256;
constexpr int CHUNK_THREADS = 512;

namespace cg = cooperative_groups;

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

__global__ void __launch_bounds__(EDGE_THREADS)
dp_edge_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
               const int* __restrict__ alw,  // (B, E) or nullptr
               const int* __restrict__ feas, const int* __restrict__ offs,
               const int* __restrict__ vin, int vin_stride,
               int* __restrict__ vout, unsigned* __restrict__ words, int E,
               int S, int C, int e) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * C) return;
  const int s = i / C;
  const int c = i - s * C;
  const size_t SC = (size_t)S * C;
  const int* vin_b = vin + (size_t)b * vin_stride;
  unsigned* word = words + ((size_t)b * ((E + 31) >> 5) + (e >> 5)) * SC;
  const int u = max(ups[(size_t)b * E + e], 0);
  const int off = offs[e];
  const bool on = alw == nullptr || alw[(size_t)b * E + e] != 0;
  const int v = vin_b[i];
  int take = NEG;
  if (on && c >= off && feas[(size_t)e * C + c] != 0) {
    take = vin_b[(size_t)max(s - u, 0) * C + (c - off)] +
           sig[(size_t)b * E + e];
  }
  vout[(size_t)b * SC + i] = max(v, take);
  if (take > v) word[i] |= 1u << (e & 31);
}

// The planes are read after other blocks wrote them in this launch, so
// their pointers are neither const nor __restrict__ (no non-coherent
// loads); vin may be vout.  Thread t of the grid owns the cells
// t, t + step, ... of the B*S*C cells (step = the grid's threads), the
// same cells for every edge; it walks their (b, s, c) coordinates by
// mixed-radix adds, with no division inside the loop.
__global__ void __launch_bounds__(CHUNK_THREADS)
dp_chunk_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
                const int* __restrict__ alw,  // (B, E) or nullptr
                const int* __restrict__ feas, const int* __restrict__ offs,
                const int* vin, int vin_stride, int* vout, int* scratch,
                unsigned* words, int B, int E, int S, int C, int lo,
                int hi) {
  cg::grid_group grid = cg::this_grid();
  const unsigned SC = (unsigned)S * C;
  const unsigned cells = (unsigned)B * SC;  // < 2^31, checked at launch
  const unsigned first = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const unsigned step = gridDim.x * CHUNK_THREADS;
  const int b0 = first / SC, s0 = first % SC / C, c0 = first % C;
  const int db = step / SC, ds = step % SC / C, dc = step % C;
  const int n_e = hi - lo;
  const int W = (E + 31) >> 5;
  // edge k of the chunk writes vout when n_e - 1 - k is even, so the last
  // edge writes vout; the first reads vin.  When vin is vout and the
  // first edge would write it, the plane is first copied to scratch.
  const int* src = vin;
  unsigned src_stride = (unsigned)vin_stride;
  if (vin == vout && (n_e & 1)) {
    for (unsigned i = first; i < cells; i += step) {
      const unsigned b = i / SC;
      scratch[i] = vin[b * src_stride + (i - b * SC)];
    }
    grid.sync();
    src = scratch;
    src_stride = SC;
  }
  for (int k = 0; k < n_e; ++k) {
    const int e = hi - 1 - k;
    int* dst = ((n_e - 1 - k) & 1) ? scratch : vout;
    const int off = offs[e];
    const int* feas_e = feas + (size_t)e * C;
    const unsigned bit = 1u << (e & 31);
    int b = b0, s = s0, c = c0;
    for (unsigned i = first; i < cells; i += step) {
      const int* src_b = src + b * src_stride;
      const int v = src_b[s * C + c];
      int take = NEG;
      if ((alw == nullptr || alw[b * E + e] != 0) && c >= off &&
          feas_e[c] != 0) {
        take = src_b[max(s - max(ups[b * E + e], 0), 0) * C + (c - off)] +
               sig[b * E + e];
      }
      dst[i] = max(v, take);
      // the cell's owner is the only writer of its word: no atomics
      if (take > v)
        words[((size_t)b * W + (e >> 5)) * SC + (i - b * SC)] |= bit;
      c += dc;
      s += ds;
      b += db;
      if (c >= C) {
        c -= C;
        ++s;
      }
      if (s >= S) {
        s -= S;
        ++b;
      }
    }
    if (k + 1 < n_e) grid.sync();  // the next edge reads this edge's plane
    src = dst;
    src_stride = SC;
  }
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

// Whole-plane forward for B instances, one block each.  In every launcher
// alw may be null (every edge allowed), and the return value is the
// cudaError_t of the launch (0 on success).
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

int dp_edge_launch(const int* ups, const int* sig, const int* alw,
                   const int* feas, const int* offs, const int* vin,
                   int vin_stride, int* vout, unsigned* words, int B, int E,
                   int S, int C, int e, void* stream) {
  const dim3 grid((S * C + EDGE_THREADS - 1) / EDGE_THREADS, B);
  dp_edge_kernel<<<grid, EDGE_THREADS, 0, (cudaStream_t)stream>>>(
      ups, sig, alw, feas, offs, vin, vin_stride, vout, words, E, S, C, e);
  return (int)cudaGetLastError();
}

// Fused forward of edges hi-1 ... lo for B instances: one cooperative
// launch whose grid is every block the card holds at once (at most one
// thread per cell).  scratch holds B * S * C ints.
int dp_chunk_launch(const int* ups, const int* sig, const int* alw,
                    const int* feas, const int* offs, const int* vin,
                    int vin_stride, int* vout, int* scratch, unsigned* words,
                    int B, int E, int S, int C, int lo, int hi,
                    void* stream) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dp_chunk_kernel, CHUNK_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // at most one thread per cell; the kernel indexes cells in 32 bits
  const long long cells = (long long)B * S * C;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long need = (cells + CHUNK_THREADS - 1) / CHUNK_THREADS;
  const int blocks = (int)(need < (long long)per_sm * n_sm
                               ? need
                               : (long long)per_sm * n_sm);
  void* args[] = {(void*)&ups,  (void*)&sig,        (void*)&alw,
                  (void*)&feas, (void*)&offs,       (void*)&vin,
                  (void*)&vin_stride, (void*)&vout, (void*)&scratch,
                  (void*)&words, (void*)&B,         (void*)&E,
                  (void*)&S,    (void*)&C,          (void*)&lo,
                  (void*)&hi};
  err = cudaLaunchCooperativeKernel((const void*)dp_chunk_kernel,
                                    dim3(blocks > 0 ? blocks : 1),
                                    dim3(CHUNK_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
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
