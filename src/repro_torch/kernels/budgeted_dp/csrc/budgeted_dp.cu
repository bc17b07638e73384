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
// Fused forward (dp_chunk_kernel).  One launch per chunk of <= 32 edges,
// one block per instance.  The TPU kernel relied on its grid running tiles
// in row-major order on one core; on Hopper blocks run in no order, so a
// block walks its own instance's tiles in row-major order.  A tile lives in
// shared memory for the whole chunk, with an up halo of u_max rows (only if
// the plane has several S-tiles) above it and a left halo of off_max
// columns (only with several C-tiles) to its left.  Before edge k of the
// chunk a tile reads its neighbours' boundaries *before edge k* from two
// history buffers in device memory (the TPU kernel's VMEM scratches):
//   lefth (chunk, block_s, off_max): the left tile's last off_max columns;
//     read, then overwritten with this tile's own, by the same thread;
//   rowh (2 banks, chunk, u_max, C): the previous S-row's bottom u_max
//     rows, banked by S-row parity so the up-left corner read never races
//     the current row's writes.
// S-tile 0 clamps its reads to row 0 of the plane (the clamp row V[0]); the
// left halo of C-tile 0 is never loaded, since only states c < off_e, which
// are masked, would read it.  Inside a tile the in-place hazard of the
// whole-plane kernel returns (reads go to smaller row-major scratch
// indices), and the same staged top-down sweep handles it.  The plane is
// updated in place across chunks: a tile reads and writes only its own
// cells of V, and halos come from the histories.  What bounds it: the
// serial chain of edge steps in one SM per instance, ~S*C/1024 cells per
// thread and edge plus two barriers per 8192-cell chunk; bytes (the plane
// once per chunk, histories ~2*u_max*C ints per S-tile and edge) and
// operations are far below the card's rates.
//
// Epilogue.  One block per instance: a block-wide first-index argmax of
// s + sqrtf((float)v) over the feasible s <= s_limit, then one thread walks
// the E edges from (s*, full_state).  It must be compiled WITHOUT
// --use_fast_math: the score needs IEEE-rounded sqrtf or s* flips.
//
// The int32 arithmetic with NEG = -2^29 keeps every NEG-seeded chain below
// zero for sums < 2^29 (the f32 Pallas kernels stopped at 2^24).  wgmma, TMA
// and clusters are of no use to this integer shift-and-max DP.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
constexpr int FWD_THREADS = 1024;
constexpr int ITEMS = 8;  // cells a thread stages per chunk
constexpr int EPI_THREADS = 256;
constexpr int EDGE_THREADS = 256;

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

// The histories and the plane are read after this block wrote them, so
// their pointers are neither const nor __restrict__ (no non-coherent
// loads); vin may be vout.
__global__ void __launch_bounds__(FWD_THREADS)
dp_chunk_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
                const int* __restrict__ alw,  // (B, E) or nullptr
                const int* __restrict__ feas, const int* __restrict__ offs,
                const int* vin, int vin_stride, int* vout, unsigned* words,
                int* rowh, int* lefth, int E, int S, int C, int lo, int hi,
                int hu, int hl, int bs, int bc) {
  extern __shared__ int sm[];  // (hu + bs) x (hl + bc), body at [hu:, hl:]
  const int b = blockIdx.x;
  const int n_e = hi - lo;
  const int n_si = (S + bs - 1) / bs;
  const int n_cj = (C + bc - 1) / bc;
  const int ws = hl + bc;  // scratch row width
  const int body = bs * bc;
  const size_t SC = (size_t)S * C;
  const int* vin_b = vin + (size_t)b * vin_stride;
  int* vout_b = vout + (size_t)b * SC;
  unsigned* words_b = words + (size_t)b * ((E + 31) >> 5) * SC;
  int* rowh_b = rowh + (size_t)b * 2 * n_e * hu * C;
  int* lefth_b = lefth + (size_t)b * n_e * bs * hl;
  const int* ups_b = ups + (size_t)b * E;
  const int* sig_b = sig + (size_t)b * E;
  const int* alw_b = alw == nullptr ? nullptr : alw + (size_t)b * E;
  const int chunk = blockDim.x * ITEMS;

  for (int ti = 0; ti < n_si; ++ti) {
    const int s0 = ti * bs;
    int* rowh_rd = rowh_b + (size_t)((ti + 1) & 1) * n_e * hu * C;
    int* rowh_wr = rowh_b + (size_t)(ti & 1) * n_e * hu * C;
    for (int tj = 0; tj < n_cj; ++tj) {
      const int c0 = tj * bc;
      for (int t = threadIdx.x; t < body; t += blockDim.x) {
        const int r = t / bc;
        const int cc = t - r * bc;
        const int s = s0 + r;
        const int c = c0 + cc;
        sm[(hu + r) * ws + hl + cc] =
            s < S && c < C ? vin_b[(size_t)s * C + c] : NEG;
      }
      __syncthreads();

      for (int k = 0; k < n_e; ++k) {
        const int e = hi - 1 - k;
        // the halos hold at most hu rows and hl columns: clamp (the host
        // checks max Y <= u_max on CPU inputs, as the JAX kernel clamps)
        const int u = min(max(ups_b[e], 0), hu > 0 ? hu : S);
        const int off = hl > 0 ? min(offs[e], hl) : offs[e];
        const int sg = sig_b[e];
        const bool on = alw_b == nullptr || alw_b[e] != 0;
        const int* feas_e = feas + (size_t)e * C;
        unsigned* word = words_b + (size_t)(e >> 5) * SC;
        const unsigned bit = 1u << (e & 31);

        if (hl > 0) {  // left halo for edge k, then this tile's boundary
          int* lh = lefth_b + (size_t)k * bs * hl;
          for (int t = threadIdx.x; t < bs * hl; t += blockDim.x) {
            const int r = t / hl;
            const int q = t - r * hl;
            if (tj > 0) sm[(hu + r) * ws + q] = lh[t];
            lh[t] = sm[(hu + r) * ws + bc + q];
          }
        }
        if (hu > 0) {  // up halo (with the up-left corner) for edge k
          const int* up = rowh_rd + (size_t)k * hu * C;
          int* mine = rowh_wr + (size_t)k * hu * C;
          if (ti > 0) {
            for (int t = threadIdx.x; t < hu * ws; t += blockDim.x) {
              const int r = t / ws;
              const int q = t - r * ws;
              const int c = c0 - hl + q;
              if (c >= 0 && c < C) sm[r * ws + q] = up[(size_t)r * C + c];
            }
          }
          for (int t = threadIdx.x; t < hu * bc; t += blockDim.x) {
            const int r = t / bc;
            const int cc = t - r * bc;
            if (c0 + cc < C) {
              mine[(size_t)r * C + c0 + cc] = sm[(bs + r) * ws + hl + cc];
            }
          }
        }
        __syncthreads();

        for (int top = body; top > 0; top -= chunk) {
          const int bot = max(top - chunk, 0);
          int staged[ITEMS];
#pragma unroll
          for (int it = 0; it < ITEMS; ++it) {
            const int t = bot + it * blockDim.x + threadIdx.x;
            if (t < top) {
              const int r = t / bc;
              const int cc = t - r * bc;
              const int s = s0 + r;
              const int c = c0 + cc;
              const int pos = (hu + r) * ws + hl + cc;
              const int v = sm[pos];
              int nv = v;
              if (s < S && c < C) {
                int take = NEG;
                if (on && c >= off && feas_e[c] != 0) {
                  const int rr = ti == 0 ? max(r - u, 0) : r - u;
                  take = sm[(hu + rr) * ws + hl + cc - off] + sg;
                }
                if (take > v) {
                  nv = take;
                  word[(size_t)s * C + c] |= bit;
                }
              }
              staged[it] = nv;
            }
          }
          __syncthreads();  // every read of this chunk precedes its writes
#pragma unroll
          for (int it = 0; it < ITEMS; ++it) {
            const int t = bot + it * blockDim.x + threadIdx.x;
            if (t < top) {
              const int r = t / bc;
              sm[(hu + r) * ws + hl + (t - r * bc)] = staged[it];
            }
          }
        }
        __syncthreads();  // the next edge reads the whole updated tile
      }

      for (int t = threadIdx.x; t < body; t += blockDim.x) {
        const int r = t / bc;
        const int cc = t - r * bc;
        const int s = s0 + r;
        const int c = c0 + cc;
        if (s < S && c < C) {
          vout_b[(size_t)s * C + c] = sm[(hu + r) * ws + hl + cc];
        }
      }
      __syncthreads();  // the next tile reuses the scratch
    }
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

// Fused forward of edges hi-1 ... lo for B instances, one block each, on
// (bs, bc) tiles with hu halo rows and hl halo columns (0 when the plane
// has one S-tile / one C-tile).  rowh holds B * 2 * (hi-lo) * hu * C ints,
// lefth B * (hi-lo) * bs * hl.
int dp_chunk_launch(const int* ups, const int* sig, const int* alw,
                    const int* feas, const int* offs, const int* vin,
                    int vin_stride, int* vout, unsigned* words, int* rowh,
                    int* lefth, int B, int E, int S, int C, int lo, int hi,
                    int hu, int hl, int bs, int bc, void* stream) {
  const size_t smem = (size_t)(hu + bs) * (hl + bc) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dp_chunk_kernel<<<B, FWD_THREADS, smem, (cudaStream_t)stream>>>(
      ups, sig, alw, feas, offs, vin, vin_stride, vout, words, rowh, lefth, E,
      S, C, lo, hi, hu, hl, bs, bc);
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
