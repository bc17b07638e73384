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
// limit is one block's 232,448 bytes, tiling.py).  The edges run in series,
// so what bounds it is each edge's dependent chain: a read of the plane, a
// block barrier, the writes, a second barrier.  The design keeps every
// device-memory access and every per-cell predicate off that chain:
// - Each thread owns the same cells for the whole solve, i = t + m*Tu
//   (m = 0, 1, ...), their coordinates worked out once.  Where Tu, the
//   owning threads, can be a multiple of C with at most 1/16 of the block
//   idle, all of a thread's cells share one capacity column: an edge's
//   mask is one predicate a thread, and cell i reads i - (u C + off), or
//   row 0 of its column where the budget shift reaches past it (a max).
//   Otherwise (C > 1024, or a C that leaves more threads idle) a thread
//   steps its cells' (s, c) by adds and tests each column.  No division
//   inside the loop.
// - An edge's operands come from registers: at each 32-edge word a warp
//   holds the word's Υ̂, Σ̂², offsets and allowed flags, one edge a lane,
//   and each thread its column's feasibility as 32 bits, loaded once a
//   word; an edge reads its own by shuffles.  A barrier waits for every
//   load before it, so a load per edge would put a memory latency on each
//   edge.
// - Register-held cells (512 threads, <= FIT_ITEMS = 22 cells a thread,
//   22 at Table 2): the plane is also held in registers.  Cells past the
//   plane hold INT_MAX, which no take exceeds, and read the plane's last
//   cell, so no cell needs a predicate.  An edge reads each cell's source
//   from shared memory (all reads issued before any compare), writes back
//   only the cells that changed, and ORs each
//   decision bit into a register that is stored once, when the 32-edge
//   word's last edge is done, so the words need no zeroing pass.  Two
//   barriers an edge: every read precedes the first write, every write
//   precedes the next edge's reads.
// - The tiled sweep (1024 threads, up to 57 cells a thread, chunks of 16;
//   512 threads and chunks of 8 where each cell has its own column): every
//   read goes to a linear index s'*C + c' <= s*C + c, so the plane is
//   swept in chunks from the top index down; a chunk stages its new values
//   in registers and writes them back after one barrier, and a barrier
//   ends the edge (one barrier a chunk, plus one).  Its cells stay in
//   shared memory only, and a decision bit goes out as a fire-and-forget
//   atomicOr (red.global.or) into words zeroed at the start.  The threads
//   past Tu own no cell and are masked in every chunk.  One column a
//   thread takes half the barriers and no per-cell feasibility load, and
//   ran in about half the time of a column a cell on the fig-6 planes;
//   dp_forward_sweep_launch forces either layout, to time them.
// - An edge that is not allowed changes no cell whose value is >= NEG.  If
//   the seed plane holds none below NEG (a block-wide vote at the start;
//   max never lowers a value), such an edge is skipped with its barriers.
// What still bounds it: one SM's issue rate over the edge's cells (~10
// instructions a cell) between two block barriers, E times in series.
// Int32 max and add do not depend on order, so the result is bit-exact.

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
// the E edges from (s*, full_state).  Its tabled instance reads edge e's
// decision where a table puts it, for a forward run in segments that pack
// their own words (the warm re-solve's carried planes, ops.WarmCudaSolver;
// the JAX package's jnp select_back in kernels/budgeted_dp/ops.py).  It must be compiled WITHOUT
// --use_fast_math: the score needs IEEE-rounded sqrtf or s* flips.
//
// The int32 arithmetic with NEG = -2^29 keeps every NEG-seeded chain below
// zero for sums < 2^29 (the f32 Pallas kernels stopped at 2^24).  wgmma and
// TMA are of no use to this integer shift-and-max DP; a cluster of blocks
// sharing one instance's plane over distributed shared memory would split
// an edge's work, at the price of a cluster barrier an edge.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 29);
// 512 threads (128 registers a thread) for register-held cells and for
// the sweep with a column a cell; 1024 for the one-column sweep
constexpr int FIT_THREADS = 512;
constexpr int FIT_ITEMS = 22;        // cells a thread holds: 22 at Table 2
constexpr int SWEEP_THREADS = 1024;
constexpr int CHUNK_ITEMS = 16;      // cells a thread stages per chunk
constexpr int EPI_THREADS = 256;
constexpr int EDGE_THREADS = 256;
constexpr int CHUNK_THREADS = 512;

namespace cg = cooperative_groups;

// One 32-edge word's operands for one instance, held across a warp: lane l
// has edge 32w + l's Υ̂ (clamped at 0), Σ̂², offset and allowed flag, and
// (one-column ownership) every thread has its column's feasibility for the
// word's edges as bits.  An edge reads them with shuffles, so no memory
// access sits between its barriers.
struct WordOps {
  int u, sg, off, on;
  unsigned fz;
};

template <bool ONE_COL>
__device__ __forceinline__ WordOps word_ops(const int* ups_b, const int* sig_b,
                                            const int* alw_b, const int* offs,
                                            const int* feas_c, int C, int E,
                                            int w) {
  const int e = w * 32 + (threadIdx.x & 31);
  const bool in = e < E;
  WordOps o;
  o.u = in ? max(__ldg(ups_b + e), 0) : 0;
  o.sg = in ? __ldg(sig_b + e) : 0;
  o.off = in ? __ldg(offs + e) : 0;
  o.on = in && (alw_b == nullptr || __ldg(alw_b + e) != 0);
  o.fz = 0u;
  if constexpr (ONE_COL) {
#pragma unroll
    for (int k0 = 0; k0 < 32; k0 += 8) {
      int f[8];  // eight loads in flight before any is used
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ek = w * 32 + k0 + k;
        f[k] = ek < E ? __ldg(feas_c + (size_t)ek * C) : 0;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) o.fz |= (unsigned)(f[k] != 0) << (k0 + k);
    }
  }
  return o;
}

// One chunk of K cells a thread of the tiled sweep (cells q*K .. q*K+K-1):
// reads, compares (bits by atomicOr), a barrier, writes.  CHECK: the chunk
// may hold cells past the thread's last (only the top chunk does).  A
// thread t >= Tu owns no cell (one column a thread, 1024 % C > 0) and is
// masked in every chunk: its cells t + m*Tu would be another thread's, one
// chunk up, already written this edge.
template <int K, bool ONE_COL, bool CHECK>
__device__ __forceinline__ void sweep_chunk(
    int* plane, unsigned* word, const int* feas_e, int q, int t, int Tu,
    int Mt, int C, int u, int sg, int off, bool on, bool live_col, int colc,
    int& s, int& c, int ds, int dc, unsigned bit) {
  int take[K];
  if constexpr (ONE_COL) {
    const int base = t - u * C - off;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int m = q * K + k;
      const bool ok = CHECK ? m < Mt : t < Tu;
      const int v = plane[ok ? max(base + m * Tu, colc) : 0];
      take[k] = live_col && ok ? v + sg : NEG;
    }
  } else {
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
      const int m = q * K + k;
      const bool ok = !CHECK || m < Mt;  // every thread owns cells here
      const bool live = ok && on && c >= off && __ldg(feas_e + c) != 0;
      const int v = plane[ok ? max(s - u, 0) * C + max(c - off, 0) : 0];
      take[k] = live ? v + sg : NEG;
      s -= ds;  // one cell down
      c -= dc;
      if (c < 0) {
        c += C;
        --s;
      }
    }
  }
  unsigned changed = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m = q * K + k;
    const bool ok = CHECK ? m < Mt : !ONE_COL || t < Tu;
    const int i = t + m * Tu;
    if (ok && take[k] > plane[ok ? i : 0]) {
      atomicOr(word + i, bit);
      changed |= 1u << k;
    }
  }
  __syncthreads();  // every read of these cells precedes their writes
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (changed >> k & 1u) plane[t + (q * K + k) * Tu] = take[k];
}

// FIT (with ONE_COL only): the thread's <= FIT_ITEMS cells and their
// decision bits live in registers.  Else the tiled sweep: chunks of cells,
// bits by atomicOr.
// ONE_COL: Tu is a multiple of C, so all of a thread's cells share column
// c_top and cell i reads i - (u C + off), or row 0 of its column where the
// budget shift reaches past it; else Tu = blockDim.x and each cell has its
// own column.  Each chunk issues all its reads before it compares, so
// their latencies overlap.
template <bool FIT, bool ONE_COL>
__global__ void __launch_bounds__(!FIT && ONE_COL ? SWEEP_THREADS
                                                : FIT_THREADS)
dp_forward_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
                  const int* __restrict__ alw,  // (B, E) or nullptr
                  const int* __restrict__ feas, const int* __restrict__ offs,
                  const int* __restrict__ v0, int* __restrict__ vout,
                  unsigned* __restrict__ words, int E, int S, int C, int Tu) {
  static_assert(ONE_COL || !FIT, "register-held cells need one column");
  // a cell with its own column carries its coordinates: half the chunk
  constexpr int K = FIT ? FIT_ITEMS : ONE_COL ? CHUNK_ITEMS : CHUNK_ITEMS / 2;
  extern __shared__ int plane[];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int SC = S * C;
  const int W = (E + 31) >> 5;
  const int* ups_b = ups + (size_t)b * E;
  const int* sig_b = sig + (size_t)b * E;
  const int* alw_b = alw == nullptr ? nullptr : alw + (size_t)b * E;
  unsigned* words_b = words + (size_t)b * W * SC;

  // thread t < Tu owns cells t + m*Tu, m < Mt; walks start at m_top
  const int M = (SC + Tu - 1) / Tu;  // cells of the busiest thread
  const int Mt = t < Tu && t < SC ? (SC - t + Tu - 1) / Tu : 0;
  const int nq = FIT ? 1 : (M + K - 1) / K;
  const int m_top = nq * K - 1;
  const int i_top = t + m_top * Tu;
  const int s_top = i_top / C, c_top = i_top - s_top * C;
  const int ds = Tu / C, dc = Tu - ds * C;  // one cell on: ONE_COL dc == 0
  const int* feas_c = feas + c_top;

  bool floor_ok = true;
  int val[FIT ? K : 1];
  unsigned bits[FIT ? K : 1];
  if constexpr (FIT) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      val[m] = m < Mt ? v0[t + m * Tu] : INT_MAX;
      bits[m] = 0u;
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
      if (m < Mt) {
        plane[t + m * Tu] = val[m];
        floor_ok &= val[m] >= NEG;
      }
    }
  } else {
#pragma unroll 8
    for (int i = t; i < SC; i += blockDim.x) {
      const int v = v0[i];
      plane[i] = v;
      floor_ok &= v >= NEG;
    }
    for (int i = t; i < W * SC; i += blockDim.x) words_b[i] = 0u;
  }
  WordOps ops;
  if (E > 0)
    ops = word_ops<ONE_COL>(ups_b, sig_b, alw_b, offs, feas_c, C, E, W - 1);
  floor_ok = __syncthreads_and(floor_ok);

  for (int e = E - 1; e >= 0; --e) {
    const int l = e & 31;
    if (l == 31 && e != E - 1)  // a new word: its operands, once
      ops = word_ops<ONE_COL>(ups_b, sig_b, alw_b, offs, feas_c, C, E, e >> 5);
    const int u = __shfl_sync(0xffffffffu, ops.u, l);
    const int sg = __shfl_sync(0xffffffffu, ops.sg, l);
    const int off = __shfl_sync(0xffffffffu, ops.off, l);
    const bool on = __shfl_sync(0xffffffffu, ops.on, l) != 0;
    const unsigned bit = 1u << l;
    const bool live_col = on && c_top >= off && (ops.fz >> l & 1u);
    const int colc = max(c_top - off, 0);  // in the plane even if not live
    if (!(floor_ok && !on)) {
      if constexpr (FIT) {
        // the cells' addresses are recomputed each edge, not held across
        // the loop in K registers each (an opaque copy of Tu)
        int tu = Tu;
        asm volatile("" : "+r"(tu));
        // a cell past the plane reads its last cell; all reads are issued
        // before the compares
        const int base = t - u * C - off, top = SC - 1;
        int take[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = plane[min(max(base + k * tu, colc), top)];
          take[k] = live_col ? v + sg : NEG;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (take[k] > val[k]) {
            val[k] = take[k];
            bits[k] |= bit;
          }
        }
        __syncthreads();  // every read of the plane precedes a write
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (bits[k] & bit) plane[t + k * tu] = val[k];
      } else {
        unsigned* word = words_b + (size_t)(e >> 5) * SC;
        const int* feas_e = feas + (size_t)e * C;
        int s = s_top, c = c_top;  // !ONE_COL: cell m's coordinates
        sweep_chunk<K, ONE_COL, true>(plane, word, feas_e, nq - 1, t, Tu, Mt,
                                      C, u, sg, off, on, live_col, colc, s, c,
                                      ds, dc, bit);
        for (int q = nq - 2; q >= 0; --q)
          sweep_chunk<K, ONE_COL, false>(plane, word, feas_e, q, t, Tu, Mt, C,
                                         u, sg, off, on, live_col, colc, s, c,
                                         ds, dc, bit);
      }
      __syncthreads();  // the next edge reads the whole updated plane
    }
    if constexpr (FIT) {
      if (l == 0) {  // the word's last edge: store it once
        unsigned* word = words_b + (size_t)(e >> 5) * SC;
#pragma unroll
        for (int m = 0; m < K; ++m) {
          if (m < Mt) word[t + m * Tu] = bits[m];
          bits[m] = 0u;
        }
      }
    }
  }

  int* vout_b = vout + (size_t)b * SC;
  if constexpr (FIT) {
#pragma unroll
    for (int m = 0; m < K; ++m)
      if (m < Mt) vout_b[t + m * Tu] = val[m];
  } else {
    for (int i = t; i < SC; i += blockDim.x) vout_b[i] = plane[i];
  }
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

// TABLED: edge e's decision is bit bits[e] of word word_rows[e] (a forward
// run in segments that number their edges from 0, W words in all); else
// bit e % 32 of word e / 32, with W = ceil(E / 32).
template <bool TABLED>
__global__ void __launch_bounds__(EPI_THREADS)
dp_epilogue_kernel(const int* __restrict__ vout,
                   const unsigned* __restrict__ words,
                   const int* __restrict__ ups, const int* __restrict__ offs,
                   const int* __restrict__ s_limit,
                   const int* __restrict__ word_rows,
                   const int* __restrict__ bits, int full_state, int E,
                   int W, int S, int C, int* __restrict__ x,
                   int* __restrict__ s_star, int* __restrict__ value_row) {
  __shared__ float best_score[EPI_THREADS];
  __shared__ int best_s[EPI_THREADS];
  const int b = blockIdx.x;
  const int SC = S * C;
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
      const int row = TABLED ? word_rows[e] : e >> 5;
      const int bit = TABLED ? bits[e] : e & 31;
      const unsigned w = words_b[(size_t)row * SC + s * C + cs];
      const int d = (int)((w >> bit) & 1u);
      x[(size_t)b * E + e] = d;
      if (d) {
        s = max(s - ups_b[e], 0);
        cs -= offs[e];
      }
    }
    s_star[b] = star;
  }
}

// One capacity column a thread of T where at most 1/16 of them would idle.
bool one_col_suits(int C, int T) { return C <= T && T % C <= T / 16; }

// One block of T threads (Tu of them owning cells) per instance, the plane
// in dynamic shared memory.
int launch_forward(void (*kern)(const int*, const int*, const int*,
                                const int*, const int*, const int*, int*,
                                unsigned*, int, int, int, int),
                   int T, int Tu, const int* ups, const int* sig,
                   const int* alw, const int* feas, const int* offs,
                   const int* v0, int* vout, unsigned* words, int B, int E,
                   int S, int C, void* stream) {
  const size_t smem = (size_t)S * C * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<B, T, smem, (cudaStream_t)stream>>>(
      ups, sig, alw, feas, offs, v0, vout, words, E, S, C, Tu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole-plane forward's tiled sweep with its cell layout given: one
// capacity column a thread (one_col != 0, needs C <= 1024) or a column a
// cell, whatever (S, C) would pick.  dp_forward_launch below calls it for
// every plane past the register-held layout; chip_smoke.py times the two
// layouts against each other on the same planes through it.  In every
// launcher alw may be null (every edge allowed), and the return value is
// the cudaError_t of the launch (0 on success).
int dp_forward_sweep_launch(const int* ups, const int* sig, const int* alw,
                            const int* feas, const int* offs, const int* v0,
                            int* vout, unsigned* words, int B, int E, int S,
                            int C, int one_col, void* stream) {
  if (one_col && C > SWEEP_THREADS) return (int)cudaErrorInvalidValue;
  if (one_col)
    return launch_forward(dp_forward_kernel<false, true>, SWEEP_THREADS,
                          SWEEP_THREADS / C * C, ups, sig, alw, feas, offs,
                          v0, vout, words, B, E, S, C, stream);
  return launch_forward(dp_forward_kernel<false, false>, FIT_THREADS,
                        FIT_THREADS, ups, sig, alw, feas, offs, v0, vout,
                        words, B, E, S, C, stream);
}

// Whole-plane forward for B instances, one block each.
int dp_forward_launch(const int* ups, const int* sig, const int* alw,
                      const int* feas, const int* offs, const int* v0,
                      int* vout, unsigned* words, int B, int E, int S, int C,
                      void* stream) {
  // register-held cells where they fit FIT_ITEMS a thread; else the tiled
  // sweep, one column a thread where it suits C
  const bool fit = one_col_suits(C, FIT_THREADS) &&
                   (S * C + FIT_THREADS / C * C - 1) / (FIT_THREADS / C * C) <=
                       FIT_ITEMS;
  if (fit)
    return launch_forward(dp_forward_kernel<true, true>, FIT_THREADS,
                          FIT_THREADS / C * C, ups, sig, alw, feas, offs, v0,
                          vout, words, B, E, S, C, stream);
  return dp_forward_sweep_launch(ups, sig, alw, feas, offs, v0, vout, words,
                                 B, E, S, C,
                                 one_col_suits(C, SWEEP_THREADS) ? 1 : 0,
                                 stream);
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

// The epilogue for B instances, one block each.  word_rows and bits are
// both null (edge e in bit e % 32 of word e / 32, W = ceil(E / 32)) or
// both an (E,) table over W words a plane.
int dp_epilogue_launch(const int* vout, const unsigned* words, const int* ups,
                       const int* offs, const int* s_limit,
                       const int* word_rows, const int* bits, int full_state,
                       int B, int E, int W, int S, int C, int* x, int* s_star,
                       int* value_row, void* stream) {
  if ((word_rows == nullptr) != (bits == nullptr))
    return (int)cudaErrorInvalidValue;
  if (word_rows == nullptr) {
    dp_epilogue_kernel<false><<<B, EPI_THREADS, 0, (cudaStream_t)stream>>>(
        vout, words, ups, offs, s_limit, nullptr, nullptr, full_state, E,
        (E + 31) >> 5, S, C, x, s_star, value_row);
  } else {
    dp_epilogue_kernel<true><<<B, EPI_THREADS, 0, (cudaStream_t)stream>>>(
        vout, words, ups, offs, s_limit, word_rows, bits, full_state, E, W,
        S, C, x, s_star, value_row);
  }
  return (int)cudaGetLastError();
}

const char* dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
