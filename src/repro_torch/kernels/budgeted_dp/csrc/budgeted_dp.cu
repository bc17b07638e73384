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

// Per-edge forward (dp_edge_kernel).  One launch per edge; it reads the
// plane `vin` in device memory and writes `vout` (the host ping-pongs two
// buffers), so it runs a plane of any size.  The TPU kernel's halos become
// plain reads of the input plane, so the JAX tiling knobs (block_s,
// block_c) only pick this pipeline and do not shape the grid, which fills
// the card at any tiling.  An edge moves the plane and its word through
// L2 (~1.2 MB at fig-6 c_hi = 6, ~0.4 us at 3.35 TB/s), less than one
// launch's latency, so what bounds it is each cell's chain of dependent
// memory round trips and the launch itself:
// - The edge's operands (Υ̂, Σ̂², the offset, the allowed flag) are one
//   broadcast load each, and each thread's feasibility entries are issued
//   with them, before any plane load; only the gather of vin waits on Υ̂
//   and the offset.  Two round trips a cell: the operands, then the plane.
// - A thread owns EDGE_ITEMS cells EDGE_THREADS apart (coalesced), finds
//   its first cell's (s, c) with one division and steps the others by
//   adds.  All its plane loads are issued before any compare.  Two cells
//   a thread (twice the blocks) doubled the chained pipeline's span at
//   fig-6 c_hi = 6.
// - A decision bit goes out as a fire-and-forget atomicOr (red.global.or)
//   where it is set: the word is never read.
// - dp_edge_chain_launch starts an edge with Hopper's programmatic
//   dependent launch: every edge lets the next one start at once
//   (griddepcontrol.launch_dependents), and the next loads its operands,
//   then waits for this edge's writes (griddepcontrol.wait) before it
//   reads vin.  Its plane loads bypass L1 (ld.global.cg), since a block
//   of the edge before may still run on the same SM.  The per-edge
//   pipeline (kernel.py::dp_forward_blocked) chains every edge after its
//   first, whose stream predecessor is some other kernel.
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
// Epilogue (dp_epilogue_kernel).  One block of EPI_THREADS per instance.
// It computes the eq.-17 s* rule (the first argmax of s + sqrtf((float)v)
// over the feasible s <= s_limit) and walks the E edges from
// (s*, full_state): edge e's decision d is a bit of the packed words at
// the walk's cell, and a taken edge moves it to (max(s - Υ̂_e, 0),
// c - off_e).  Walked by one thread, that is one dependent L2 load an
// edge, about half the time at E = 33; a loop of dependent column loads
// and a nine-barrier reduction tree for s* took the other half.  So:
// - Loads first: each thread issues its EPI_ITEMS column loads and the
//   staging loads of one edge's operands (Υ̂ of the instance, the offset,
//   the tabled instance's word row and bit) before it uses any, and the
//   block stages every per-edge operand of the walk in shared memory.
// - s*: a warp-shuffle argmax with the first-index tie rule, then each
//   thread folds the eight warps' maxima itself: one barrier.
// - Look-ahead walk, warp 0: a window of EPI_WINDOW = 5 edges is a
//   decision tree of 31 nodes, a node being the prefix of taken/not-taken
//   decisions before its edge.  Lane n takes node n (depth d =
//   floor(log2 n), its prefix the bits of n below the leading one).  The
//   node's cell is a function of the window's first cell that its lane
//   works out from the stage while the window before is in flight
//   (NodeOps), so a window costs one L2 round trip: every lane moves the
//   window's first cell to its node's and loads its decision bit there,
//   the ballot of the bits shows which nodes lie on the true path (each
//   ancestor's decision leads to them), and the path's last node hands
//   the window's last cell to the next window by shuffles.  E = 33 takes
//   7 round trips, not 33.  The path and every decision are the serial
//   walk's, so x and s* are bit-exact.  A block-wide window of 8 edges
//   (255 nodes, a barrier a window) ran slower at E 15 and 33.
// Its tabled instance reads edge e's decision where a table puts it, for
// a forward run in segments that pack their own words (the warm
// re-solve's carried planes, ops.WarmCudaSolver; the JAX package's jnp
// select_back in kernels/budgeted_dp/ops.py).  It must be compiled
// WITHOUT --use_fast_math: the score needs IEEE-rounded sqrtf or s* flips.
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
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_ITEMS = 4;      // column entries a thread loads at once
constexpr int EPI_STAGE = 512;    // edges whose operands are staged at once
constexpr int EPI_WINDOW = 5;     // edges a look-ahead window resolves
constexpr int EDGE_THREADS = 256;
constexpr int EDGE_ITEMS = 4;   // cells a thread of the per-edge kernel
constexpr int EDGE_CELLS = EDGE_THREADS * EDGE_ITEMS;
constexpr unsigned FULL_MASK = 0xffffffffu;
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

// A load that bypasses L1 (ld.global.cg) and that the compiler keeps
// after griddepcontrol.wait (volatile, with a memory clobber).
__device__ __forceinline__ int load_cg(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Thread t of block x owns cells x * EDGE_CELLS + t + k * EDGE_THREADS,
// k < EDGE_ITEMS.  vin is not __restrict__: a chained launch reads it after
// the edge before wrote it (vin and vout are distinct buffers).
__global__ void __launch_bounds__(EDGE_THREADS)
dp_edge_kernel(const int* __restrict__ ups, const int* __restrict__ sig,
               const int* __restrict__ alw,  // (B, E) or nullptr
               const int* __restrict__ feas, const int* __restrict__ offs,
               const int* vin, int vin_stride, int* __restrict__ vout,
               unsigned* __restrict__ words, int E, int S, int C, int e) {
  // a chained launch of the next edge may start now and load its operands
  asm volatile("griddepcontrol.launch_dependents;");
  const int b = blockIdx.y;
  const int SC = S * C;
  const int first = blockIdx.x * EDGE_CELLS + threadIdx.x;
  // the edge's operands and the thread's feasibility entries first
  const size_t be = (size_t)b * E + e;
  const int u = max(__ldg(ups + be), 0);
  const int sg = __ldg(sig + be);
  const int off = __ldg(offs + e);
  const bool on = alw == nullptr || __ldg(alw + be) != 0;
  const int* feas_e = feas + (size_t)e * C;
  const int ds = EDGE_THREADS / C, dc = EDGE_THREADS - ds * C;
  int s = first / C, c = first - s * C;  // the thread's one division
  int cs[EDGE_ITEMS], ss[EDGE_ITEMS], fz[EDGE_ITEMS];
#pragma unroll
  for (int k = 0; k < EDGE_ITEMS; ++k) {
    ss[k] = s;
    cs[k] = c;
    fz[k] = first + k * EDGE_THREADS < SC ? __ldg(feas_e + c) : 0;
    s += ds;  // EDGE_THREADS cells on
    c += dc;
    if (c >= C) {
      c -= C;
      ++s;
    }
  }
  // a chained launch: the edge before has written vin (a no-op otherwise)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int* vin_b = vin + (size_t)b * vin_stride;
  int v[EDGE_ITEMS], g[EDGE_ITEMS];
#pragma unroll
  for (int k = 0; k < EDGE_ITEMS; ++k) {
    const int i = first + k * EDGE_THREADS;
    fz[k] = fz[k] != 0 && on && cs[k] >= off;  // the cell takes the edge
    v[k] = i < SC ? load_cg(vin_b + i) : 0;
    g[k] = fz[k] ? load_cg(vin_b + (size_t)max(ss[k] - u, 0) * C +
                           (cs[k] - off))
                 : 0;
  }
  int* vout_b = vout + (size_t)b * SC;
  unsigned* word = words + ((size_t)b * ((E + 31) >> 5) + (e >> 5)) * SC;
  const unsigned bit = 1u << (e & 31);
#pragma unroll
  for (int k = 0; k < EDGE_ITEMS; ++k) {
    const int i = first + k * EDGE_THREADS;
    if (i < SC) {
      const int take = fz[k] ? g[k] + sg : NEG;
      vout_b[i] = max(v[k], take);
      if (take > v[k]) atomicOr(word + i, bit);  // one writer a cell
    }
  }
}

// A launch of nothing, with a kernel's grid and block: the device time
// no launch beats (chip_smoke.py prints it beside each bound).
__global__ void empty_kernel() {}

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

// The per-edge operands of EPI_STAGE edges of one instance's walk (and
// EPI_WINDOW more, read past the last edge and never used).
template <bool TABLED>
struct EpiStage {
  int u[EPI_STAGE + EPI_WINDOW];
  int off[EPI_STAGE + EPI_WINDOW];
  int row[TABLED ? EPI_STAGE + EPI_WINDOW : 1];
  int bit[TABLED ? EPI_STAGE + EPI_WINDOW : 1];
};

// Edges lo + j0 .. lo + n - 1 into the stage, by threads j0, j0 + nt, ...
template <bool TABLED>
__device__ __forceinline__ void stage_edges(EpiStage<TABLED>& st,
                                            const int* ups_b, const int* offs,
                                            const int* word_rows,
                                            const int* bits, int lo, int j0,
                                            int n, int nt) {
  for (int j = j0; j < n; j += nt) {
    st.u[j] = __ldg(ups_b + lo + j);
    st.off[j] = __ldg(offs + lo + j);
    if constexpr (TABLED) {
      st.row[j] = __ldg(word_rows + lo + j);
      st.bit[j] = __ldg(bits + lo + j);
    }
  }
}

// One look-ahead window's operands for node t (depth d < EPI_WINDOW, its
// edge e0 + d), worked out from the stage before the walk reaches the
// window, since they do not depend on the walk's cell: the node's cell as
// a function of the window's first cell (s0, c0), s = max(s0 - a, l), c =
// c0 - o (the clamped steps max(s - Υ̂, 0) of its prefix compose so,
// whatever Υ̂'s sign), the same after its own edge is taken (a1, l1, o1),
// and its edge's decision bit: bit `bit` of the plane `word`.
struct NodeOps {
  int a, l, o, a1, l1, o1, bit;
  const unsigned* word;
};

template <bool TABLED>
__device__ __forceinline__ NodeOps node_ops(const EpiStage<TABLED>& st,
                                            const unsigned* words_b,
                                            size_t SC, int j0, int e0, int t,
                                            int depth) {
  NodeOps n;
  int a = 0, l = 0, o = 0;
#pragma unroll
  for (int j = 0; j < EPI_WINDOW - 1; ++j) {
    if (j < depth && (t >> (depth - 1 - j) & 1)) {
      const int u = st.u[j0 + j];
      a += u;
      l = max(l - u, 0);
      o += st.off[j0 + j];
    }
  }
  const int u = st.u[j0 + depth];
  n.a = a;
  n.l = l;
  n.o = o;
  n.a1 = a + u;
  n.l1 = max(l - u, 0);
  n.o1 = o + st.off[j0 + depth];
  int row = (e0 + depth) >> 5;
  n.bit = (e0 + depth) & 31;
  if constexpr (TABLED) {
    row = st.row[j0 + depth];
    n.bit = st.bit[j0 + depth];
  }
  n.word = words_b + (size_t)row * SC;
  return n;
}

// TABLED: edge e's decision is bit bits[e] of word word_rows[e] (a forward
// run in segments that number their edges from 0, W words in all); else
// bit e % 32 of word e / 32, with W = ceil(E / 32).  The window's
// 2^EPI_WINDOW - 1 nodes are lanes 1 .. 31 of warp 0.
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
  static_assert(1 << EPI_WINDOW == 32, "a window's nodes are one warp");
  __shared__ EpiStage<TABLED> st;
  __shared__ float warp_score[EPI_WARPS];
  __shared__ int warp_s[EPI_WARPS];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int SC = S * C;
  const int* ups_b = ups + (size_t)b * E;
  const int* col = vout + (size_t)b * SC + full_state;
  int* row_b = value_row + (size_t)b * S;

  // the first EPI_THREADS edges' operands, one a thread, and the first
  // EPI_ITEMS column entries, all loads issued before any is used
  const int n_stage = min(E, EPI_STAGE);
  int su = 0, so = 0, sr = 0, sb = 0;
  if (t < n_stage) {
    su = __ldg(ups_b + t);
    so = __ldg(offs + t);
    if constexpr (TABLED) {
      sr = __ldg(word_rows + t);
      sb = __ldg(bits + t);
    }
  }
  const int lim = s_limit[b];
  int v[EPI_ITEMS];
#pragma unroll
  for (int k = 0; k < EPI_ITEMS; ++k) {
    const int s = t + k * EPI_THREADS;
    v[k] = s < S ? col[(size_t)s * C] : -1;
  }
  // node t of a look-ahead window: its edge in the window (its depth),
  // and its ancestors as bits of a ballot (ancestor i is t >> (depth -
  // i)) with the decisions that lead from them to t; worked out while the
  // loads are in flight, and kept in registers, not worked out again from
  // the thread index in every window (a slow special-register read)
  int depth = t == 0 || t >= 32 ? 0 : 31 - __clz(t);
  unsigned anc = 0u, lead = 0u;
#pragma unroll
  for (int i = 0; i < EPI_WINDOW - 1; ++i) {
    if (i < depth) {
      anc |= 1u << (t >> (depth - i));
      lead |= (unsigned)(t >> (depth - 1 - i) & 1) << (t >> (depth - i));
    }
  }
  int lane = t;
  asm volatile("" : "+r"(lane), "+r"(depth), "+r"(anc), "+r"(lead));
  if (t < n_stage) {
    st.u[t] = su;
    st.off[t] = so;
    if constexpr (TABLED) {
      st.row[t] = sr;
      st.bit[t] = sb;
    }
  }
  stage_edges<TABLED>(st, ups_b, offs, word_rows, bits, 0, t + EPI_THREADS,
                      n_stage, EPI_THREADS);

  // s*: each thread takes s in increasing order, so a strict > keeps the
  // first; the reductions keep the smaller s of two equal scores
  float best = -INFINITY;
  int arg = S;  // sentinel above every index
  for (int lo = 0; lo < S; lo += EPI_ITEMS * EPI_THREADS) {
    if (lo > 0) {
#pragma unroll
      for (int k = 0; k < EPI_ITEMS; ++k) {
        const int s = lo + t + k * EPI_THREADS;
        v[k] = s < S ? col[(size_t)s * C] : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < EPI_ITEMS; ++k) {
      const int s = lo + t + k * EPI_THREADS;
      if (s < S) {
        row_b[s] = v[k] >= 0 ? v[k] : NEG;
        if (v[k] >= 0 && s <= lim) {
          const float score = (float)s + sqrtf((float)v[k]);
          if (score > best) {
            best = score;
            arg = s;
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_down_sync(FULL_MASK, best, o);
    const int oa = __shfl_down_sync(FULL_MASK, arg, o);
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  if ((t & 31) == 0) {
    warp_score[t >> 5] = best;
    warp_s[t >> 5] = arg;
  }
  __syncthreads();  // the warps' maxima and the stage
  best = warp_score[0];
  arg = warp_s[0];
#pragma unroll
  for (int w = 1; w < EPI_WARPS; ++w) {
    const float ob = warp_score[w];
    const int oa = warp_s[w];
    if (ob > best || (ob == best && oa < arg)) {
      best = ob;
      arg = oa;
    }
  }
  // no feasible s: argmax over an all -inf score row is index 0
  const int star = arg == S ? 0 : arg;
  if (t == 0) s_star[b] = star;

  if (t >= 32) return;  // warp 0 walks
  const unsigned* words_b = words + (size_t)b * W * SC;
  int s0 = star, c0 = full_state;  // the walk's cell at the window's start
  int base = 0;                    // the first staged edge
  NodeOps cur = node_ops<TABLED>(st, words_b, SC, 0, 0, lane, depth);
  for (int e0 = 0; e0 < E; e0 += EPI_WINDOW) {
    const int n_win = min(EPI_WINDOW, E - e0);
    const bool live = lane > 0 && depth < n_win;
    // node t's cell and the decision bit of its edge there; a cell off the
    // plane is on no path the forward took (s >= 0: l >= 0)
    const int s = max(s0 - cur.a, cur.l), c = c0 - cur.o;
    unsigned dec = 0u;
    if (live && (unsigned)c < (unsigned)C && s < S)
      dec = __ldg(cur.word + (s * C + c)) >> cur.bit & 1u;
    // the next window's operands while the load is in flight
    const int e1 = e0 + EPI_WINDOW;
    const bool restage =
        e1 < E && e1 + min(EPI_WINDOW, E - e1) > base + EPI_STAGE;
    NodeOps nxt = cur;
    if (e1 < E && !restage)
      nxt = node_ops<TABLED>(st, words_b, SC, e1 - base, e1, lane, depth);
    // the true path: the nodes whose ancestors' decisions lead to them,
    // one a depth, so the last is the highest; its leaf 2^n_win + the
    // decisions, first edge highest
    const unsigned m = __ballot_sync(FULL_MASK, dec);
    const unsigned on = __ballot_sync(FULL_MASK, live && (m & anc) == lead);
    const int n_last = 31 - __clz(on);
    // the window's last cell: node n_last's after its own decision
    const int a = __shfl_sync(FULL_MASK, dec ? cur.a1 : cur.a, n_last);
    const int l = __shfl_sync(FULL_MASK, dec ? cur.l1 : cur.l, n_last);
    const int o = __shfl_sync(FULL_MASK, dec ? cur.o1 : cur.o, n_last);
    s0 = max(s0 - a, l);
    c0 -= o;
    const int leaf = 2 * n_last + (int)(m >> n_last & 1u);
    if (lane < n_win)
      x[(size_t)b * E + e0 + lane] = leaf >> (n_win - 1 - lane) & 1;
    if (restage) {  // the next EPI_STAGE edges' operands
      __syncwarp();  // every read of the stage is done
      base = e1;
      stage_edges<TABLED>(st, ups_b, offs, word_rows, bits, base, lane,
                          min(E - base, EPI_STAGE), 32);
      __syncwarp();
      nxt = node_ops<TABLED>(st, words_b, SC, 0, e1, lane, depth);
    }
    cur = nxt;
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
  const dim3 grid((S * C + EDGE_CELLS - 1) / EDGE_CELLS, B);
  dp_edge_kernel<<<grid, EDGE_THREADS, 0, (cudaStream_t)stream>>>(
      ups, sig, alw, feas, offs, vin, vin_stride, vout, words, E, S, C, e);
  return (int)cudaGetLastError();
}

// dp_edge_launch chained to the kernel launched just before it on the
// stream (programmatic dependent launch): it may start, and load the
// edge's operands, while that kernel runs, so that kernel must write none
// of ups, sig, alw, feas, offs; it waits for that kernel's writes before
// it reads vin.
int dp_edge_chain_launch(const int* ups, const int* sig, const int* alw,
                         const int* feas, const int* offs, const int* vin,
                         int vin_stride, int* vout, unsigned* words, int B,
                         int E, int S, int C, int e, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S * C + EDGE_CELLS - 1) / EDGE_CELLS, B);
  cfg.blockDim = dim3(EDGE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, dp_edge_kernel, ups, sig, alw, feas, offs, vin,
                         vin_stride, vout, words, E, S, C, e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// empty_kernel on a grid of (gx, gy) blocks of `threads`.
int dp_empty_launch(int gx, int gy, int threads, void* stream) {
  empty_kernel<<<dim3(gx, gy), threads, 0, (cudaStream_t)stream>>>();
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
