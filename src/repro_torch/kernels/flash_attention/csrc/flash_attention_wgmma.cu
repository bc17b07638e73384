// Forward attention on Hopper's tensor cores (sm_90a): bf16 q, k, v with a
// head dim hd that is a multiple of 8 up to 256.
//
// Replaces the JAX package's Pallas TPU kernel
//   kernels/flash_attention/kernel.py::_flash_kernel (K6, via
//   flash_attention and ops.flash_attention_op)
// with flash_fwd_wgmma_kernel for bf16 inputs; f32 inputs go to
// flash_fwd_tf32_kernel (flash_attention_tf32.cu).  The wrapper
// (kernel.py) picks the kernel from the dtype alone.
//
// What bounds it: at the Zamba2-7B serving shape (B = 4, Sq = Sk = 2048,
// 32 heads, hd = 112, causal) the two products are ~120 GFLOP, 0.12 ms at
// the tensor cores' 989 TFLOP/s in bf16, over 235 MB of q, k, v and o
// (0.07 ms at 3.35 TB/s): operations.  flash_fwd_kernel ran them as f32
// FMAs on the CUDA cores (67 TFLOP/s at most, 1.8 ms even at full rate;
// 7.1 ms measured).  This kernel runs both on the tensor cores.  At
// gemma-7b's attention (B = 4, S = 2048, 16 heads, hd = 256, causal) the
// products are 137.5 GFLOP, 0.139 ms at 989 TFLOP/s, over 268 MB (0.08
// ms): operations again.
//
// - A block takes BM = 128 folded rows f = qi * g + gi of one (kv head,
//   batch row) — query position qi of each of the g heads that share kv
//   head kh (GQA), as the TPU kernel folds the group into its q block —
//   split over two warpgroups of 64 rows.  Blocks are issued longest
//   first (the causal rows near the end have the most keys).
// - Q is loaded once by the block's threads (any g, zero rows past the
//   end, zero columns past hd) into the 128-byte-swizzled layout that
//   wgmma reads; K/V tiles of FK = 64 keys arrive by TMA (4-D tensor maps
//   over (hd, KH, Sk, B), built on the host per call and passed as
//   __grid_constant__ parameters) into a ring of stages (Layout), each with
//   an mbarrier that counts the bytes.  Rows of 64 columns (128 bytes) are
//   the swizzle's span, so hd = 112 is two boxes per row; TMA fills the
//   columns >= hd and the keys >= Sk with zeros.
// - S = Q K^T: wgmma m64n64k16 with both operands in shared memory
//   (K-major), bf16 in, f32 accumulate; products of bf16 values are exact
//   in f32.  The scale is applied to S in f32 afterwards.
// - Online softmax in registers on the accumulator fragment (each thread
//   holds two rows of S; a row's max and sum are two shuffles over its
//   four threads), in base 2 (log2(e) folded into the scale, exp2f);
//   masked logits are NEG = -1e30, causal and window masks, query i at
//   position i + Sk - Sq, ragged ends masked, K/V tiles wholly above a
//   block's diagonal never loaded, the denominator max(l, 1e-30) — the
//   rules of flash_fwd_kernel and the JAX code.  Only tiles that cross the
//   end of K, a warpgroup's diagonal or a window evaluate the masks: the
//   softmax's instructions on the CUDA cores, not the products, set this
//   kernel's time.
// - O += p V: wgmma m64nDk16 with p from registers (the S fragment is the
//   A fragment) and V from shared memory, MN-major (the B-transpose bit).
//   p goes in as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//   two products against the same V tile: ~16 mantissa bits of p, the
//   nearest the tensor cores come to the Pallas kernel's f32 p.v, for 1.5x
//   the tensor-core work of one bf16 p.
// - O is normalised in registers, staged in the warpgroup's own rows of
//   the Q buffer and written with 16-byte stores.
//
// One producer warp beside the two consumer warpgroups (up to D = 128;
// below for wider rows): its first thread keeps the K/V stages in flight
// and refills a stage when every consumer thread has arrived on the
// stage's "empty" mbarrier, so the two warpgroups run apart and one's
// softmax overlaps the other's products.
//
// Head dims: hd runs on D = 64 ceil(hd / 64) padded columns, one to four
// 64-column boxes a row (D = 64, 128, 192, 256).  S = Q K^T takes D / 16
// k-steps of m64n64k16; O += p V is one m64nDk16 per 16 keys, N = D up to
// wgmma's 256.  Shared memory (Layout) is Q plus STAGES x (K, V): three
// stages up to D = 192 (192 KB there), two at D = 256 (three would need
// 256 KB of the 227 KB a block may have); each instance static_asserts
// its total.  Registers: at D = 256 a consumer thread holds the O
// accumulator (64 x 256 f32 over 128 threads, 128 registers), S (32) and
// p's two bf16 A fragments (32).  Each of an SM's four sub-partitions
// has 16,384 registers for the warps it holds: 288 threads (9 warps,
// three on one sub-partition) cap a thread at 168, where D = 192 and 256
// spill (setmaxnreg with a producer warpgroup left ptxas's cap at 168
// too).  So from D = 192 the block is the two consumer warpgroups alone,
// 256 threads, 8 warps, 255 registers a thread: thread 0 starts the
// first STAGES tiles, and after each tile the warpgroup that releases its
// stage second (a named barrier over its 128 threads, then an atomic
// count per stage in shared memory) loads the tile STAGES ahead, so a
// refill waits for no one.  D = 64 and 128 keep the producer warp (126
// and 154 registers, no spills).  chip_smoke.py prints ptxas's registers
// and spills of every instance and fails if D = 192 or 256 spills.

#include <cuda.h>  // CUtensorMap and its enums (the encoder: at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int BM = 128;        // folded rows per block
constexpr int FK = 64;         // keys per K/V tile
constexpr int CONSUMERS = 256; // two warpgroups
// and a producer warp up to D = 128; from D = 192 none: the warpgroup
// that releases a stage last refills it (see the header)
__host__ __device__ constexpr bool own_producer(int D) { return D <= 128; }
__host__ __device__ constexpr int threads_for(int D) {
  return CONSUMERS + (own_producer(D) ? 32 : 0);
}
constexpr int ROW_BYTES = 128;  // one swizzled row: 64 bf16 columns
constexpr float NEG = -1e30f;

// K/V tiles in flight at D padded columns: three where they fit
__host__ __device__ constexpr int stages_for(int D) {
  return D == 256 ? 2 : 3;
}

// Dynamic shared memory of one block, for D = 64, 128, 192 or 256 padded
// columns: Q (D/64 boxes of BM rows), then STAGES x (K, V) (D/64 boxes of
// FK rows each), then the full and empty mbarriers of each stage; +1024
// bytes to align the base for the swizzle.
template <int D, int STAGES_ = stages_for(D)>
struct Layout {
  static constexpr int STAGES = STAGES_;
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BOX = BM * ROW_BYTES;
  static constexpr int KV_BOX = FK * ROW_BYTES;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;  // K or V of one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int TOTAL = BAR_OFF + 16 * STAGES + 1024;
};

// a block may use 232,448 bytes of dynamic shared memory on sm_90
constexpr int SMEM_LIMIT = 232448;
static_assert(Layout<64>::TOTAL <= SMEM_LIMIT, "D = 64: shared memory");
static_assert(Layout<128>::TOTAL <= SMEM_LIMIT, "D = 128: shared memory");
static_assert(Layout<192>::TOTAL <= SMEM_LIMIT, "D = 192: shared memory");
static_assert(Layout<256>::TOTAL <= SMEM_LIMIT, "D = 256: shared memory");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// A tile arrives within microseconds; a wait of ~2^26 polls means a
// transaction count that never completes, and traps (a launch error)
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64 x 64, f32) = (scale_d ? D : 0) + A(64 x 16) B(16 x 64), A and B
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64, f32) += A(64 x 16) B(16 x 64): A bf16 in registers (the
// accumulator's fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, f32) += A(64 x 16) B(16 x 128): A bf16 in registers (the
// accumulator's fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 192, f32) += A(64 x 16) B(16 x 192): A bf16 in registers (the
// accumulator's fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256, f32) += A(64 x 16) B(16 x 256): A bf16 in registers (the
// accumulator's fragment layout), B bf16 in shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n192(d, a, db);
}
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator fragment of m64nN (f32): thread (warp w, lane l) of a
// warpgroup holds rows w*16 + l/4 (i = 0) and w*16 + l/4 + 8 (i = 1),
// columns 8j + 2(l%4) + c at register 4j + 2i + c.
template <int D>
__global__ void __launch_bounds__(threads_for(D), 1) flash_fwd_wgmma_kernel(
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, int hd,
    float scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + L::Q_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);

  const int g = H / KH;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int R = g * Sq;  // folded rows of (b, kh)
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int shift = Sk - Sq;
  const int last_pos = (min(row0 + BM, R) - 1) / g + shift;
  int n_tiles = (Sk + FK - 1) / FK;
  if (causal) n_tiles = min(n_tiles, last_pos < 0 ? 0 : last_pos / FK + 1);
  const int wrow0 = row0 + wg * 64;  // this warpgroup's first row
  const bool wg_live = wrow0 < R;
  const int wg_last_pos = (min(wrow0 + 64, R) - 1) / g + shift;
  const int wg_first_pos = wrow0 / g + shift;
  // logits in base 2: exp(x * scale - m) = exp2(x * scale * log2(e) - m')
  const float scale_log2 = scale * 1.4426950408889634f;

  // bars[s]: stage s is full (TMA bytes landed); bars[STAGES + s]: stage
  // s is empty (every consumer thread is done with it), or, without a
  // producer warp, a count of the warpgroups' releases of stage s.  The
  // loading thread sets them up and starts the first tiles before Q is
  // loaded.
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load = [=](int t) {  // K and V of tile t into stage t % STAGES
    const int s = t % L::STAGES;
    const uint32_t bar = smem_addr(&bars[s]);
    uint8_t* k_dst = sKV + s * L::STAGE_BYTES;
    mbar_expect_tx(bar, L::STAGE_BYTES);
#pragma unroll
    for (int c = 0; c < L::BOXES; ++c) {
      tma_load_4d(smem_addr(k_dst + c * L::KV_BOX), map_k, bar, c * 64, kh,
                  t * FK, b);
      tma_load_4d(smem_addr(k_dst + L::KV_BYTES + c * L::KV_BOX), map_v, bar,
                  c * 64, kh, t * FK, b);
    }
  };
  int* released = reinterpret_cast<int*>(&bars[L::STAGES]);
  if (tid == (own_producer(D) ? CONSUMERS : 0)) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(smem_addr(&bars[s]), 1);
      if (own_producer(D))
        mbar_init(smem_addr(&bars[L::STAGES + s]), CONSUMERS);
      else
        released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(n_tiles, L::STAGES); ++t) load(t);
  }

  // Q, 16 bytes a thread, into the swizzled layout: chunk ch of row r at
  // chunk ch ^ (r % 8), as TMA's 128-byte swizzle places it
  for (int i = tid; i < BM * (D / 8); i += threads_for(D)) {
    const int r = i / (D / 8);
    const int c8 = i % (D / 8);
    const int f = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (f < R && c8 * 8 < hd)
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd + c8 * 8);
    *reinterpret_cast<uint4*>(sQ + (c8 >> 3) * L::Q_BOX + r * ROW_BYTES +
                              (((c8 & 7) ^ (r & 7)) << 4)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the producer warp: one thread keeps STAGES tiles of K and V in
    // flight, refilling a stage once both warpgroups have released it
    if (tid == CONSUMERS) {
      for (int t = L::STAGES; t < n_tiles; ++t) {
        mbar_wait(smem_addr(&bars[L::STAGES + t % L::STAGES]),
                  (t / L::STAGES + 1) & 1);
        load(t);
      }
    }
    return;
  }

  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int f = wrow0 + warp * 16 + (lane >> 2) + 8 * i;
    pos[i] = (f < R ? f / g : 0) + shift;
  }
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 2];
#pragma unroll
  for (int u = 0; u < D / 2; ++u) acc[u] = 0.f;
  float sf[FK / 2];
  const uint32_t q_base = smem_addr(sQ) + wg * 64 * ROW_BYTES;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % L::STAGES;
    const int k0 = t * FK;
    // every consumer waits, so no load is in flight when a stage refills
    mbar_wait(smem_addr(&bars[s]), (t / L::STAGES) & 1);
    __syncwarp();  // wgmma needs the warp converged
    if (wg_live && !(causal && k0 > wg_last_pos)) {
      const uint32_t k_base = smem_addr(sKV + s * L::STAGE_BYTES);
      const uint32_t v_base = k_base + L::KV_BYTES;
      fence_regs(sf);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t koff = (kc & 3) * 32;  // 16 columns = 32 bytes
        wgmma_ss_n64(
            sf, sw128_desc(q_base + (kc >> 2) * L::Q_BOX + koff, 16, 1024),
            sw128_desc(k_base + (kc >> 2) * L::KV_BOX + koff, 16, 1024),
            kc > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sf);

      uint32_t p_hi[FK / 16][4], p_lo[FK / 16][4];
      // only a tile that crosses the end of K, the diagonal of this
      // warpgroup's rows or a window needs the per-element masks
      const bool masked = k0 + FK > Sk || window > 0 ||
                          (causal && k0 + FK - 1 > wg_first_pos);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = NEG;
        if (masked) {
#pragma unroll
          for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kj = k0 + 8 * j + 2 * (lane & 3) + c;
              bool live = kj < Sk;
              if (causal) live = live && kj <= pos[i];
              if (window > 0) live = live && pos[i] - kj < window;
              float& x = sf[4 * j + 2 * i + c];
              x = live ? x * scale_log2 : NEG;
              tmax = fmaxf(tmax, x);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float& x = sf[4 * j + 2 * i + c];
              x *= scale_log2;
              tmax = fmaxf(tmax, x);
            }
          }
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[i], tmax);
        const float alpha = exp2f(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sf[4 * j + 2 * i + c];
            x = exp2f(x - m_new);
            psum += x;
          }
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * i] *= alpha;
          acc[4 * j + 2 * i + 1] *= alpha;
        }
      }
      // the A fragment of keys 16kk..16kk+15: (row, key pair) registers
      // (i, j) = (0, 2kk), (1, 2kk), (0, 2kk+1), (1, 2kk+1)
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(sf[u], sf[u + 1]);
          const float2 hf = __bfloat1622float2(hi);
          p_hi[kk][r] = bf16x2_bits(hi);
          p_lo[kk][r] = bf16x2_bits(
              __floats2bfloat162_rn(sf[u] - hf.x, sf[u + 1] - hf.y));
        }
      }
      fence_regs(acc);
      wgmma_fence();
      // V MN-major: 8-key groups 1024 bytes apart (SBO), 64-column boxes
      // KV_BOX apart (LBO); 16 keys per instruction
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma_rs<D>(acc, p_hi[kk],
                    sw128_desc(v_base + kk * 16 * ROW_BYTES, L::KV_BOX, 1024));
#pragma unroll
      for (int kk = 0; kk < FK / 16; ++kk)
        wgmma_rs<D>(acc, p_lo[kk],
                    sw128_desc(v_base + kk * 16 * ROW_BYTES, L::KV_BOX, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    if constexpr (own_producer(D)) {
      mbar_arrive(smem_addr(&bars[L::STAGES + s]));  // this thread is done
    } else {
      // this warpgroup is done with stage s; the second of the two to
      // release it (an odd count before its own) loads tile t + STAGES
      asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
      if ((tid & 127) == 0) {
        __threadfence_block();
        const int before = atomicAdd(&released[s], 1);
        __threadfence_block();
        if ((before & 1) && t + L::STAGES < n_tiles) load(t + L::STAGES);
      }
    }
  }

  // normalise, stage this warpgroup's 64 rows of O (bf16) in its own rows
  // of the Q buffer, swizzled as Q, then 16-byte stores of rows f < R
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int rr = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    if (lse != nullptr && (lane & 3) == 0 && row0 + rr < R) {
      // the row's natural log-sum-exp of the scaled logits, for the
      // backward: m is in base 2, so ln(sum) = (m + log2(l)) ln 2
      const int f = row0 + rr;
      lse[((size_t)b * H + kh * g + f % g) * Sq + f / g] =
          (m[i] + log2f(den)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[4 * j + 2 * i] / den, acc[4 * j + 2 * i + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(
          sQ + (col >> 6) * L::Q_BOX + rr * ROW_BYTES +
          ((((col & 63) >> 3) ^ (rr & 7)) << 4) + (col & 7) * 2) = val;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
  for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int c8 = i % (D / 8);
    const int rr = wg * 64 + r;
    const int f = wrow0 + r;
    if (f < R && c8 * 8 < hd) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          sQ + (c8 >> 3) * L::Q_BOX + rr * ROW_BYTES +
          (((c8 & 7) ^ (rr & 7)) << 4));
      *reinterpret_cast<uint4*>(
          o + (((size_t)b * Sq + f / g) * H + kh * g + f % g) * hd + c8 * 8) =
          val;
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the
// runtime so that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of this library above the cudaError_t range
constexpr int ERR_NO_ENCODER = 100000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 200000;      // + the CUresult of a failed encode

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, Sk, KH, hd) bf16, contiguous, as a 4-D map over (hd, KH, Sk, B) with
// boxes of 64 columns x 1 head x FK keys x 1 batch row, 128-byte swizzle,
// zeros out of bounds (the columns of the last box past hd, as at hd =
// 112, 136 or 200, and the keys past Sk).
int kv_map(CUtensorMap* map, const void* base, int B, int Sk, int KH,
           int hd) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KH, (cuuint64_t)Sk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)KH * hd * 2,
                                 (cuuint64_t)Sk * KH * hd * 2};
  const cuuint32_t box[4] = {64, 1, FK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KH, int hd, float scale,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  int err = kv_map(&tm_k, k, B, Sk, KH, hd);
  if (err == 0) err = kv_map(&tm_v, v, B, Sk, KH, hd);
  if (err != 0) return err;
  const int smem = Layout<D>::TOTAL;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((H / KH * Sq + BM - 1) / BM, KH, B);
  flash_fwd_wgmma_kernel<D><<<grid, threads_for(D), smem, stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (__nv_bfloat16*)o, lse, Sq, Sk, H,
      KH, hd, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,Sq,H,hd), k/v (B,Sk,KH,hd) and o (B,Sq,H,hd), contiguous bf16;
// hd a multiple of 8 up to 256, H % KH == 0.  lse, when not null, gets
// each row's log-sum-exp of the scaled logits, f32 (B,H,Sq), for the
// backward; o is the same either way.  Returns 0 on success, else a
// cudaError_t or one of this library's codes (faw_error_string).
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int Sq, int Sk,
                                 int H, int KH, int hd, float scale,
                                 int causal, int window, void* stream) {
  if (hd % 8 != 0 || hd < 8 || hd > 256 || KH < 1 || H % KH != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((hd + 63) / 64) {  // 64-column boxes a row
    case 1:
      return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                        causal, window, st);
    case 2:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                        causal, window, st);
    case 3:
      return launch<192>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                        causal, window, st);
    default:
      return launch<256>(q, k, v, o, lse, B, Sq, Sk, H, KH, hd, scale,
                        causal, window, st);
  }
}

const char* faw_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (err >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused the K/V map";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
