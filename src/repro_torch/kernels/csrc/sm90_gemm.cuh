// A warp-specialised wgmma + TMA GEMM mainloop for Hopper (sm_90a), shared
// by the expert GEMMs on it: expert_gate_up (#1), expert_down (#2),
// grouped_gate_up (#3), grouped_down (#4) and, with int8 weights,
// expert_gate_up_q8 (#8), expert_down_q8 (#9), grouped_gate_up_q8 (#10),
// grouped_down_q8 (#11), grouped_gate_up_fused_q8 (#14) and
// grouped_down_fused_q8 (#15), and the bf16 grouped_gate_up_fused (#12) and
// grouped_down_fused (#13), in grouped_gemm.cu, and grouped_bwd_dh (#5), grouped_bwd_dx (#6) and
// grouped_bwd_wgrad (#7) in grouped_gemm_bwd.cu. Header only: each .cu
// that includes it instantiates the tiles it needs; each caller's note
// gives its design and ptxas's counts. Besides the mainloop it holds what
// the sorted kernels share (grouped_tile's block order, store_zeros,
// MAX_EXPERTS) and the cluster launch (launch_cluster). The paged-attention
// decode kernels #19/#20 (paged_attention.cu) use its TMA, mbarrier,
// cluster-launch and tensor-map helpers, and the warp-level helpers kept
// here for them (ldmatrix, movmatrix, mma.sync m16n8k16, a 4-byte cp.async
// that arrives on an mbarrier); the flash-attention forward #16
// (flash_fwd.cu) its TMA, mbarrier, named-barrier and wgmma helpers, with
// the shapes added for it (wgmma m64n64k16 from shared memory that starts
// or adds to its sum, wgmma with a register A at n64 and n128, pack_a,
// fence_frags, exp2_approx).
//
// int8 weights (#8-#11, #14, #15). map_3d
// takes 1-byte elements (a UINT8 map: boxes of 128 columns x rows,
// 128B-swizzled like the others), and a Tile with B_ELEM 1 keeps B in its
// slots as int8 N-major boxes of 128 columns x 64 K rows: half the bytes
// of bf16 per slab. wgmma has no bf16 x int8 product, so a widening stage runs between
// a slot's arrival and its product: widen_s8 turns each int8 box into the
// two 64-column bf16 boxes that an N-major B descriptor reads (exact, |q|
// <= 127) in one of three bf16 buffers in the Tile's EXTRA area, then a
// proxy fence and one named barrier of all consumer threads a slab
// (consume_s8, for warpgroups with rows; widen_slabs, for one without).
// The caller applies the per-column scales to the fp32 sums in its
// epilogue, as the TPU kernels do.
//
// What it computes: per consumer warpgroup, a 64 x N fp32 accumulator (N
// 128 or 256) += A (64 rows, K) @ B over a run of BK-deep slabs of a ring
// in shared memory. A is K-major (a row is one output row running along
// K: x, dy, h in the row-tile kernels) or M-major (a row is one K index
// running along the output rows: x and h read as x^T, h^T in #7, through
// wgmma's transpose-A bit). B is K-major (a row is one output column,
// running along K: Wg[e] read as Wg[e]^T in #6, Wd[e] in #5) or N-major (a
// row is one K index, running along the output columns: Wd[e] in #2 and
// #4, Wg[e] and Wu[e] in #1 and #5, dg, du, dy in #7). What it serves on an
// H100: at training and prefill widths (hundreds of rows per expert, K
// 4096 to 28672, or K = an expert's rows in #7) these products sit far on
// the tensor-core side of the ridge (bound by operations, 989 TFLOP/s); at
// decode (C 4, or #4's few rows per expert) the same loop must stream the
// weights at the byte bound (3.35 TB/s).
//
// The design:
// * Products are warpgroup MMAs, wgmma.m64nNk16 with both operands in
//   shared memory and fp32 accumulators in registers. Each consumer
//   warpgroup owns 64 rows of the tile: BM = 64 x NWG.
// * One producer warp (one thread of it) keeps a ring of STAGES slots
//   filled with TMA boxes, guarded by full and empty mbarriers: full[s]
//   completes when slot s's bytes have landed, empty[s] when every
//   consumer warp has read it. No block-wide barrier runs in the K loop.
//   Slabs are numbered in one running sequence per block, so a tile may
//   take more than one kind of slab (#5: x (Wg | Wu), then its fp32 dh
//   tile) and a persistent block may walk many tiles (#7) on one ring; a
//   slab's boxes and byte count are the caller's. A consumer keeps one
//   slab's wgmma group in flight behind the one it issues and releases a
//   slot once its group has completed; the last slab of a run is released
//   after the run drains.
// * Tiles are 128B-swizzled boxes of 128 bytes a row (64 bf16, or 32 fp32),
//   as wgmma's 128B swizzle descriptors read them: a K-major A is BM rows of
//   a BK 64 slab; an M-major A is one box of 64 K rows per warpgroup; a
//   K-major B is N rows of the slab (one box); an N-major B is N / 64 boxes
//   of 64 K rows. M- and N-major operands are read through the transpose
//   bits.
// * Rows past the end of a tensor map come in as zeros (TMA fills out of
//   bounds), so a box that straddles the end of an expert's rows reads
//   nothing of the next one. Callers store only their valid rows. Where a
//   box holds rows inside the map that must not enter a product (#7's
//   last slab of an expert), a hook run between the slot's arrival and its
//   first wgmma clears them (zero_rows): whole 128-byte rows, which the
//   swizzle leaves whole, then a proxy fence and a barrier of the
//   consumers.
// * A consumer warpgroup whose 64 rows hold no valid row runs no product;
//   the barrier counts are set per block to the warps that consume.
// * Epilogues store from registers (store_rows, bf16 or fp32), or stage the
//   tile in shared memory in the 128B swizzle (stage_sw128, each warp store
//   spread over all 32 banks) for a TMA store that drains while the next
//   tile's products run (#7).
// * A phase that never completes traps (mbar_wait) instead of hanging.
//
// Shared memory per block: STAGES x (BM + BN) x 128 bytes + EXTRA + the
// mbarriers + 1 KB to align the base to 1024 (the swizzle atom). With BN
// 256: BM 128 (two consumer warpgroups) 4 slots of 48 KB = 197,696 B, or 3
// slots and a 64 KB staged output tile = 214,064 B (#7); BM 64 (one;
// decode) 5 slots of 40 KB = 205,904 B, which keeps up to 160 KB of
// weights in flight per SM. One block per SM. Registers: a consumer
// thread holds N / 2 accumulators, 128 at N 256, and ptxas holds these
// 288-thread blocks to 168 a thread. Three live products (g, u and dh of
// #5, 192 accumulators) do not fit: setmaxnreg, which would move a
// producer warpgroup's registers to the consumers, is emitted but ignored
// by ptxas's allocation here (PERF.md), and a block of 8 warps with no
// producer warp (255 registers) stalled on the consumer that fed the ring.
// At the training shapes the loop runs at ~50-60% of the tensor-core peak,
// each SM taking in ~45-56 GB/s of tiles (PERF.md); TMA multicast of B
// across a cluster halved the L2 reads and gained nothing, so the bytes
// landing in each SM, not L2, set the pace, and a 128 x 128 tile (32 KB a
// slab for half a 128 x 256 tile's work) runs markedly slower than a
// 128 x 256 one.
//
// Left for later: two consumer warpgroups that alternate whole tiles (so
// one's epilogue hides under the other's products), a fixed-order split
// over K where a grid has too few tiles, and moving flash_bwd.cu's copies
// of these helpers onto this header.
#pragma once

#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is looked up through the runtime, no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace sm90 {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA: one thread asks for box (c0, c1, c2) of a 3D tensor map to be copied
// into shared memory; the copy adds its bytes to the mbarrier's count.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// TMA: one thread asks for a box of shared memory (128B-swizzled, as the
// map says) to be written to box (c0, c1, c2) of a 3D tensor map; the
// copies issued since the last commit form one bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c0, int c1, int c2, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(c2), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// until at most N bulk groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// A phase that never completes (a lost copy or arrival) traps after 2^24
// tries, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more of transactions in the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// barrier `id` (not 0, which __syncthreads uses) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// arrive at barrier `id` without waiting: the threads that bar.sync on it
// go on once `threads` threads in all have arrived or synced
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// make this thread's generic writes to shared memory visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// make mbarrier inits visible to the async proxy and the cluster (after the inits, before their first use)
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// Non-bulk copies of 4 bytes (through L1) or 16 bytes (L2 only) into
// shared memory, and an arrival on an mbarrier once every such copy this
// thread has started has landed (noinc: the arrival counts against the
// count the barrier was initialised with). They write through the generic
// proxy: a wgmma that reads them needs fence_async_smem first.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// until every cp.async this thread has started has landed
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Warp-level MMA (paged_attention.cu): four 8x8 b16 matrices from shared
// memory, lanes 8j..8j+7 giving the row addresses of matrix j; thread
// 4g + t gets elements (g, 2t..2t+1) of each, or of its transpose (TRANS).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}
// the transpose of an 8x8 b16 matrix held one row pair per thread, as ldsm_x4 gives it
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d (16 x 8 fp32) += a (16 x 16 bf16, row-major fragments) b (16 x 8 bf16, column-major fragments)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// keep the compiler from moving accesses to wgmma accumulators across the async MMA
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (ex2.approx: relative error ~2^-22; -inf gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptor of a shared-memory operand stored as 128-byte swizzled rows of
// 64 bf16, 8-row groups 1024 bytes apart (SBO). K-major use: a row is an
// M or N index and runs along K (lbo unused, 16). M- or N-major use
// (transposed A or B): a row is a K index and runs along M or N; the next
// 64 M or N values sit `lbo` bytes further. Layout type 1 = 128-byte
// swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define SM90_ACC8(o)                                                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),          \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x N fp32) += A (64 x 16) B (16 x N), both in shared memory; A
// K-major (TA 0) or M-major (TA 1), B K-major (TB 0) or N-major (TB 1)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48),
        SM90_ACC8(56)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48),
        SM90_ACC8(56), SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88), SM90_ACC8(96), SM90_ACC8(104),
        SM90_ACC8(112), SM90_ACC8(120)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}
#undef SM90_ACC8

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 128 || N == 256, "wgmma tile width");
  if constexpr (N == 128)
    wgmma_ss_n128<TA, TB>(d, a, b);
  else
    wgmma_ss_n256<TA, TB>(d, a, b);
}

#define SM90_ACC8(o)                                                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),          \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define SM90_OUT8(o)                                                                                       \
  "=f"(d[o + 0]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]), "=f"(d[o + 5]),          \
      "=f"(d[o + 6]), "=f"(d[o + 7])
#define SM90_SS_N64                                                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                        \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

// d (64 x 64 fp32) = (ACC ? d : 0) + A (64 x 16) B (16 x 64), both K-major
// in shared memory (flash_fwd.cu's S = Q K^T); ACC false starts the sum
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC)
    asm volatile(SM90_SS_N64 : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24) : "l"(a), "l"(b), "r"(1));
  else
    asm volatile(SM90_SS_N64 : SM90_OUT8(0), SM90_OUT8(8), SM90_OUT8(16), SM90_OUT8(24) : "l"(a), "l"(b), "r"(0));
}

// d (64 x N fp32) += A (64 x 16 bf16 in registers: the thread's fragment,
// as pack_a gives it) B (16 x N in shared memory, K-major (TB 0) or N-major
// (TB 1)); N 64 or 128 (flash_fwd.cu's O += P V)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48),
        SM90_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}
#undef SM90_SS_N64
#undef SM90_OUT8
#undef SM90_ACC8

// The accumulator of an m64nN wgmma (N / 2 fp32 a thread) as the bf16 A
// fragments of the next product: columns 16kk..16kk+15 of a thread's rows,
// packed in pairs, are its fragment a[kk] for the k16 step kk.
template <int M>
__device__ __forceinline__ void pack_a(const float (&x)[M], uint32_t (&a)[M / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < M / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// keep the compiler from reusing A fragments that an async MMA still reads
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// ---------------------------------------------------------------------------
// the tile and its ring
// ---------------------------------------------------------------------------

// NWG consumer warpgroups of 64 rows, then PRODUCERS producer warps (one
// thread of the first issues the TMA copies; where the rows of A are
// gathered by cp.async, #12 and #14, every lane of them copies). Two
// consumer warpgroups at most: ptxas holds a block of 9 to 12 warps to 168
// registers a thread (one SM sub-partition hosts three of its warps) and
// one of more than 12 warps to 128, and a consumer thread holds BN / 2
// accumulators. B_MN is the B layout of consume(); consume_at() takes its
// layouts per product. EXTRA bytes of shared memory after the ring,
// 1024-aligned, are the caller's (#7 stages its output tile there for a
// TMA store; consume_s8 widens int8 slabs there). B_ELEM 1: a slot holds B
// in int8 (BN / 128 N-major boxes of 128 columns x 64 K rows), for
// consume_s8.
template <int NWG_, int BN_, bool B_MN_, int EXTRA_ = 0, int B_ELEM_ = 2, int PRODUCERS_ = 1>
struct Tile {
  static constexpr int NWG = NWG_, BM = 64 * NWG_, BN = BN_, BK = 64;
  static constexpr bool B_MN = B_MN_;
  static constexpr int PRODUCERS = PRODUCERS_;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32 * PRODUCERS;
  static_assert(PRODUCERS >= 1 && PRODUCERS <= 4, "producer warps: one warpgroup at most");
  static_assert(NWG == 1 || NWG == 2, "consumer warpgroups");
  static_assert(B_ELEM_ == 2 || (B_ELEM_ == 1 && B_MN_ && BN_ % 128 == 0), "B in bf16, or int8 N-major boxes");
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * B_ELEM_, STAGE = A_BYTES + B_BYTES;
  static constexpr int EXTRA = EXTRA_;
  static constexpr int STAGES = (225 * 1024 - EXTRA) / STAGE < 8 ? (225 * 1024 - EXTRA) / STAGE : 8;
  static constexpr int BAR = STAGES * STAGE + EXTRA;      // full[STAGES], then empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static_assert(EXTRA % 1024 == 0 && STAGES >= 3 && SMEM <= 227 * 1024, "shared memory");
};

// The ring of a block's dynamic shared memory, its base aligned to 1024
template <class T>
struct Ring {
  uint32_t base;
  __device__ uint32_t a(int s) const { return base + s * T::STAGE; }
  __device__ uint32_t b(int s) const { return base + s * T::STAGE + T::A_BYTES; }
  __device__ uint32_t extra() const { return base + T::STAGES * T::STAGE; }
  __device__ uint32_t full(int s) const { return base + T::BAR + 8 * s; }
  __device__ uint32_t empty(int s) const { return base + T::BAR + 8 * (T::STAGES + s); }
  // one thread, then __syncthreads: `warps` consumer warps release each
  // slot; `fills` arrivals complete a slot's fill (the producer's expect_tx,
  // and one a lane where the producer warps' lanes copy with cp.async: #12, #14)
  __device__ void init(int warps, int fills = 1) const {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full(s), fills);
      mbar_init(empty(s), warps);
    }
    fence_mbar_init();
  }
};

template <class T>
__device__ __forceinline__ Ring<T> ring_at(unsigned char* smem_raw) {
  return Ring<T>{(smem_u32(smem_raw) + 1023) & ~1023u};
}

// The producer thread: slabs i0 .. i0 + n - 1 of the block's running slab
// sequence. Slab i goes to slot i % STAGES once the slot's previous slab
// (i - STAGES) is released; load(i, a, b, bar) issues its boxes against
// bar, bytes(i) bytes in all.
template <class T, class Load, class Bytes>
__device__ __forceinline__ void produce_at(const Ring<T>& r, int i0, int n, Load&& load, Bytes&& bytes) {
  for (int i = i0; i < i0 + n; ++i) {
    const int s = i % T::STAGES;
    if (i >= T::STAGES) mbar_wait(r.empty(s), (i / T::STAGES - 1) & 1);
    mbar_expect_tx(r.full(s), bytes(i));
    load(i, r.a(s), r.b(s), r.full(s));
  }
}

// One tile's n_slabs slabs, each `bytes` (T::STAGE unless A's box has
// fewer rows than BM)
template <class T, class Load>
__device__ __forceinline__ void produce(const Ring<T>& r, int n_slabs, Load&& load, uint32_t bytes = T::STAGE) {
  produce_at(r, 0, n_slabs, load, [bytes](int) { return bytes; });
}

struct NoHook {
  __device__ void operator()(int, int) const {}
};

// Consumer warpgroup wg: acc (rows 64 wg.. of the tile, N columns, in the
// m64nN accumulator layout) += the product over slabs i0 .. i0 + n - 1,
// A K-major (TA 0) or M-major (TA 1), B K-major (TB 0) or N-major (TB 1).
// hook(i, slot) runs once slab i has landed, before any wgmma reads it.
// The accumulator holds, in thread (warp w, lane 4g + t), element 4j + e
// at row 16w + g + 8(e / 2), column 8j + 2t + (e % 2).
template <class T, int N, int TA, int TB, class Hook = NoHook>
__device__ __forceinline__ void consume_at(const Ring<T>& r, int i0, int n, int wg, float (&acc)[N / 2],
                                           Hook&& hook = Hook{}) {
  const bool lead = threadIdx.x % 32 == 0;
  for (int i = i0; i < i0 + n; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(r.full(s), (i / T::STAGES) & 1);
    hook(i, s);
    // a warpgroup's A: its 64 rows of a K-major slab, or its own box of an M-major one (8 KB either way)
    const uint64_t da = sw128_desc(r.a(s) + wg * (64 * 128), TA ? T::BK * 128 : 16);
    const uint64_t db = sw128_desc(r.b(s), TB ? T::BK * 128 : 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)  // K-major: 32 bytes along the row; M- or N-major: 16 rows down
      wgmma_ss<N, TA, TB>(acc, da + (TA ? (16 * 128 >> 4) : 2) * kk, db + (TB ? (16 * 128 >> 4) : 2) * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the slab before this one has been read
    if (i > i0 && lead) mbar_arrive(r.empty((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n > 0 && lead) mbar_arrive(r.empty((i0 + n - 1) % T::STAGES));
}

// One tile's n_slabs slabs in the Tile's own layouts (A K-major)
template <class T>
__device__ __forceinline__ void consume(const Ring<T>& r, int n_slabs, int wg, float (&acc)[T::BN / 2]) {
  consume_at<T, T::BN, 0, T::B_MN ? 1 : 0>(r, 0, n_slabs, wg, acc);
}

// Clear rows `from` .. 63 of `boxes` 8 KB boxes (64 rows of 128 bytes)
// that start at `base`, with `threads` consumer threads (thread index
// `tid`), before a wgmma reads them: whole rows, so the 128B swizzle
// leaves no byte of a cleared row outside it.
__device__ __forceinline__ void zero_rows(uint32_t base, int boxes, int from, int tid, int threads) {
  const int per_box = (64 - from) * 8;  // 16-byte chunks
  for (int c = tid; c < boxes * per_box; c += threads) {
    const uint32_t at = base + (c / per_box) * (64 * 128) + (from + (c % per_box) / 8) * 128 + (c % 8) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at), "r"(0) : "memory");
  }
  fence_async_smem();
}

// The int8 widening stage. BOXES int8 boxes at src (each 64 K rows of 128
// bytes = 128 N columns, 128B-swizzled by the TMA unit: 16-byte chunk c of
// row r at chunk c ^ (r % 8)) become 2 * BOXES bf16 boxes at dst (box j:
// columns 64j..64j+63, 64 rows of 128 bytes, 8 KB apart, in the same
// swizzle): the N-major B that consume's descriptors read. THREADS threads
// (index tid) each load all their 16-byte chunks first, then convert and
// store them: a warp's loads read 512 contiguous bytes, and its two
// 16-byte stores per chunk fall on all 32 banks (no conflict). A byte q
// becomes bf16 exactly (|q| <= 127): one prmt places two bytes in the low
// bytes of two 16-bit lanes, one lop3 makes each lane the bf16 128 +
// (q & 127), another makes it 128 or 256 by q's sign bit, and one
// sub.bf16x2 leaves q (fewer integer operations than widening through
// fp32, which measured slower on the card; PERF.md).
template <int BOXES, int THREADS>
__device__ __forceinline__ void widen_s8(uint32_t src, uint32_t dst, int tid) {
  static_assert(BOXES * 512 % THREADS == 0, "whole chunks a thread");
  constexpr int N = BOXES * 512 / THREADS;  // 16-byte chunks a thread
  uint32_t w[N][4];
#pragma unroll
  for (int j = 0; j < N; ++j)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w[j][0]), "=r"(w[j][1]), "=r"(w[j][2]), "=r"(w[j][3])
                 : "r"(src + (tid + j * THREADS) * 16));
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = tid + j * THREADS;
    const int r = (c / 8) % 64, x = r % 8, lc = (c % 8) ^ x;  // lc: the chunk's 16 columns in its int8 box
    uint32_t o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t lanes = __byte_perm(w[j][k / 2], 0u, k % 2 ? 0x4342 : 0x4140);  // bytes 2(k%2), +1
      const uint32_t v = (lanes & 0x007F007Fu) | 0x43004300u, base = (lanes & 0x00800080u) | 0x43004300u;
      asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(o[k]) : "r"(v), "r"(base));
    }
    const uint32_t row = dst + (2 * (c / 512) + lc / 4) * (64 * 128) + r * 128;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(row + ((2 * (lc % 4) + hh) ^ x) * 16),
                   "r"(o[4 * hh]), "r"(o[4 * hh + 1]), "r"(o[4 * hh + 2]), "r"(o[4 * hh + 3])
                   : "memory");
  }
}

// Consumers of a ring whose slots hold a K-major bf16 A (as consume reads
// it) and B as int8 N-major boxes (Tile B_ELEM 1). Per slab: wait for the
// slot, widen its int8 boxes into bf16 buffer i % 3 of the caller's EXTRA
// area (BN / 64 boxes of 8 KB each), fence the writes for the async proxy
// and meet at named barrier 1 (all T::CONSUMERS threads, every slab); then
// the warpgroup issues the slab's wgmma and waits for the one before it,
// which frees that slab's slot. Three buffers let a slab be widened while
// the previous slab's product runs, with one barrier a slab: buffer i % 3
// is rewritten only after every product warpgroup has waited for slab
// i - 3's product, which it does before it reaches the barrier of slab
// i - 1. A warpgroup with rows runs consume_s8 (it widens its share of
// each slab, then runs the product; its accumulator stays live through
// the loop); a warpgroup without rows runs widen_slabs, the same loop with
// no product and no accumulator (so its widening spends no registers on
// one), which measured faster than one loop for both.
template <class T>
__device__ __forceinline__ void widen_slabs(const Ring<T>& r, int n) {
  for (int i = 0; i < n; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(r.full(s), (i / T::STAGES) & 1);
    widen_s8<T::BN / 128, T::CONSUMERS>(r.b(s), r.extra() + (i % 3) * (T::BN * T::BK * 2), threadIdx.x);
    fence_async_smem();
    named_sync(1, T::CONSUMERS);
  }
}

template <class T>
__device__ __forceinline__ void consume_s8(const Ring<T>& r, int n, int wg, float (&acc)[T::BN / 2]) {
  constexpr int W_BYTES = T::BN * T::BK * 2;
  static_assert(T::B_BYTES * 2 == W_BYTES && T::EXTRA >= 3 * W_BYTES, "int8 slots, three bf16 buffers");
  const bool lead = threadIdx.x % 32 == 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(r.full(s), (i / T::STAGES) & 1);
    const uint32_t w = r.extra() + (i % 3) * W_BYTES;
    widen_s8<T::BN / 128, T::CONSUMERS>(r.b(s), w, threadIdx.x);
    fence_async_smem();
    named_sync(1, T::CONSUMERS);
    const uint64_t da = sw128_desc(r.a(s) + wg * (64 * 128), 16), db = sw128_desc(w, T::BK * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk) wgmma_ss<T::BN, 0, 1>(acc, da + 2 * kk, db + (16 * 128 >> 4) * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the slab before this one has been read
    if (i > 0 && lead) mbar_arrive(r.empty((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (n > 0 && lead) mbar_arrive(r.empty((n - 1) % T::STAGES));
}

// Columns C0 .. C0 + W - 1 of a consumer warpgroup's accumulator as bf16
// into W / 64 boxes of shared memory `box_bytes` apart from `dst`, each of
// 128-byte rows of 64 columns in the 128B swizzle (16-byte chunk c of row
// r at chunk c ^ (r % 8)), the warpgroup's row r at box row row0 + r
// (row0 a multiple of 8): a TMA store's source. Each store of a warp
// writes 8 rows x 16 bytes that the swizzle spreads over all 32 banks.
template <int W, int C0, int M>
__device__ __forceinline__ void stage_sw128(const float (&acc)[M], uint32_t dst, uint32_t box_bytes, int row0) {
  static_assert(C0 % 64 == 0 && W % 64 == 0 && (C0 + W) / 2 <= M, "accumulator columns");
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint32_t row = dst + (row0 + warp * 16 + g + 8 * hh) * 128 + t * 4;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int k = 4 * (C0 / 8 + j) + 2 * hh;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(row + (j / 8) * box_bytes + (((j % 8) ^ g) * 16)),
                   "r"(pack_bf16(acc[k], acc[k + 1]))
                   : "memory");
    }
  }
}

// A consumer warpgroup's accumulator as bf16, or as fp32 where Out is
// float: row r (0..63) of the warpgroup at out + r * ld. Rows from `valid`
// on are stored as zeros (ZEROS) or not at all.
template <class T, bool ZEROS, class Out>
__device__ __forceinline__ void store_rows(const float (&acc)[T::BN / 2], Out* out, size_t ld, int valid) {
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (!ZEROS && r >= valid) continue;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const float lo = r < valid ? acc[4 * j + 2 * hh] : 0.f, hi = r < valid ? acc[4 * j + 2 * hh + 1] : 0.f;
      Out* dst = out + r * ld + 8 * j + 2 * t;
      if constexpr (sizeof(Out) == 4)
        *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
      else
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
    }
  }
}

// BM x W bf16 zeros at out (row stride ld), by `threads` threads, of which
// this one is `tid` (threadIdx.x where the whole block stores)
template <int BM, int W>
__device__ __forceinline__ void store_zeros(bf16* out, size_t ld, int threads, int tid) {
  for (int c = tid; c < BM * W / 8; c += threads)
    *reinterpret_cast<uint4*>(out + (c / (W / 8)) * ld + (c % (W / 8)) * 8) = make_uint4(0, 0, 0, 0);
}
template <int BM, int W>
__device__ __forceinline__ void store_zeros(bf16* out, size_t ld, int threads) {
  store_zeros<BM, W>(out, ld, threads, threadIdx.x);
}

// A 1D grid of nr x nc blocks over the sorted buffer's row tiles, in groups
// of GROUP_TILES row tiles, each group's blocks column block by column
// block, its row tiles fastest: the group's activations and each column
// block's weights are read by blocks that run together, so both come from
// L2 more often than in a grid whose row tiles run fastest over all nr
// (#4, #5; faster at the training shape, and alike for groups of 6 to 12;
// PERF.md).
constexpr int GROUP_TILES = 8;

__device__ __forceinline__ void grouped_tile(int nc, int& row, int& col) {
  const int nr = gridDim.x / nc, g = blockIdx.x / (GROUP_TILES * nc), r = blockIdx.x % (GROUP_TILES * nc);
  const int rows = min(GROUP_TILES, nr - g * GROUP_TILES);
  row = g * GROUP_TILES + r % rows;
  col = r / rows;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The sorted kernels take no expert count: tile_group names the expert of
// each tile, so their weight maps span MAX_EXPERTS experts and no box is
// ever asked past the last real one.
constexpr uint64_t MAX_EXPERTS = 1 << 16;

// Launch `kernel` on `grid` as thread-block clusters of `cluster` blocks
// along x (which must divide grid.x): the blocks of a cluster run at once
// on SMs of one GPC. Returns the launch's cudaError_t.
template <class K, class... Args>
int launch_cluster(K kernel, dim3 grid, int cluster, int threads, int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// A 1D grid of `blocks` in grouped_tile order, as clusters of two
// neighbours (where 2 divides it), which read the same weight boxes and so
// run at once on one GPC (no multicast): faster for #5's two launches at
// the training shape; clusters of 4 were not (PERF.md).
template <class K, class... Args>
int launch_grouped(K kernel, int blocks, int threads, int smem, cudaStream_t s, Args... args) {
  return launch_cluster(kernel, dim3(blocks), blocks % 2 ? 1 : 2, threads, smem, s, args...);
}

// cuTensorMapEncodeTiled (a libcuda entry point), looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A (d2, d1, d0) array of `elem`-byte elements (bf16; fp32 where elem is
// 4; int8, as bytes, where elem is 1), contiguous along d0, read or
// written in 128B-swizzled boxes of 128 / elem x rows x 1; out-of-bounds
// elements arrive as zeros. False if the base is not 16-byte aligned or
// cuTensorMapEncodeTiled refuses the map.
inline bool map_3d(CUtensorMap* m, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t rows,
                   uint32_t elem = 2) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || !encode_tiled()) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
  const cuuint32_t box[3] = {128 / elem, rows, 1}, step[3] = {1, 1, 1};
  const CUtensorMapDataType type = elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode_tiled()(m, type, 3,
                        const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
