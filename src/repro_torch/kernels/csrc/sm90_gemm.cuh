// A warp-specialised wgmma + TMA GEMM mainloop for Hopper (sm_90a), shared
// by the bf16 expert GEMMs on it: expert_down (#2) in grouped_gemm.cu and
// grouped_bwd_dh (#5), grouped_bwd_dx (#6) and grouped_bwd_wgrad (#7) in
// grouped_gemm_bwd.cu. Header only: each .cu that includes it instantiates
// the tiles it needs; each caller's note gives its design and ptxas's
// counts.
//
// What it computes: per consumer warpgroup, a 64 x N fp32 accumulator (N
// 128 or 256) += A (64 rows, K) @ B over a run of BK-deep slabs of a ring
// in shared memory. A is K-major (a row is one output row running along
// K: x, dy, h in the row-tile kernels) or M-major (a row is one K index
// running along the output rows: x and h read as x^T, h^T in #7, through
// wgmma's transpose-A bit). B is K-major (a row is one output column,
// running along K: Wg[e] read as Wg[e]^T in #6, Wd[e] in #5) or N-major (a
// row is one K index, running along the output columns: Wd[e] in #2, Wg[e]
// and Wu[e] in #5, dg, du, dy in #7). What it serves on an H100: at
// training and prefill widths (hundreds of rows per expert, K 4096 to
// 28672, or K = an expert's rows in #7) these products sit far on the
// tensor-core side of the ridge (bound by operations, 989 TFLOP/s); at
// decode (C 4) the same loop must stream the weights at the byte bound
// (3.35 TB/s).
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
// make this thread's generic writes to shared memory visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

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

// ---------------------------------------------------------------------------
// the tile and its ring
// ---------------------------------------------------------------------------

// NWG consumer warpgroups of 64 rows, then one producer warp (one thread
// of it issues the copies). Two consumer warpgroups at most: ptxas holds a
// block of 9 to 12 warps to 168 registers a thread (one SM sub-partition
// hosts three of its warps) and one of more than 12 warps to 128, and a
// consumer thread holds BN / 2 accumulators. B_MN is the B layout of
// consume(); consume_at() takes its layouts per product. EXTRA bytes of
// shared memory after the ring, 1024-aligned, are the caller's (#7 stages
// its output tile there for a TMA store).
template <int NWG_, int BN_, bool B_MN_, int EXTRA_ = 0>
struct Tile {
  static constexpr int NWG = NWG_, BM = 64 * NWG_, BN = BN_, BK = 64;
  static constexpr bool B_MN = B_MN_;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32;
  static_assert(NWG == 1 || NWG == 2, "consumer warpgroups");
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2, STAGE = A_BYTES + B_BYTES;
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
  // one thread, then __syncthreads: `warps` consumer warps release each slot
  __device__ void init(int warps) const {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// A (d2, d1, d0) array of `elem`-byte elements (bf16, or fp32 where elem is
// 4), contiguous along d0, read or written in 128B-swizzled boxes of
// 128 / elem x rows x 1; out-of-bounds elements arrive as zeros. False if
// the base is not 16-byte aligned or the driver refuses the map.
inline bool map_3d(CUtensorMap* m, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t rows,
                   uint32_t elem = 2) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || !encode_tiled()) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
  const cuuint32_t box[3] = {128 / elem, rows, 1}, step[3] = {1, 1, 1};
  return encode_tiled()(m, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
