// A warp-specialised wgmma + TMA GEMM mainloop for Hopper (sm_90a), shared
// by the plain bf16 expert GEMMs of grouped_gemm.cu (expert_down, #2) and
// grouped_gemm_bwd.cu (grouped_bwd_dx, #6). Header only: each .cu that
// includes it instantiates the tiles it needs.
//
// What it computes: per block, a BM x BN fp32 tile of A (rows, K) @ B,
// summed over K in BK-deep slabs, with A K-major and B either K-major (a
// row of B is one output column, running along K: Wg[e] read as Wg[e]^T in
// #6) or N-major (a row of B is one K index, running along the output
// columns: Wd[e] in #2). What it serves on an H100: at training and
// prefill widths (hundreds of rows per expert, K 14336 or 28672) these
// products sit far on the tensor-core side of the ridge (bound by
// operations, 989 TFLOP/s); at decode (C 4) the same loop must stream the
// weights at the byte bound (3.35 TB/s).
//
// The design:
// * Products are warpgroup MMAs, wgmma.m64nNk16 (N = BN, 128 or 256) with
//   both operands in shared memory and fp32 accumulators in registers.
//   Each consumer warpgroup owns 64 rows of the tile: BM = 64 x NWG.
// * One producer warp (one thread of it) keeps a ring of STAGES slots
//   filled with TMA boxes, guarded by full and empty mbarriers: full[s]
//   completes when slot s's bytes have landed, empty[s] when every
//   consumer warp has read it. No block-wide barrier runs in the K loop.
//   A consumer keeps one slab's wgmma group in flight behind the one it
//   issues and releases a slot once its group has completed.
// * Tiles are 128B-swizzled boxes of 64 bf16 columns, as wgmma's 128B
//   swizzle descriptors read them: A is BM rows of a BK 64 slab; a K-major
//   B is BN rows of the slab (one box); an N-major B is BN / 64 boxes of
//   64 K rows, read through the descriptor's transpose bit.
// * Rows past the end of a tensor map come in as zeros (TMA fills out of
//   bounds), so a box that straddles the end of an expert's rows reads
//   nothing of the next one. Callers store only their valid rows.
// * A consumer warpgroup whose 64 rows hold no valid row runs no product;
//   the barrier counts are set per block to the warps that consume.
// * Blocks run one output tile each; the callers order the grid so that
//   blocks sharing a weight column block launch next to each other and
//   the second reads B from L2 (expert_down also launches them as one
//   thread-block cluster).
// * A phase that never completes traps (mbar_wait) instead of hanging.
//
// Shared memory per block: STAGES x (BM + BN) x 128 bytes + the mbarriers
// + 1 KB to align the base to 1024 (the swizzle atom). With BN 256: BM 128
// (two consumer warpgroups, 288 threads) 4 slots of 48 KB = 197,696 B;
// BM 64 (one, 160 threads; decode) 5 slots of 40 KB = 205,904 B, which
// keeps up to 160 KB of weights in flight per SM. One block per SM.
// Registers per thread: 128 accumulators at BN 256; the callers' notes
// give ptxas's counts. At the training shapes the loop runs at ~60-65% of
// the tensor-core peak, each SM taking in ~56-60 GB/s of tiles; TMA
// multicast of B across a cluster halved the L2 reads and gained nothing.
//
// Left for later: a persistent grid whose epilogue overlaps the next
// tile's loads, a TMA store epilogue, a fixed-order split over K where a
// grid has too few tiles, and moving flash_bwd.cu's copies of these
// helpers onto this header.
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
// M or N index and runs along K (lbo unused, 16). N-major use (transposed
// B): a row is a K index and runs along N; the next 64 N values sit `lbo`
// bytes further. Layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define SM90_ACC8(o)                                                                                       \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),          \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x N fp32) += A (64 x 16) B (16 x N); A K-major, B K-major (TB 0) or
// N-major (TB 1), both in shared memory
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48),
        SM90_ACC8(56)
      : "l"(a), "l"(b), "r"(1), "n"(TB));
}

template <int TB>
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
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24), SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48),
        SM90_ACC8(56), SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88), SM90_ACC8(96), SM90_ACC8(104),
        SM90_ACC8(112), SM90_ACC8(120)
      : "l"(a), "l"(b), "r"(1), "n"(TB));
}
#undef SM90_ACC8

template <>
__device__ __forceinline__ void wgmma_ss<128, 0>(float (&d)[64], uint64_t a, uint64_t b) { wgmma_ss_n128<0>(d, a, b); }
template <>
__device__ __forceinline__ void wgmma_ss<128, 1>(float (&d)[64], uint64_t a, uint64_t b) { wgmma_ss_n128<1>(d, a, b); }
template <>
__device__ __forceinline__ void wgmma_ss<256, 0>(float (&d)[128], uint64_t a, uint64_t b) { wgmma_ss_n256<0>(d, a, b); }
template <>
__device__ __forceinline__ void wgmma_ss<256, 1>(float (&d)[128], uint64_t a, uint64_t b) { wgmma_ss_n256<1>(d, a, b); }

// ---------------------------------------------------------------------------
// the tile and its ring
// ---------------------------------------------------------------------------

// NWG consumer warpgroups of 64 rows, then one producer warp (one thread
// of it issues the copies). Two consumer warpgroups at most: a consumer
// thread holds BN / 2 accumulators and a block of more than 12 warps is
// held to 128 registers a thread.
template <int NWG_, int BN_, bool B_MN_>
struct Tile {
  static constexpr int NWG = NWG_, BM = 64 * NWG_, BN = BN_, BK = 64;
  static constexpr bool B_MN = B_MN_;
  static constexpr int CONSUMERS = 128 * NWG, THREADS = CONSUMERS + 32;
  static_assert(NWG == 1 || NWG == 2, "consumer warpgroups");
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2, STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = (225 * 1024) / STAGE < 8 ? (225 * 1024) / STAGE : 8;
  static constexpr int BAR = STAGES * STAGE;              // full[STAGES], then empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static_assert(STAGES >= 4 && SMEM <= 227 * 1024, "shared memory");
};

// The ring of a block's dynamic shared memory, its base aligned to 1024
template <class T>
struct Ring {
  uint32_t base;
  __device__ uint32_t a(int s) const { return base + s * T::STAGE; }
  __device__ uint32_t b(int s) const { return base + s * T::STAGE + T::A_BYTES; }
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

// The producer thread: slab i goes to slot i % STAGES once the slot's
// previous slab (i - STAGES) is released; load(i, a, b, bar) issues its
// boxes (`bytes` in all, T::STAGE unless A's box has fewer rows than BM)
// against bar.
template <class T, class Load>
__device__ __forceinline__ void produce(const Ring<T>& r, int n_slabs, Load&& load, uint32_t bytes = T::STAGE) {
  for (int i = 0; i < n_slabs; ++i) {
    const int s = i % T::STAGES;
    if (i >= T::STAGES) mbar_wait(r.empty(s), (i / T::STAGES - 1) & 1);
    mbar_expect_tx(r.full(s), bytes);
    load(i, r.a(s), r.b(s), r.full(s));
  }
}

// Consumer warpgroup wg: acc (rows 64 wg.. of the tile, BN columns, in the
// m64nN accumulator layout) += the product over n_slabs slabs. The
// accumulator holds, in thread (warp w, lane 4g + t), element 4j + e at
// row 16w + g + 8(e / 2), column 8j + 2t + (e % 2).
template <class T>
__device__ __forceinline__ void consume(const Ring<T>& r, int n_slabs, int wg, float (&acc)[T::BN / 2]) {
  const bool lead = threadIdx.x % 32 == 0;
  for (int i = 0; i < n_slabs; ++i) {
    const int s = i % T::STAGES;
    mbar_wait(r.full(s), (i / T::STAGES) & 1);
    const uint64_t da = sw128_desc(r.a(s) + wg * (64 * 128), 16);
    const uint64_t db = sw128_desc(r.b(s), T::B_MN ? T::BK * 128 : 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)  // K-major: 32 bytes along the row; N-major: 16 rows down
      wgmma_ss<T::BN, T::B_MN ? 1 : 0>(acc, da + 2 * kk, db + (T::B_MN ? (16 * 128 >> 4) : 2) * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the slab before this one has been read
    if (i > 0 && lead) mbar_arrive(r.empty((i - 1) % T::STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);
}

// A consumer warpgroup's accumulator as bf16: row r (0..63) of the
// warpgroup at out + r * ld. Rows from `valid` on are stored as zeros
// (ZEROS) or not at all.
template <class T, bool ZEROS>
__device__ __forceinline__ void store_rows(const float (&acc)[T::BN / 2], bf16* out, size_t ld, int valid) {
  const int warp = (threadIdx.x % 128) / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (!ZEROS && r >= valid) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + r * ld + 2 * t);
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j)
      dst[4 * j] = r < valid ? pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]) : 0u;
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

// A (d2, d1, d0) bf16 array, contiguous along d0, read in 128B-swizzled
// boxes of 64 x rows x 1; out-of-bounds elements arrive as zeros. False if
// the base is not 16-byte aligned or the driver refuses the map.
inline bool map_3d(CUtensorMap* m, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || !encode_tiled()) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {64, rows, 1}, step[3] = {1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
