// Flash-attention backward (causal / sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py, _fa_bwd:
//   flash_bwd_dq  <- _fa_bwd_dq_kernel:  p = exp(s - lse), dp = dO V^T,
//                    ds = p (dp - delta) scale, dq = sum over key tiles ds K;
//   flash_bwd_dkv <- _fa_bwd_dkv_kernel: dv = sum P^T dO, dk = sum dS^T Q over
//                    the G = H/KV query heads of a KV head and their q tiles.
//
// Layouts are the model's own, as in flash_fwd.cu: q, dO, dq (B, Sq, H, d);
// k, v, dk, dv (B, Sk, KV, d) bf16; lse and delta (B*H, Sq) fp32 (lse from
// the forward kernel, delta = rowsum(dO * O) computed by the wrapper in
// fp32). Positions are implicit and right-aligned (q_offset = Sk - Sq); a
// masked (query, key) pair has p = 0, exactly as the TPU kernel's -1e30
// score gives. Head dims 64 and 128.
//
// Rounding: s, dp, p and ds are fp32 in registers; p and ds are rounded to
// bf16 once, to feed the tensor cores (dq += ds K, dv += P^T dO,
// dk += dS^T Q); the sums stay fp32, the softmax scale multiplies dq and dk
// once at the end, and dq, dk, dv are rounded to bf16 once. The rounding of
// p and ds (relative 2^-9 each) is what the 2e-2 x max|plain| tolerance of
// the checks covers. No atomics: every sum is taken in a fixed order, so two
// launches give bit-equal outputs.
//
// What bounds it on an H100: at the training shape (S 2048, d 128, H 32 /
// KV 8, causal) dq does 3 and dk/dv 4 products of 2*d FLOP per live
// (query, key) pair, 0.052 and 0.070 ms at 989 TFLOP/s, against ~40 MB of
// inputs (0.01 ms at 3.35 TB/s): bound by operations, so the design is
// about keeping the tensor cores fed.
//
// What the design does about it:
// * Every product is a warpgroup MMA (wgmma m64nNk16, fp32 accumulators in
//   registers); one warpgroup owns 64 rows of the tile. The first two
//   products of a step (S = Q K^T and dP = dO V^T for dq; S^T = K Q^T and
//   dP^T = V dO^T for dk/dv) read both operands from shared memory. Their
//   accumulator layout is the A-operand layout of the next products, so p
//   and ds are computed in registers, packed to bf16 pairs and fed from
//   registers (dq += dS K; dv += P^T dO, dk += dS^T Q), with B read from
//   shared memory through the descriptor's transpose bit. Nothing passes
//   through shared memory between the products.
// * S and dP are committed as two groups: the exponentials of P run while
//   the tensor cores still compute dP.
// * Tiles are TMA boxes of 64 columns, 128B-swizzled: the layout that
//   wgmma's 128B-swizzle descriptors read without bank conflicts, and one
//   tile serves both as a K-major operand and, transposed, as an MN-major
//   one. One thread issues the copies into a ring of two slots with
//   full/empty mbarriers, so tile t + 1 lands while tile t's products run,
//   the other threads spend no instructions on loads, and the warpgroups
//   are tied only through the slots (no block barrier per step).
// * dq: three warpgroups (12 warps, 192 queries of one head) per block,
//   one block per SM; more warpgroups hide more of each one's chain of
//   products, exponentials and waits. Blocks are ordered so that the query
//   tiles with the most key tiles start first.
// * dk/dv: two warpgroups (8 warps, 128 keys) per block, one block per SM
//   (dk and dv take 128 of a thread's registers). The G query heads of a KV
//   head go to a thread-block cluster of CL blocks (CL = the largest divisor
//   of G up to 8, the portable cluster size; each block loops over G / CL
//   heads), which run together on neighbouring SMs. Each block sums its
//   heads' dk, dv in fp32 registers; at the end each writes its partials to
//   its own shared memory and, after a cluster barrier, block r sums rows
//   [r*128/CL, (r+1)*128/CL) of all CL partials through distributed shared
//   memory in rank order and writes bf16: no atomics, no fp32 partials in
//   device memory. Key tile 0 (the longest under causality) starts first.
// * Only tiles that the diagonal, the window edge or the ragged end cut are
//   masked element by element (a separate code path); tiles with no live
//   pair are skipped per warpgroup. exp is exp2 with log2(e) folded into
//   the scale and the lse. cudaFuncSetAttribute runs once per process.
//
// Shared memory per block (d 128): dq 2 x 48 KB (q, dO) + 2 slots x 32 KB
// (k, v) + 1.5 KB (lse, delta) = 165,376 B; dk/dv max(64 KB (k, v) + 2
// slots x 32 KB (q, dO) + 1 KB (lse, delta), 136 KB of fp32 partials) =
// 139,264 B; each + 32 B of mbarriers + 1 KB to align the base. Registers
// per thread (`-Xptxas -v`, build/kernels/flash_bwd-*.log): dq 168 (the
// cap for 384 threads), dk/dv 251, no spills.
//
// Left for later: overlapping a step's last products with the next step's
// first ones (needs a second set of accumulators, which dk/dv has no
// registers for), a producer warp with a persistent grid, and fusing dq
// into the dk/dv pass (which needs a reduction across key tiles).
#include <cuda.h>  // CUtensorMap (cuTensorMapEncodeTiled is looked up through the runtime, no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cstdint>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int DQ_THREADS = 384;  // dq: three warpgroups of 64 query rows
constexpr int THREADS = 256;     // dk/dv: two warpgroups of 64 keys

// TMA descriptors of a launch's inputs (lse and delta as flat fp32 vectors)
struct Maps {
  CUtensorMap q, k, v, dout, lse, delta;
};
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA: one thread asks for a box of a tensor map to be copied into shared
// memory; the copy adds its bytes to the mbarrier's transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Descriptor of a shared-memory operand stored as 128-byte swizzled rows of
// 64 bf16, 8-row groups 1024 bytes apart (SBO). K-major use: a row is an
// M or N index and runs along K (lbo unused, 16). MN-major use (transposed
// B): a row is a K index and runs along N; the next 64 N values sit `lbo`
// bytes further. Layout type 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define ACC8(o)                                                                                            \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]),          \
      "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 64 fp32) = (ACC ? d : 0) + A (64 x 16) B (16 x 64); A and B K-major in shared memory
#define WGMMA_SS_N64                                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                        \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"
#define OUT8(o)                                                                                            \
  "=f"(d[o + 0]), "=f"(d[o + 1]), "=f"(d[o + 2]), "=f"(d[o + 3]), "=f"(d[o + 4]), "=f"(d[o + 5]),          \
      "=f"(d[o + 6]), "=f"(d[o + 7])
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (ACC)
    asm volatile(WGMMA_SS_N64 : ACC8(0), ACC8(8), ACC8(16), ACC8(24) : "l"(a), "l"(b), "r"(1));
  else
    asm volatile(WGMMA_SS_N64 : OUT8(0), OUT8(8), OUT8(16), OUT8(24) : "l"(a), "l"(b), "r"(0));
}
#undef OUT8
#undef WGMMA_SS_N64

// d (64 x 64 fp32) += A (64 x 16, registers) B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128 fp32) += A (64 x 16, registers) B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef ACC8

// d (64 x 64) = A B^T summed over HD: A = 64 rows of a K-major tile of A_ROWS
// rows starting at a (this warpgroup's slice), B = a K-major tile of 64 rows
// at b; both stored as load_tile writes them.
template <int HD, int A_ROWS>
__device__ __forceinline__ void ss_product(float (&d)[32], uint32_t a, uint32_t b) {
  const uint64_t da0 = sw128_desc(a, 16), db0 = sw128_desc(b, 16);  // offsets below add to the address field
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint64_t da = da0 + (((kk / 4) * (A_ROWS * 128) + (kk % 4) * 32) >> 4);
    const uint64_t db = db0 + (((kk / 4) * (64 * 128) + (kk % 4) * 32) >> 4);
    if (kk == 0)
      wgmma_ss_n64<false>(d, da, db);
    else
      wgmma_ss_n64<true>(d, da, db);
  }
}

// A ring of STAGES shared-memory slots. One thread fills a slot with TMA
// copies; full[s] completes when they have landed, empty[s] when all NT
// threads are done reading the slot. The warpgroups are tied only through
// the slots and drift up to a step apart instead of meeting at a block
// barrier every step.
template <int STAGES, int NT>
struct Ring {
  uint32_t bars;  // full[0..STAGES), then empty[0..STAGES)
  __device__ uint32_t full(int i) const { return bars + 8 * (i % STAGES); }
  __device__ uint32_t empty(int i) const { return bars + 8 * (STAGES + i % STAGES); }
  __device__ void init() const {  // then __syncthreads
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), NT);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // the filling thread, before copying tile i: the slot's previous tile, i - STAGES, is released;
  // then it announces the bytes tile i brings
  __device__ void acquire(int i, uint32_t bytes) const {
    if (i >= STAGES) mbar_wait(empty(i), (i / STAGES - 1) & 1);
    mbar_expect_tx(full(i), bytes);
  }
  __device__ void wait(int i) const { mbar_wait(full(i), (i / STAGES) & 1); }
  __device__ void release(int i) const { mbar_arrive(empty(i)); }
};

// ---------------------------------------------------------------------------
// tiles, masks
// ---------------------------------------------------------------------------

// Rows [s0, s0 + R) of head `head` of batch b of a (B, S, NH, HD) tensor
// (its tensor map's box is 64 columns x R rows) into shared memory at dst as
// HD/64 column blocks of R 128-byte rows, 128B-swizzled by the TMA unit
// (16-byte chunk c of row r lands at chunk c ^ (r % 8)), block c R * 128
// bytes after block c - 1. Rows at or past S arrive as zeros.
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int b, int s0, int head, uint32_t bar) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load_4d(dst + c * (R * 128), map, 64 * c, head, s0, b, bar);
}

__device__ __forceinline__ bool live_pair(int key, int qi, int Sq, int Sk, int q_offset, int causal, int window) {
  const int qpos = qi + q_offset;
  return qi < Sq && key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// Queries [qa, qb] against keys [ka, kb]: 0 = no live pair (skip), 1 = every
// pair live (no mask), 2 = mask element by element.
__device__ __forceinline__ int classify(int qa, int qb, int ka, int kb, int Sq, int Sk, int q_offset, int causal,
                                        int window) {
  const int qbv = min(qb, Sq - 1), kbv = min(kb, Sk - 1);
  if (qbv < qa || kbv < ka) return 0;
  const int pa = qa + q_offset, pb = qbv + q_offset;
  if (causal && ka > pb) return 0;
  if (window > 0 && kbv <= pa - window) return 0;
  bool full = qb == qbv && kb == kbv;
  if (causal && kb > pa) full = false;
  if (window > 0 && ka <= pb - window) full = false;
  return full ? 1 : 2;
}

// The accumulator of an m64nN wgmma holds, in thread (warp w, lane 4g + t),
// element 4j + e at row 16w + g + 8(e / 2), column 8j + 2t + (e % 2). Its
// columns 16kk..16kk+15 are, packed to bf16 pairs, that thread's A fragment
// for the k16 step kk of the next product.
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// #17 dq
// ---------------------------------------------------------------------------

template <int HD>
struct DqSmem {
  static constexpr int BQ = 64 * DQ_THREADS / 128, BK = 64, STAGES = 2;
  static constexpr int Q = 0;                       // q tile, BQ rows
  static constexpr int DO = Q + BQ * HD * 2;        // dO tile
  static constexpr int RING = DO + BQ * HD * 2;     // slot s: k tile, then v tile
  static constexpr int STAGE = 2 * BK * HD * 2;
  static constexpr int LSE = RING + STAGES * STAGE;  // lse (BQ), then delta (BQ)
  static constexpr int BAR = LSE + 2 * BQ * 4;       // the ring's mbarriers
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
};

template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ DQ, int Sq, int Sk, int H, int KV,
                    float scale, int causal, int window) {
  using L = DqSmem<HD>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + (base - raw) + L::LSE);
  const Ring<STAGES, DQ_THREADS> ring{base + L::BAR};
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the query tiles with the most key tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int n_tiles = max(0, (kv_end + BK - 1) / BK - t_begin);

  ring.init();
  __syncthreads();
  constexpr uint32_t TILE_BYTES = 2 * BK * HD * 2;
  auto load_kv = [&](int it) {  // tile 0 also brings q, dO, lse, delta; thread 0 only
    if (it >= n_tiles) return;
    const uint32_t bar = ring.full(it);
    if (it == 0) {
      ring.acquire(it, TILE_BYTES + 2 * BQ * HD * 2 + 2 * BQ * 4);
      load_tile<HD, BQ>(base + L::Q, &maps.q, b, q0, h, bar);
      load_tile<HD, BQ>(base + L::DO, &maps.dout, b, q0, h, bar);
      tma_load_1d(base + L::LSE, &maps.lse, bh * Sq + q0, bar);
      tma_load_1d(base + L::LSE + BQ * 4, &maps.delta, bh * Sq + q0, bar);
    } else {
      ring.acquire(it, TILE_BYTES);
    }
    const uint32_t st = base + L::RING + (it % STAGES) * L::STAGE;
    const int k0 = (t_begin + it) * BK;
    load_tile<HD, BK>(st, &maps.k, b, k0, kvh, bar);
    load_tile<HD, BK>(st + BK * HD * 2, &maps.v, b, k0, kvh, bar);
  };
  if (tid == 0) load_kv(0);

  const int qa = q0 + wg * 64;              // this warpgroup's first query
  const int qrow = qa + warp * 16 + g;      // this thread's rows: qrow and qrow + 8
  const float scale2 = scale * LOG2E;
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    ring.wait(it);
    if (tid == 0) load_kv(it + 1);
    if (it == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lse2[e] = lse_s[qrow - q0 + 8 * e] * LOG2E;
        dlt[e] = lse_s[BQ + qrow - q0 + 8 * e];
      }
    }
    const int k0 = (t_begin + it) * BK;
    const int cls = classify(qa, qa + 63, k0, k0 + BK - 1, Sq, Sk, q_offset, causal, window);
    const uint32_t ks = base + L::RING + (it % STAGES) * L::STAGE, vs = ks + BK * HD * 2;

    // S = Q K^T, dP = dO V^T (64 x BK per warpgroup), both operands in shared memory
    float s[BK / 2], dp[BK / 2];
    if (cls) {
      wgmma_fence();
      ss_product<HD, BQ>(s, base + L::Q + wg * (64 * 128), ks);
      wgmma_commit();
      ss_product<HD, BQ>(dp, base + L::DO + wg * (64 * 128), vs);
      wgmma_commit();
    }
    if (cls == 0) {
      ring.release(it);
      continue;
    }

    // P = exp2(S scale log2e - lse log2e) while dP is still being computed
    wgmma_wait<1>();
    fence_regs(s);
    if (cls == 1) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = exp2_approx(fmaf(s[i], scale2, -lse2[(i / 2) % 2]));
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + i % 2, qi = qrow + 8 * ((i / 2) % 2);
        s[i] = live_pair(key, qi, Sq, Sk, q_offset, causal, window)
                   ? exp2_approx(fmaf(s[i], scale2, -lse2[(i / 2) % 2]))
                   : 0.f;
      }
    }
    // dS = P (dP - delta); the scale is applied to dq at the end
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= dp[i] - dlt[(i / 2) % 2];
    uint32_t a[BK / 16][4];
    pack_a(s, a);

    // dQ += dS K: A from registers, B = the K tile read transposed (MN-major)
    fence_regs(dq);
    wgmma_fence();
    const uint64_t kd = sw128_desc(ks, BK * 128);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(dq, a[kk], kd + kk * (16 * 128 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    ring.release(it);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = qrow + 8 * e;
    if (qi >= Sq) continue;
    bf16* dst = DQ + (static_cast<size_t>(b) * Sq + qi) * H * HD + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(dq[4 * j + 2 * e] * scale, dq[4 * j + 2 * e + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// #18 dk, dv
// ---------------------------------------------------------------------------

template <int HD>
struct DkvSmem {
  static constexpr int BK = 128, BQ = 64, STAGES = 2;
  static constexpr int K = 0, V = BK * HD * 2;       // k and v tiles, BK rows
  static constexpr int RING = 2 * BK * HD * 2;       // slot s: q tile, then dO tile
  static constexpr int STAGE = 2 * BQ * HD * 2;
  static constexpr int LSE = RING + STAGES * STAGE;  // slot s: lse (BQ), then delta (BQ)
  static constexpr int PIPE = LSE + STAGES * 2 * BQ * 4;
  static constexpr int RLD = HD + 8;                 // fp32 partial rows: dk (BK rows), then dv
  static constexpr int RED = 2 * BK * RLD * 4;       // reuses the tiles once the loop is done
  static constexpr int BAR = PIPE > RED ? PIPE : RED;  // the ring's mbarriers
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ DK, bf16* __restrict__ DV, int Sq,
                     int Sk, int H, int KV, float scale, int causal, int window) {
  using L = DkvSmem<HD>;
  constexpr int BK = L::BK, BQ = L::BQ, STAGES = L::STAGES, RLD = L::RLD;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const Ring<STAGES, THREADS> ring{base + L::BAR};
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int CL = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int G = H / KV, HPB = G / CL;  // query heads per KV head, per block
  const int bkv = blockIdx.x / CL, b = bkv / KV, kvh = bkv % KV;
  const int h_first = kvh * G + rank * HPB;
  const int k0 = blockIdx.y * BK;  // key tile 0, the longest under causality, first
  const int q_offset = Sk - Sq;

  // query rows that see some key of this tile
  const int k_last = min(k0 + BK, Sk) - 1;
  const int qi_begin = causal ? max(0, k0 - q_offset) : 0;
  const int qi_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;  // exclusive
  const int t_begin = qi_begin / BQ;
  const int nt = qi_begin < qi_end ? (qi_end + BQ - 1) / BQ - t_begin : 0;
  const int n_steps = HPB * nt;

  ring.init();
  __syncthreads();
  constexpr uint32_t STEP_BYTES = 2 * BQ * HD * 2 + 2 * BQ * 4;
  auto load_q = [&](int it) {  // step 0 also brings k and v; thread 0 only
    if (it >= n_steps) return;
    const uint32_t bar = ring.full(it);
    if (it == 0) {
      ring.acquire(it, STEP_BYTES + 2 * BK * HD * 2);
      load_tile<HD, BK>(base + L::K, &maps.k, b, k0, kvh, bar);
      load_tile<HD, BK>(base + L::V, &maps.v, b, k0, kvh, bar);
    } else {
      ring.acquire(it, STEP_BYTES);
    }
    const int hh = h_first + it / nt, q0 = (t_begin + it % nt) * BQ;
    const uint32_t qs = base + L::RING + (it % STAGES) * L::STAGE;
    const uint32_t ls = base + L::LSE + (it % STAGES) * (2 * BQ * 4);
    load_tile<HD, BQ>(qs, &maps.q, b, q0, hh, bar);
    load_tile<HD, BQ>(qs + BQ * HD * 2, &maps.dout, b, q0, hh, bar);
    tma_load_1d(ls, &maps.lse, (b * H + hh) * Sq + q0, bar);
    tma_load_1d(ls + BQ * 4, &maps.delta, (b * H + hh) * Sq + q0, bar);
  };
  if (tid == 0) load_q(0);

  const int ka = k0 + wg * 64;          // this warpgroup's first key
  const int krow = ka + warp * 16 + g;  // this thread's keys: krow and krow + 8
  const float scale2 = scale * LOG2E;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    if (tid == 0) load_q(it + 1);
    ring.wait(it);
    const int q0 = (t_begin + it % nt) * BQ;
    const int cls = classify(q0, q0 + BQ - 1, ka, ka + 63, Sq, Sk, q_offset, causal, window);
    if (cls == 0) {
      ring.release(it);
      continue;
    }
    const uint32_t qs = base + L::RING + (it % STAGES) * L::STAGE, dos = qs + BQ * HD * 2;
    const float* lse_s = reinterpret_cast<const float*>(sm + L::LSE + (it % STAGES) * (2 * BQ * 4));

    // S^T = K Q^T, dP^T = V dO^T (64 keys x BQ per warpgroup), both operands in shared memory
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
    ss_product<HD, BK>(s, base + L::K + wg * (64 * 128), qs);
    wgmma_commit();
    ss_product<HD, BK>(dp, base + L::V + wg * (64 * 128), dos);
    wgmma_commit();

    // P^T while dP^T is still being computed; the columns are queries
    wgmma_wait<1>();
    fence_regs(s);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale2, -l2[e % 2]));
    }
    if (cls == 2) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        if (!live_pair(krow + 8 * ((i / 2) % 2), q0 + 8 * (i / 4) + 2 * t + i % 2, Sq, Sk, q_offset, causal, window))
          s[i] = 0.f;
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    // dS^T = P^T (dP^T - delta); the scale is applied to dk at the end
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(lse_s + BQ + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - ((e % 2) ? dl.y : dl.x));
    }
    pack_a(s, pa);
    pack_a(dp, da);

    // dV += P^T dO, dK += dS^T Q: A from registers, B = the dO / q tile read transposed
    const uint64_t od = sw128_desc(dos, BQ * 128), qd = sw128_desc(qs, BQ * 128);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dv, pa[kk], od + kk * (16 * 128 >> 4));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(dk, da[kk], qd + kk * (16 * 128 >> 4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    ring.release(it);
  }
  __syncthreads();  // the tiles are free: reuse them for this block's fp32 partials

  float* red = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = wg * 64 + warp * 16 + g + 8 * e;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<float2*>(red + row * RLD + col) = make_float2(dk[4 * j + 2 * e], dk[4 * j + 2 * e + 1]);
      *reinterpret_cast<float2*>(red + (BK + row) * RLD + col) =
          make_float2(dv[4 * j + 2 * e], dv[4 * j + 2 * e + 1]);
    }
  }
  cluster.sync();  // every block's partials are in its shared memory

  // this block writes rows [r0, r1) of the tile: the CL partials summed in rank order
  const int r0 = BK * rank / CL, r1 = BK * (rank + 1) / CL;
  constexpr int C4 = HD / 4;
  const int n = (r1 - r0) * C4;
  for (int c = tid; c < 2 * n; c += THREADS) {
    const int which = c / n, row = r0 + (c % n) / C4, col = (c % C4) * 4;
    const int off = (which * BK + row) * RLD + col;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < CL; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + off);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const float f = which ? 1.f : scale;  // dk = scale * sum dS^T Q
    const int key = k0 + row;
    if (key < Sk) {
      bf16* dst = (which ? DV : DK) + (static_cast<size_t>(b) * Sk + key) * KV * HD + kvh * HD + col;
      *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x * f, acc.y * f), pack_bf16(acc.z * f, acc.w * f));
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

// largest divisor of G that is at most 8 (the portable cluster size)
int cluster_size(int G) {
  for (int c = 8; c > 1; --c)
    if (G % c == 0) return c;
  return 1;
}

template <int HD>
cudaError_t prepare() {  // once per process: opt in to more than 48 KB of shared memory
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqSmem<HD>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DkvSmem<HD>::BYTES);
    return e;
  }();
  return err;
}

// cuTensorMapEncodeTiled (a libcuda entry point), looked up once through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
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

// (B, S, NH, HD) bf16, read in boxes of 64 columns x R rows of one head, 128B-swizzled
bool tile_map(CUtensorMap* m, const void* ptr, int B, int S, int NH, int HD, int R) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)NH * HD * 2, (cuuint64_t)S * NH * HD * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)R, 1}, step[4] = {1, 1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n fp32 values read in boxes of R; a box that runs past a row of (B*H, Sq)
// brings the next row's values, which only masked or unwritten rows use
bool vec_map(CUtensorMap* m, const void* ptr, size_t n, int R) {
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
  const cuuint32_t box[1] = {(cuuint32_t)R}, step[1] = {1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a launch's maps: q, dO, lse and delta in boxes of r_q rows, k and v of r_kv rows
bool make_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int B, int Sq, int Sk, int H, int KV, int HD, int r_q, int r_kv) {
  for (const void* p : {q, k, v, dout, lse, delta})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const size_t n = (size_t)B * H * Sq;
  return encode_tiled() && tile_map(&m->q, q, B, Sq, H, HD, r_q) && tile_map(&m->dout, dout, B, Sq, H, HD, r_q) &&
         tile_map(&m->k, k, B, Sk, KV, HD, r_kv) && tile_map(&m->v, v, B, Sk, KV, HD, r_kv) &&
         vec_map(&m->lse, lse, n, r_q) && vec_map(&m->delta, delta, n, r_q);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  cudaError_t err = prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  if (dq) {
    using L = DqSmem<HD>;
    if (!make_maps(&maps, q, k, v, dout, lse, delta, B, Sq, Sk, H, KV, HD, L::BQ, L::BK))
      return (int)cudaErrorInvalidValue;
    flash_bwd_dq_kernel<HD><<<dim3(B * H, (Sq + L::BQ - 1) / L::BQ), DQ_THREADS, L::BYTES, stream>>>(
        maps, (bf16*)dq, Sq, Sk, H, KV, scale, causal, window);
    return (int)cudaGetLastError();
  }
  using L = DkvSmem<HD>;
  if (!make_maps(&maps, q, k, v, dout, lse, delta, B, Sq, Sk, H, KV, HD, L::BQ, L::BK))
    return (int)cudaErrorInvalidValue;
  const int CL = cluster_size(H / KV);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * CL, (Sk + L::BK - 1) / L::BK);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<HD>, maps, (bf16*)dk, (bf16*)dv, Sq, Sk, H, KV, scale,
                           causal, window);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
             void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, int d, float scale,
             int causal, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128) return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, scale, causal, window, s);
  if (d == 64) return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int Sq, int Sk, int H, int KV, int d,
                            float scale, int causal, int window, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H, KV, d, scale, causal, window,
                  stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, int d,
                             float scale, int causal, int window, void* stream) {
  return dispatch(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H, KV, d, scale, causal, window,
                  stream);
}
