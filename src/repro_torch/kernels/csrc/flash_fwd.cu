// Flash-attention forward (causal / sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py,
// flash_attention -> _fa_call -> _fa_kernel.
//
// q (B, Sq, H, d), k/v (B, Sk, KV, d) bf16 in the model's own layout; out
// (B, Sq, H, d) bf16 and lse (B*H, Sq) fp32 in natural-log units (read by
// flash_bwd.cu). Positions are implicit and right-aligned: query i sits at
// i + Sk - Sq. Head dims 64 and 128. A masked (query, key) pair gets p = 0,
// as the TPU kernel's -1e30 score gives; a row's statistics m, l and its
// accumulator stay fp32, p is rounded to bf16 before P V (as in the TPU
// kernel), and the output is rounded to bf16 once. No atomics: two launches
// give bit-equal outputs.
//
// What bounds it on an H100: at the training shape (S 2048, d 128, H 32 /
// KV 8, causal) two products of 2*d FLOP per live (query, key) pair, 34.4
// GFLOP, 0.0347 ms at 989 TFLOP/s, against 42 MB of inputs and outputs
// (0.0125 ms at 3.35 TB/s): bound by operations. At prefill lengths (16 to
// 512) the grid is a few dozen to a few hundred blocks and the bound is a
// few microseconds: launch and pipeline fill dominate.
//
// The design is the forward half of flash_bwd.cu's dq kernel, on
// sm90_gemm.cuh's helpers:
// * A block owns BQ = 128 queries of one head: two consumer warpgroups of
//   64 rows each, plus one producer warp. One thread of the producer warp
//   loads Q once and then walks the block's key tiles (64 keys) with TMA:
//   K and V of a tile go to one slot of a 4-slot ring behind full/empty
//   mbarriers; a slot is released by the 8 consumer warps once the tile's
//   products have completed. The Q, K and V boxes are 64 columns of one
//   head, 128B-swizzled, read through 3D tensor maps over (S rows, H * d
//   columns, B), so rows past Sq or Sk arrive as zeros and no box reads
//   another batch's rows; the KV head h / (H / KV) is read in place.
// * S = Q K^T is a wgmma m64n64k16 with both operands in shared memory
//   (K-major, d / 16 steps). The online softmax runs in registers on the
//   accumulator layout (a thread holds 2 rows x 16 keys; the row max is
//   reduced over the 4 lanes of a quad, the row sum stays per thread
//   until the end): exp2 with log2(e) folded into the scale, the running
//   max kept in those units, and the lse written as (m + log2 l) ln 2.
// * P is packed to bf16 pairs as the register A operand of O += P V
//   (wgmma m64n{d}k16), V read as an N-major B through the transpose bit;
//   no score tile passes through shared memory. The product is left in
//   flight while the warpgroup waits for the next tile and issues its
//   S = Q K^T; a single wait covers both.
// * The two warpgroups take turns to issue S = Q K^T (named barriers 2 and
//   3, one arrive and one sync a tile each, balanced at the end), so that
//   one's softmax runs under the other's products rather than both
//   softmaxes at once.
// * Only tiles cut by the diagonal, the window edge or the ragged end are
//   masked element by element; a warpgroup skips a tile with no live pair
//   (it still waits for the slot, takes its turn and releases it). Blocks
//   run the query tiles with the most key tiles first.
// * The epilogue divides by the row sum and stores bf16 pairs and the lse
//   from registers.
//
// Shared memory per block (d 128): Q 32 KB + 4 slots x 32 KB (K, V) + 72 B
// of mbarriers + 1 KB to align the base = 164,936 B; (d 64) 83,016 B. One
// block of 288 threads per SM. Registers (ptxas -v,
// build/kernels/flash_fwd-*.log): 165 at d 128, 132 at d 64, no spills
// (ptxas holds 9-warp blocks to 168).
//
// Tried on the card and dropped (variant builds; PERF.md): 128-key tiles
// (S 64 and P 32 registers more: spills at 168, slower at every length,
// also with the product not left in flight), Q held in registers as the A
// of S = Q K^T (halves that product's shared-memory reads, but spills),
// skipping the rescale of O when no row max moved (a warp vote each tile:
// slower). The turns gained 1-4% at S 512 and under 1% at S 2048.
//
// Left for later: at S 2048 the kernel runs at ~41% of the tensor-core
// peak; S = Q K^T at n64 reads 4 KB of shared memory per 32 tensor-core
// cycles, the whole port's width, so a second S accumulator (the next
// tile's product under this tile's softmax) or 128-key tiles need the
// registers that setmaxnreg would move from the producer warp; sharing K/V
// between the G query heads of a KV head through a cluster; a TMA store of
// the output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

#include "sm90_gemm.cuh"

namespace {

using sm90::bf16;

constexpr int NWG = 2;                  // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NWG;            // queries per block
constexpr int BK = 64;                  // keys per tile
constexpr int CONSUMERS = 128 * NWG;    // then one producer warp
constexpr int THREADS = CONSUMERS + 32;
constexpr int STAGES = 4;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
constexpr float NEG = -1e30f;           // a row's running max before its first live key

// q (B, Sq, H*d), k and v (B, Sk, KV*d) in boxes of 64 columns x BQ (q) or BK rows
struct Maps {
  CUtensorMap q, k, v;
};

template <int HD>
struct Layout {
  static constexpr int Q = 0;                    // HD / 64 boxes of BQ rows
  static constexpr int RING = BQ * HD * 2;       // slot s: K tile (HD / 64 boxes of BK rows), then V tile
  static constexpr int KV_BYTES = BK * HD * 2, STAGE = 2 * KV_BYTES;
  static constexpr int BAR = RING + STAGES * STAGE;  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align the base to 1024
};

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

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ O, float* __restrict__ LSE, int Sq, int Sk,
                 int H, int KV, float scale, int causal, int window) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  auto full = [&](int s) { return base + L::BAR + 8 * (1 + s); };
  auto empty = [&](int s) { return base + L::BAR + 8 * (1 + STAGES + s); };
  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the query tiles with the most key tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q_offset = Sk - Sq;
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + q_offset + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int n_tiles = max(0, (kv_end + BK - 1) / BK - t_begin);

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), CONSUMERS / 32);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      sm90::mbar_expect_tx(q_full, BQ * HD * 2);
#pragma unroll
      for (int c = 0; c < HD / 64; ++c)
        sm90::tma_load_3d(base + L::Q + c * (BQ * 128), &maps.q, h * HD + 64 * c, q0, b, q_full);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(empty(s), (it / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(s), L::STAGE);
        const uint32_t ks = base + L::RING + s * L::STAGE, vs = ks + L::KV_BYTES;
        const int k0 = (t_begin + it) * BK;
#pragma unroll
        for (int c = 0; c < HD / 64; ++c) {
          sm90::tma_load_3d(ks + c * (BK * 128), &maps.k, kvh * HD + 64 * c, k0, b, full(s));
          sm90::tma_load_3d(vs + c * (BK * 128), &maps.v, kvh * HD + 64 * c, k0, b, full(s));
        }
      }
    }
    return;
  }

  const int warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const bool lead = lane == 0;
  const int qa = q0 + wg * 64;          // this warpgroup's first query
  const int qrow = qa + warp * 16 + g;  // this thread's rows: qrow and qrow + 8
  const float scale2 = scale * LOG2E;
  const uint32_t qs = base + L::Q + wg * (64 * 128);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // running max (scaled, log2 units), this thread's part of the sum
  uint32_t p[BK / 16][4];                       // P of the product that may still be in flight
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = 0u;
  int held = -1;  // the slot that product reads

  sm90::mbar_wait(q_full, 0);
  if (wg == 1) sm90::named_arrive(2, CONSUMERS);  // warpgroup 0 issues first
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    sm90::mbar_wait(full(s), (it / STAGES) & 1);
    const int k0 = (t_begin + it) * BK;
    const int cls = classify(qa, qa + 63, k0, k0 + BK - 1, Sq, Sk, q_offset, causal, window);
    sm90::named_sync(2 + wg, CONSUMERS);  // this warpgroup's turn to issue S = Q K^T
    if (cls == 0) {
      sm90::named_arrive(3 - wg, CONSUMERS);
      if (lead) sm90::mbar_arrive(empty(s));
      continue;
    }
    const uint32_t ks = base + L::RING + s * L::STAGE, vs = ks + L::KV_BYTES;

    // S = Q K^T (64 x BK), both operands K-major in shared memory
    float sc[BK / 2];
    const uint64_t da = sm90::sw128_desc(qs, 16), db = sm90::sw128_desc(ks, 16);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // 32 bytes along a row; the next 64 columns in the next box
      const uint64_t a = da + (((kk / 4) * (BQ * 128) + (kk % 4) * 32) >> 4);
      const uint64_t bb = db + (((kk / 4) * (BK * 128) + (kk % 4) * 32) >> 4);
      if (kk == 0)
        sm90::wgmma_ss_n64<false>(sc, a, bb);
      else
        sm90::wgmma_ss_n64<true>(sc, a, bb);
    }
    sm90::wgmma_commit();
    sm90::named_arrive(3 - wg, CONSUMERS);  // the other warpgroup's turn
    sm90::wgmma_wait<0>();  // S, and the previous tile's P V
    sm90::fence_regs(sc);
    sm90::fence_regs(o);
    sm90::fence_frags(p);
    if (held >= 0 && lead) sm90::mbar_arrive(empty(held));
    held = s;

    // online softmax; element i of a thread sits at row (i / 2) % 2, key 8 (i / 4) + 2t + i % 2
    float mx[2] = {-INFINITY, -INFINITY};
    if (cls == 2) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        if (!live_pair(k0 + 8 * (i / 4) + 2 * t + i % 2, qrow + 8 * ((i / 2) % 2), Sq, Sk, q_offset, causal,
                       window))
          sc[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * scale2);
      corr[r] = sm90::exp2_approx(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = sm90::exp2_approx(fmaf(sc[i], scale2, -m[(i / 2) % 2]));  // a masked -inf gives 0
      l[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) % 2];
    sm90::pack_a(sc, p);

    // O += P V: A from registers, B = the V tile read transposed (N-major)
    const uint64_t vd = sm90::sw128_desc(vs, BK * 128);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) sm90::wgmma_rs<1>(o, p[kk], vd + kk * (16 * 128 >> 4));
    sm90::wgmma_commit();
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_frags(p);
  if (held >= 0 && lead) sm90::mbar_arrive(empty(held));
  if (wg == 0) sm90::named_sync(2, CONSUMERS);  // warpgroup 1's last arrival

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = qrow + 8 * r;
    if (qi >= Sq) continue;
    const float ls = fmaxf(lr, 1e-30f), inv = 1.f / ls;
    bf16* dst = O + (static_cast<size_t>(b) * Sq + qi) * H * HD + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = sm90::pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0) LSE[static_cast<size_t>(bh) * Sq + qi] = (m[r] + log2f(ls)) * LN2;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
           float scale, int causal, int window, cudaStream_t stream) {
  using L = Layout<HD>;
  static const cudaError_t attr =  // once per process and head dim
      cudaFuncSetAttribute(flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  if (!sm90::map_3d(&maps.q, q, (uint64_t)H * HD, Sq, B, BQ) || !sm90::map_3d(&maps.k, k, (uint64_t)KV * HD, Sk, B, BK) ||
      !sm90::map_3d(&maps.v, v, (uint64_t)KV * HD, Sk, B, BK))
    return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<HD><<<dim3(B * H, (Sq + BQ - 1) / BQ), THREADS, L::BYTES, stream>>>(
      maps, (bf16*)out, (float*)lse, Sq, Sk, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq, int Sk,
                         int H, int KV, int d, float scale, int causal, int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, KV, scale, causal, window, (cudaStream_t)stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, KV, scale, causal, window, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
