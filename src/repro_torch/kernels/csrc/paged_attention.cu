// Paged-attention decode (one query token per sequence, GQA) for Hopper
// (sm_90a), for bf16 KV pages and for int8 KV pages with per-token scales.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention.py:
// paged_attention -> _pa_kernel (bf16 pages, #19) and paged_attention_q8 ->
// _pa_kernel_q8 (int8 pages, dequantised in the tile, #20).
//
// q (B, H, d) bf16; k/v pools (num_pages, ps, KV, d), bf16 or int8; for
// int8 the fp32 scale sidecars (num_pages, ps, KV, 1); block_table (B,
// maxP) int32, -1 = no page; seq_lens (B,) int32, the current token
// included; out (B, H, d) bf16. Logical key j of sequence b lives at
// pool[block_table[b, j / ps], j % ps]. A key at position p is live iff
// p < seq_lens[b] and, with a window, p > seq_lens[b] - 1 - window. A row
// with no live key (an idle slot) writes zeros.
//
// What bounds it on an H100: bytes. Each live key is read once per KV head
// and does 4*G*d FLOP against 2*d (bf16) or 2*(d + 4) (int8) bytes, far
// below the card's ~295 FLOP/byte ridge; a long row has to stream its pages
// from many SMs at once, with many pages in flight on each.
//
// The design:
// * A (sequence, KV head) is split over a thread-block cluster of CL
//   blocks (grid (CL, KV, B); CL 1, 2, 4 or 8, the portable size, chosen
//   by the host from the table width maxP alone, paged_attention.py
//   cluster_size: no host read of seq_lens). The row's live keys are
//   numbered in units of 16 keys (a page of ps > 16 is ceil(ps / 16)
//   units, a smaller page one unit of ps keys); block r of the cluster
//   takes units [first + n r / CL, first + n (r + 1) / CL) of the n live
//   ones, and its 3 warps take every 3rd unit of that run. The block
//   first copies its run of block_table into shared memory; a unit under
//   page -1 is skipped, and no page outside the live range is ever
//   fetched.
// * The page ring: each warp keeps its own ring of 16 KB (bf16 at d 128:
//   2 slots of 8 KB; int8: 4 slots of 4 KB). Lane 0 fetches one head's 16
//   keys of K and of V with one TMA box each (a 3D tensor map over (d, KV,
//   num_pages * ps), box (<= 128 bytes of d, 1, 16 keys), 128B-swizzled,
//   64B for a 64-byte row, two boxes for a bf16 row of 256 bytes) against
//   the slot's mbarrier; for int8 the 32 lanes add the unit's 16 k and 16 v
//   scales with 4-byte cp.async that arrive on the same mbarrier (a TMA
//   box cannot take one 4-byte scale a row). A warp refills a slot as soon
//   as it has read it. Small blocks are the point: the time a block spends
//   on its three dependent reads (seq_lens, block_table, the first boxes)
//   and on the cluster merge at its end is hidden only by other resident
//   blocks: 4 blocks an SM (62 clusters of 8 at once) ran the long case of
//   PERF.md faster than 2 blocks of 4 warps with 24 KB rings, or deeper
//   rings, in bf16 and more so in int8.
// * Compute from shared memory with mma.sync m16n8k16 (bf16, fp32 sums):
//   S^T (16 keys x 8 heads, G <= 8 query heads of the KV head, the rest
//   zero) = K q^T from ldmatrix fragments; the online softmax (fp32, exp2
//   with log2 e folded into the scale) runs on the accumulator; P^T is
//   packed to bf16 (as _pa_kernel rounds p before P.V) and turned into the
//   B operand with movmatrix; acc^T (d x 8 heads) += V^T P^T with V^T from
//   ldmatrix.trans. Keys of a unit that are not live get S = -1e30 and a
//   zeroed V row, so whatever those rows of shared memory hold (stale data,
//   NaN) never reaches the output. int8: the bytes are widened to bf16
//   (exact) after ldmatrix by byte permutes and an fp32 add (the
//   int-to-float conversion instructions run at a quarter of the rate and
//   slowed the long case), the k scale multiplies S and the v scale p, in
//   fp32 before p is rounded.
// * One fixed-order merge, no atomics and no workspace in device memory:
//   each warp leaves (m, l, acc) in its own ring; the block merges its 3
//   warps in warp order; after a cluster barrier block r merges the CL
//   block partials in rank order through distributed shared memory for its
//   share of the G x d outputs and writes them. An empty partial (m =
//   -1e30, l = 0) weighs nothing; an idle row writes zeros. Two launches
//   are bit-equal.
//
// ptxas (sm_90a, -O3): no spill; registers a thread bf16 d 128: 151, int8
// d 128: 167, bf16 d 64: 104, int8 d 64: 112 (launch bound 4 blocks of 96
// threads). Dynamic shared memory a block, with a 22-page table at CL 8
// (PTAB run of 5): bf16 d 128 54,404 B, int8 d 128 55,988 B; 4 bytes more
// a block_table entry of the run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "sm90_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using sm90::bf16;

constexpr int NW = 3;              // warps per block, each with its own ring
constexpr int THREADS = NW * 32;
constexpr int GMAX = 8;            // most query heads per KV head (the mma's N)
constexpr int UNIT = 16;           // keys per unit (the mma's M, then its K)
constexpr int CLUSTER_MAX = 8;     // the portable cluster size
constexpr int PTAB_MAX = 4096;     // most block_table entries a block copies
constexpr int RING_PER_WARP = 16 * 1024;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of one block, from its 1024-aligned base: the warps'
// rings (each warp's partial (m, l, acc) reuses its ring at the end), the
// int8 scales of each slot, the block's merged partial, the mbarriers and
// the block's run of block_table.
template <typename KT, int HD>
struct Smem {
  static constexpr bool Q8 = sizeof(KT) == 1;
  static constexpr int ROWB = HD * (int)sizeof(KT);        // bytes of one key's row of d
  static constexpr int BOXB = ROWB < 128 ? ROWB : 128;     // bytes of a box row: the swizzle span
  static constexpr int NBOX = ROWB / BOXB;
  static constexpr int BOX = UNIT * BOXB;
  static constexpr int TILE = NBOX * BOX;                  // 16 keys of K (or of V)
  static constexpr int SLOT = 2 * TILE;
  static constexpr int R = RING_PER_WARP / SLOT < 8 ? RING_PER_WARP / SLOT : 8;
  static constexpr int SCALES = NW * R * SLOT;             // int8: 16 k then 16 v scales a slot
  static constexpr int PART = SCALES + (Q8 ? NW * R * 2 * UNIT * 4 : 0);
  static constexpr int PART_FLOATS = 2 * GMAX + GMAX * HD;  // m[8], l[8], acc[8][HD]
  static constexpr int BARS = PART + PART_FLOATS * 4;
  static constexpr int PTAB = BARS + NW * R * 8;
  static constexpr int bytes(int run_cap) { return PTAB + 4 * run_cap + 1024; }  // + slack to align the base
  static_assert(SLOT % 1024 == 0 && R >= 2 && PART_FLOATS * 4 <= R * SLOT, "shared memory layout");
};

// Byte offset of 16-byte chunk c of key row r in a K or V tile: NBOX boxes
// of 16 rows x BOXB bytes, each laid down by TMA in the BOXB-byte swizzle
// (chunk bits XOR address bits 7 and up), so the 8 rows an ldmatrix reads
// for one chunk sit in 8 different bank groups.
template <class L>
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  constexpr int CPB = L::BOXB / 16;  // chunks per box row
  const uint32_t lin = r * L::BOXB + (c % CPB) * 16;
  return (c / CPB) * L::BOX + (lin ^ (((lin >> 7) & (CPB - 1)) << 4));
}

// The four int8 of x widened without the quarter-rate conversion unit: byte
// i, biased to x_i + 128, becomes the low mantissa byte of the fp32 2^23,
// and 2^23 + 128 is taken off (exact). |x_i| <= 128 has at most 7
// significant bits, so the upper half of each fp32 is its bf16, exact.
__device__ __forceinline__ void i8x4_f32(uint32_t x, uint32_t (&f)[4]) {
  const uint32_t u = x ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7540 + i)) - 8388736.f);
}
// the bf16 of a (low half) and b (high half), two fp32 that i8x4_f32 made
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t a, uint32_t b) { return __byte_perm(a, b, 0x7632); }

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

struct Maps {
  CUtensorMap k, v;
};

template <typename KT, int HD>
__global__ void __launch_bounds__(THREADS, 4)
paged_attention_kernel(const __grid_constant__ Maps maps, const bf16* __restrict__ Q, const float* __restrict__ Ks,
                       const float* __restrict__ Vs, const int* __restrict__ BT, const int* __restrict__ SL,
                       bf16* __restrict__ O, int H, int KV, int ps, int maxP, float scale, int window) {
  using namespace sm90;
  using L = Smem<KT, HD>;
  constexpr bool Q8 = L::Q8;
  constexpr int R = L::R, KS = HD / 16;  // k-steps of S; also the m-tiles of acc^T
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int CL = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int kv = blockIdx.y, b = blockIdx.z, G = H / KV;

  // the row's live keys [lo, hi), its live units [first, end), this block's run [u0, u1)
  const int nch = (ps + UNIT - 1) / UNIT;  // units per page
  const int n = SL[b];
  const int hi = min(n, maxP * ps), lo = window > 0 ? max(n - window, 0) : 0;
  int u0 = 0, u1 = 0;
  if (lo < hi) {
    const int first = (lo / ps) * nch + (lo % ps) / UNIT;
    const int end = ((hi - 1) / ps) * nch + ((hi - 1) % ps) / UNIT + 1;
    u0 = first + (end - first) * rank / CL;
    u1 = first + (end - first) * (rank + 1) / CL;
  }
  const int pg0 = u0 / nch, npg = u0 < u1 ? (u1 - 1) / nch - pg0 + 1 : 0;
  int* ptab = reinterpret_cast<int*>(sm + L::PTAB);
  for (int i = tid; i < npg; i += THREADS) ptab[i] = BT[static_cast<size_t>(b) * maxP + pg0 + i];
  const uint32_t bar0 = base + L::BARS + warp * R * 8;
  if (lane == 0) {
    for (int s = 0; s < R; ++s) mbar_init(bar0 + 8 * s, Q8 ? 1 + 32 : 1);  // int8: + one cp.async arrival a lane
    fence_mbar_init();
  }
  // q as the B operand of S^T = K q^T (head g, zero past G): k-step kk covers
  // d 16kk..16kk+15; thread t holds d 16kk + 2t, +1 and 16kk + 8 + 2t, +1
  // (bf16), or 16kk + 4t .. +3 (int8, matching the widened K fragments)
  uint32_t qf[KS][2];
  const bf16* qrow = Q + (static_cast<size_t>(b) * H + kv * G + g) * HD;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qf[kk][0] = g < G ? ld_u32(qrow + 16 * kk + (Q8 ? 4 * t : 2 * t)) : 0u;
    qf[kk][1] = g < G ? ld_u32(qrow + 16 * kk + (Q8 ? 4 * t + 2 : 8 + 2 * t)) : 0u;
  }
  __syncthreads();

  const int box_rows = ps < UNIT ? ps : UNIT;
  const uint32_t tx = 2 * box_rows * L::ROWB;  // bytes of one unit's K and V boxes
  auto page_of = [&](int u) { return ptab[u / nch - pg0]; };
  auto next_live = [&](int u) {  // this warp's next unit from u on whose page is assigned
    while (u < u1 && page_of(u) < 0) u += NW;
    return u;
  };
  int iu = next_live(u0 + warp), fetched = 0;
  auto fetch = [&]() {  // every lane: the next unit into the next slot
    if (iu >= u1) return;
    const int s = fetched % R;
    const int row = page_of(iu) * ps + (iu % nch) * UNIT;  // the pool row of the unit's first key
    const uint32_t slot = base + (warp * R + s) * L::SLOT, bar = bar0 + 8 * s;
    if (lane == 0) {
      mbar_expect_tx(bar, tx);
#pragma unroll
      for (int x = 0; x < L::NBOX; ++x) {
        const int c0 = x * (L::BOXB / static_cast<int>(sizeof(KT)));
        tma_load_3d(slot + x * L::BOX, &maps.k, c0, kv, row, bar);
        tma_load_3d(slot + L::TILE + x * L::BOX, &maps.v, c0, kv, row, bar);
      }
    }
    if constexpr (Q8) {
      const int r = lane % UNIT;
      if ((iu % nch) * UNIT + r < ps)
        cp_async_4(base + L::SCALES + ((warp * R + s) * 32 + lane) * 4,
                   (lane < UNIT ? Ks : Vs) + static_cast<size_t>(row + r) * KV + kv);
      cp_async_arrive(bar);
    }
    ++fetched;
    iu = next_live(iu + NW);
  };
  for (int k = 0; k < R; ++k) fetch();

  const float scale2 = scale * LOG2E;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // heads 2t, 2t+1; l summed over this thread's keys only
  float acc[KS][4];                             // acc^T: m-tile i of d, heads 2t, 2t+1
#pragma unroll
  for (int i = 0; i < KS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // this lane's ldmatrix row and chunk offset: K (and int8 V) read matrices
  // (keys 0-7, c), (8-15, c), (0-7, c+1), (8-15, c+1); bf16 V (0-7, c), (0-7, c+1), (8-15, c), (8-15, c+1)
  const int ar = lane % 8 + 8 * ((lane / 8) % 2), ac = lane / 16;
  const int vr = Q8 ? ar : lane % 8 + 8 * (lane / 16), vc = Q8 ? ac : (lane / 8) % 2;
  int done = 0;
  for (int u = next_live(u0 + warp); u < u1; u = next_live(u + NW), ++done) {
    const int s = done % R;
    const uint32_t kt = base + (warp * R + s) * L::SLOT, vt = kt + L::TILE;
    mbar_wait(bar0 + 8 * s, (done / R) & 1);
    const int key0 = (u / nch) * ps + (u % nch) * UNIT;
    const int nrow = min(UNIT, ps - (u % nch) * UNIT);  // keys of this unit in its page
    auto live = [&](int j) { return j < nrow && key0 + j >= lo && key0 + j < hi; };

    // S^T = K q^T over d, in two interleaved chains
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (Q8) {
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t x[4];
        ldsm_x4<false>(kt + chunk_at<L>(ar, kk + ac), x);  // each: 4 bytes of d of key g (or g + 8)
        uint32_t f[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) i8x4_f32(x[j], f[j]);
        const uint32_t a0[4] = {bf16x2_of(f[0][0], f[0][1]), bf16x2_of(f[1][0], f[1][1]),
                                bf16x2_of(f[0][2], f[0][3]), bf16x2_of(f[1][2], f[1][3])};
        const uint32_t a1[4] = {bf16x2_of(f[2][0], f[2][1]), bf16x2_of(f[3][0], f[3][1]),
                                bf16x2_of(f[2][2], f[2][3]), bf16x2_of(f[3][2], f[3][3])};
        mma_16816(sa, a0, qf[kk][0], qf[kk][1]);
        mma_16816(sb, a1, qf[kk + 1][0], qf[kk + 1][1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldsm_x4<false>(kt + chunk_at<L>(ar, 2 * kk + ac), a);
        if (kk % 2)
          mma_16816(sb, a, qf[kk][0], qf[kk][1]);
        else
          mma_16816(sa, a, qf[kk][0], qf[kk][1]);
      }
    }
    // the thread's keys g and g + 8, heads 2t and 2t + 1
    float ks0 = scale2, ks1 = scale2, vs0 = 1.f, vs1 = 1.f;
    if constexpr (Q8) {
      const float* sc = reinterpret_cast<const float*>(sm + L::SCALES) + (warp * R + s) * 32;
      ks0 *= sc[g];
      ks1 *= sc[g + 8];
      vs0 = sc[UNIT + g];
      vs1 = sc[UNIT + g + 8];
    }
    const bool l0 = live(g), l1 = live(g + 8);
    const float s0 = l0 ? (sa[0] + sb[0]) * ks0 : NEG, s1 = l0 ? (sa[1] + sb[1]) * ks0 : NEG;
    const float s2 = l1 ? (sa[2] + sb[2]) * ks1 : NEG, s3 = l1 ? (sa[3] + sb[3]) * ks1 : NEG;
    float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // over the 8 lanes that hold the other keys
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float c0 = exp2f(m[0] - mn0), c1 = exp2f(m[1] - mn1);
    m[0] = mn0;
    m[1] = mn1;
    const float p0 = l0 ? exp2f(s0 - mn0) : 0.f, p1 = l0 ? exp2f(s1 - mn1) : 0.f;
    const float p2 = l1 ? exp2f(s2 - mn0) : 0.f, p3 = l1 ? exp2f(s3 - mn1) : 0.f;
    l[0] = l[0] * c0 + (p0 + p2);
    l[1] = l[1] * c1 + (p1 + p3);
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c1;
      acc[i][2] *= c0;
      acc[i][3] *= c1;
    }
    // P^T (16 keys x 8 heads) as the B operand: p in bf16 (int8: times the v scale, in fp32 first)
    const uint32_t pb0 = movmatrix_trans(sm90::pack_bf16(l0 ? p0 * vs0 : 0.f, l0 ? p1 * vs0 : 0.f));
    const uint32_t pb1 = movmatrix_trans(sm90::pack_bf16(l1 ? p2 * vs1 : 0.f, l1 ? p3 * vs1 : 0.f));
    // V^T fragments hold keys 2t, 2t+1 (a[0], a[1]) and 2t+8, 2t+9 (a[2], a[3]); dead keys are zeroed
    const uint32_t mlo = (live(2 * t) ? 0x0000ffffu : 0u) | (live(2 * t + 1) ? 0xffff0000u : 0u);
    const uint32_t mhi = (live(2 * t + 8) ? 0x0000ffffu : 0u) | (live(2 * t + 9) ? 0xffff0000u : 0u);
    if constexpr (Q8) {
#pragma unroll
      for (int c = 0; c < KS; c += 2) {  // chunk c of V: d 16c + 2g (rows g) and 16c + 2g + 1 (rows g + 8)
        uint32_t y[4];
        ldsm_x4<true>(vt + chunk_at<L>(vr, c + vc), y);  // each: d 2g, 2g+1 of keys 2t, 2t+1 (or + 8)
        uint32_t f[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) i8x4_f32(y[j], f[j]);
        const uint32_t a0[4] = {bf16x2_of(f[0][0], f[0][2]) & mlo, bf16x2_of(f[0][1], f[0][3]) & mlo,
                                bf16x2_of(f[1][0], f[1][2]) & mhi, bf16x2_of(f[1][1], f[1][3]) & mhi};
        const uint32_t a1[4] = {bf16x2_of(f[2][0], f[2][2]) & mlo, bf16x2_of(f[2][1], f[2][3]) & mlo,
                                bf16x2_of(f[3][0], f[3][2]) & mhi, bf16x2_of(f[3][1], f[3][3]) & mhi};
        mma_16816(acc[c], a0, pb0, pb1);
        mma_16816(acc[c + 1], a1, pb0, pb1);
      }
    } else {
#pragma unroll
      for (int i = 0; i < KS; ++i) {  // d 16i + g (rows g) and 16i + 8 + g (rows g + 8)
        uint32_t a[4];
        ldsm_x4<true>(vt + chunk_at<L>(vr, 2 * i + vc), a);
        a[0] &= mlo;
        a[1] &= mlo;
        a[2] &= mhi;
        a[3] &= mhi;
        mma_16816(acc[i], a, pb0, pb1);
      }
    }
    __syncwarp();  // every lane has read the slot
    fetch();
  }

  // this warp's partial, in its own ring: every unit it asked for has landed and been read
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    l[0] += __shfl_xor_sync(0xffffffffu, l[0], o);
    l[1] += __shfl_xor_sync(0xffffffffu, l[1], o);
  }
  float* part = reinterpret_cast<float*>(sm + warp * R * L::SLOT);
  if (g == 0) {
    part[2 * t] = m[0];
    part[2 * t + 1] = m[1];
    part[GMAX + 2 * t] = l[0];
    part[GMAX + 2 * t + 1] = l[1];
  }
  float* pacc = part + 2 * GMAX;
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int d0 = Q8 ? 16 * i + 2 * g : 16 * i + g, d1 = Q8 ? d0 + 1 : d0 + 8;
    pacc[2 * t * HD + d0] = acc[i][0];
    pacc[(2 * t + 1) * HD + d0] = acc[i][1];
    pacc[2 * t * HD + d1] = acc[i][2];
    pacc[(2 * t + 1) * HD + d1] = acc[i][3];
  }
  __syncthreads();

  // the block's partial: its warps merged in warp order
  float* bp = reinterpret_cast<float*>(sm + L::PART);
  for (int e = tid; e < G * HD; e += THREADS) {
    const int h = e / HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, reinterpret_cast<const float*>(sm + w * R * L::SLOT)[h]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* pw = reinterpret_cast<const float*>(sm + w * R * L::SLOT);
      const float f = exp2f(pw[h] - M);
      Ls += pw[GMAX + h] * f;
      A += pw[2 * GMAX + e] * f;
    }
    bp[2 * GMAX + e] = A;
    if (e % HD == 0) {
      bp[h] = M;
      bp[GMAX + h] = Ls;
    }
  }
  cluster.sync();  // every block's partial is in its shared memory

  // block r writes its share of the G x HD outputs: the CL partials merged in rank order
  const int E = G * HD;
  bf16* out = O + (static_cast<size_t>(b) * H + kv * G) * HD;
  for (int e = E * rank / CL + tid; e < E * (rank + 1) / CL; e += THREADS) {
    const int h = e / HD;
    float mr[CLUSTER_MAX], M = NEG;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      mr[r] = r < CL ? *cluster.map_shared_rank(bp + h, r) : NEG;
      M = fmaxf(M, mr[r]);
    }
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < CLUSTER_MAX; ++r) {
      if (r < CL) {
        const float f = exp2f(mr[r] - M);
        Ls += *cluster.map_shared_rank(bp + GMAX + h, r) * f;
        A += *cluster.map_shared_rank(bp + 2 * GMAX + e, r) * f;
      }
    }
    out[e] = __float2bfloat16(Ls > 0.f ? A / Ls : 0.f);
  }
  cluster.sync();  // no block leaves while another still reads its partial
}

// One KV head's rows of a pool (num_pages, ps, KV, d) as a 3D tensor map
// over (d, KV, num_pages * ps), read in boxes of (<= 128 bytes of d, 1,
// box_rows keys), 128B-swizzled (64B for a 64-byte row); bf16, or int8 read
// as bytes. False if the base is not 16-byte aligned or the map is refused.
bool pool_map(CUtensorMap* m, const void* ptr, int elem, int hd, int kv, long long rows, int box_rows) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || !sm90::encode_tiled()) return false;
  const int boxb = hd * elem < 128 ? hd * elem : 128;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)kv, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * elem, (cuuint64_t)kv * hd * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(boxb / elem), 1, (cuuint32_t)box_rows}, step[3] = {1, 1, 1};
  return sm90::encode_tiled()(m, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                              const_cast<void*>(ptr), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              boxb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// block_table entries a block copies: at most ceil(maxP / cl) + 2 pages
// (a run of units starts and ends inside pages)
long long run_cap(int maxP, int cl) { return (maxP + cl - 1) / cl + 2; }

template <typename KT, int HD>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs, const void* bt,
           const void* sl, void* out, int B, int H, int KV, int num_pages, int ps, int maxP, int cl, float scale,
           int window, cudaStream_t stream) {
  using L = Smem<KT, HD>;
  if (run_cap(maxP, cl) > PTAB_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<KT, HD>;
  // once per process: opt in to the most shared memory a launch may ask for
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes(PTAB_MAX));
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  const long long rows = static_cast<long long>(num_pages) * ps;
  const int box_rows = ps < UNIT ? ps : UNIT;
  if (!pool_map(&maps.k, k, sizeof(KT), HD, KV, rows, box_rows) ||
      !pool_map(&maps.v, v, sizeof(KT), HD, KV, rows, box_rows))
    return (int)cudaErrorInvalidValue;
  return sm90::launch_cluster(kernel, dim3(cl, KV, B), cl, THREADS, L::bytes((int)run_cap(maxP, cl)), stream, maps,
                              (const bf16*)q, (const float*)ks, (const float*)vs, (const int*)bt, (const int*)sl,
                              (bf16*)out, H, KV, ps, maxP, scale, window);
}

bool shapes_ok(int B, int H, int KV, int num_pages, int ps, int maxP, int cl) {
  return B > 0 && B < 65536 && KV > 0 && KV < 65536 && H % KV == 0 && H / KV <= GMAX && ps > 0 && maxP > 0 &&
         num_pages > 0 && static_cast<long long>(num_pages) * ps < (1ll << 31) &&
         static_cast<long long>(maxP) * ps < (1ll << 31) && (cl == 1 || cl == 2 || cl == 4 || cl == CLUSTER_MAX);
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool, const void* block_table,
                                    const void* seq_lens, void* out, int B, int H, int KV, int d, int num_pages,
                                    int ps, int maxP, int cluster, float scale, int window, void* stream) {
  if (!shapes_ok(B, H, KV, num_pages, ps, maxP, cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<bf16, 128>(q, k_pool, v_pool, nullptr, nullptr, block_table, seq_lens, out, B, H, KV, num_pages,
                             ps, maxP, cluster, scale, window, s);
  if (d == 64)
    return launch<bf16, 64>(q, k_pool, v_pool, nullptr, nullptr, block_table, seq_lens, out, B, H, KV, num_pages,
                            ps, maxP, cluster, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_q8(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* block_table, const void* seq_lens, void* out,
                                  int B, int H, int KV, int d, int num_pages, int ps, int maxP, int cluster,
                                  float scale, int window, void* stream) {
  if (!shapes_ok(B, H, KV, num_pages, ps, maxP, cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<int8_t, 128>(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens, out, B, H, KV,
                               num_pages, ps, maxP, cluster, scale, window, s);
  if (d == 64)
    return launch<int8_t, 64>(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens, out, B, H, KV,
                              num_pages, ps, maxP, cluster, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
