// Expert FFN GEMMs with fused SwiGLU for Hopper (sm_90a): twelve entry
// points, all on the warp-specialised wgmma/TMA mainloop of sm90_gemm.cuh:
// expert_gate_up (#1), expert_down (#2), grouped_gate_up (#3), grouped_down
// (#4), grouped_gate_up_fused (#12), grouped_down_fused (#13) and, with
// int8 weights widened by the header's widening stage, expert_gate_up_q8
// (#8), expert_down_q8 (#9), grouped_gate_up_q8 (#10), grouped_down_q8
// (#11), grouped_gate_up_fused_q8 (#14) and grouped_down_fused_q8 (#15),
// each with its note below. Each entry point has its own launch counter in
// kernels/expert_gemm.py.
//
// Replaces the TPU kernels of src/repro/kernels/expert_gemm.py:
//   grouped_gate_up           _grouped_gate_up_kernel     (#3)  sorted, bf16          :335
//   grouped_down              _grouped_down_kernel        (#4)  sorted, bf16          :355
//   expert_gate_up            _gate_up_kernel             (#1)  padded, bf16          :177
//   expert_down               _down_kernel                (#2)  padded, bf16          :194
//   expert_gate_up_q8         _gate_up_kernel_q8          (#8)  padded, int8 weights  :701
//   expert_down_q8            _down_kernel_q8             (#9)  padded, int8 weights  :720
//   grouped_gate_up_q8        _grouped_gate_up_kernel_q8  (#10) sorted, int8 weights  :827
//   grouped_down_q8           _grouped_down_kernel_q8     (#11) sorted, int8 weights  :851
//   grouped_gate_up_fused     _fused_gate_up_kernel       (#12) fused gather, bf16    :1088
//   grouped_down_fused        _fused_down_kernel          (#13) fused combine, bf16   :1112
//   grouped_gate_up_fused_q8  _fused_gate_up_kernel_q8    (#14) fused gather, int8    :1251
//   grouped_down_fused_q8     _fused_down_kernel_q8       (#15) fused combine, int8   :1280
// gate/up: h = silu(x@Wg[e]) * (x@Wu[e]); down: y = h@Wd[e]; fp32 sums,
// rounded to bf16 once.
//
// Row mapping. Sorted: an expert-sorted (N_pad, D) buffer whose expert
// regions are aligned to 128 rows; per 128-row tile, tile_group[t] is its
// expert and tile_rows[t] its valid rows (computed on the device by the
// wrapper, as group_tiling does). Rows past the valid count come out zero;
// a tile with no valid row writes zeros and does no product. Padded: the
// dense (E, C, D) buffer read in place; every slot r < C is computed
// (empty slots hold token 0's row and are zeroed by the combine's gate),
// and no row at or past C is written, so a launch never touches the next
// expert's rows (#1, #2, #8, #9; the int8 #8/#9 read the scale row of that
// same padded expert e). Fused (the sorted dispatcher's dispatch-in-kernel
// path): the sorted mapping's tiles, but the (N_pad, D) buffer never
// exists. The gate/up kernel gathers row r of its tile from the
// token-major x (T, D) at tok_pad[row0 + r] (padding rows hold token 0;
// nothing is copied into them and they store zeros), and writes h (N_pad,
// F) as the sorted kernel does. The down kernel reads h in the sorted
// mapping and stores valid row r, times its fp32 gate gate_pad[row0 + r],
// rounded to bf16 once, at row row_out[row0 + r] = slot*T + token of a
// (k*T, D) slot-partials buffer; padding rows and empty tiles store
// nothing. Each (slot, token) pair is one row of the buffer, so every row
// is written exactly once, with no atomics; the wrapper sums the k planes
// in fp32.
//
// What bounds them on an H100: at decode (a few rows per expert) a kernel
// must stream each computed expert's weights once: 3*D*F*2 bytes (352 MB
// at llama3-e8t2 widths) per expert in bf16, half that in int8: bound by
// bytes, ~105 us (bf16) or ~53 us (int8) per expert at 3.35 TB/s. The
// padded layout computes every expert whatever its load; the sorted one
// skips empty experts. At prefill and in training (hundreds of rows per
// expert) the products reach the tensor-core side of the ridge. The fused
// kernels move the same weight bytes; the gather reads T*D*2 bytes of x
// (each row once per output column block, from L2 after the first) and
// the combine writes k*T*D*2 bytes of partials in place of the sorted
// buffer's N_pad rows.
//
// expert_down (#2): y[e] = h[e] @ Wd[e]. Bound at decode (C 4) by the
// weight bytes (940 MB at llama3-e8t2 widths, 0.281 ms at 3.35 TB/s), at
// C 300 by bytes (0.307 ms) with the operations close behind, at C 512
// (training at CF 1) by operations (481 GFLOP, 0.486 ms at 989 TFLOP/s).
// The design: sm90_gemm.cuh's mainloop with h as the K-major A (a 3D
// tensor map over (E, C, F), so a box past C arrives as zeros and never
// reads the next expert) and Wd[e] as an N-major B read through the
// descriptor's transpose bit (four 64-column boxes a slab). C <= 64 runs
// one consumer warpgroup per block (64 rows x 256 columns, 160 threads, 5
// slots: up to 160 KB of weights in flight per SM; 8 experts x 16 column
// blocks = 128 blocks, one wave on 132 SMs) and streams Wd at the byte
// bound; larger C runs two (128 rows, 288 threads, 4 slots of 48 KB). An
// expert's C rows split evenly over its ceil(C / 128) blocks (down_rows),
// and those blocks launch as a thread-block cluster of up to 4
// (down_cluster), so they run at once on one GPC and share each weight
// slab through L2. Per block (ptxas -v, build/kernels/grouped_gemm-*.log):
// 154 registers at BN 256, 90 at BN 128, no spills; shared memory 197,696
// B (two warpgroups) or 205,904 B (one). Tried and dropped: TMA multicast
// of the weight boxes across the cluster (as fast, not faster: the L2 is
// not what bounds it), a 192-row tile (three consumer warpgroups need ~154
// registers each; a 13-warp block is held to 128), BN 128 (slower at every
// C).
//
// expert_gate_up (#1): h[e] = silu(x[e] Wg[e]) * (x[e] Wu[e]). Bound at C
// 4 by the weight bytes (1.88 GB, 0.561 ms), at C 300 by bytes (0.587 ms)
// with the operations close behind (564 GFLOP, 0.570 ms), at C 512 by
// operations (962 GFLOP, 0.973 ms). The design is #2's grid, row split,
// clusters and one-warpgroup C <= 64 path, with #5's g | u product (the
// second launch of grouped_bwd_dh): x[e] is the K-major A through a 3D map
// over (E, C, D), and B is four N-major boxes a slab, Wg[e][k, n0:n0+128]
// then Wu[e][k, n0:n0+128], so one m64n256 accumulator holds g in columns
// 0-127 and u in 128-255 of a block's 128 h columns. The SwiGLU runs pair
// by pair in registers (element 4j + e of g and 4(j + 16) + e of u sit at
// the same row and column) and each pair is stored as bf16 straight from
// them: no fp32 staging pass and no block barrier after the K loop. At C
// 4 that is 8 x F / 128 = 896 blocks of 64 rows, each streaming 2 MB of
// weights, in ~7 waves of plain (not persistent) blocks: 92-94% of the
// byte bound (PERF.md), so a persistent walk was not tried. Per block:
// 168 registers with two consumer warpgroups (ptxas's ceiling for 288
// threads) and 204 with one (160 threads), no spills; shared memory
// 197,696 B and 205,904 B. At C 300 a block computes 128 rows for 100
// valid ones (78%), which is what holds it to ~55% of its bound.
//
// grouped_down (#4): y = h @ Wd[e] over the sorted row tiles. Bound by
// bytes at decode (5 experts with rows stream 587 MB, 0.178 ms) and
// prefill (7, 0.255 ms), by operations in training (4096 rows in N_pad
// 5120: 481 GFLOP, 0.486 ms). The design is #2's product on #5's and #6's
// sorted layout: one block per (128-row tile, 256 D columns; 128 where D
// is not a multiple of 256), h the K-major A through a map over (N_pad,
// F), Wd[e] the N-major B (four 64-column boxes a slab, through a map
// over (E, F, D)), the blocks in grouped_tile order (8 row tiles at a
// time, column block by column block) launched as clusters of 2. A tile
// with no valid row stores zeros and loads nothing; a warpgroup with no
// valid row runs no product and stores zeros; a tile whose valid rows fit
// its first warpgroup loads only those 64 rows of h (a second map with
// 64-row boxes), which is every tile at decode, where N <= N_pad - E*127.
// At decode that is 5 x 16 = 80 busy blocks on 132 SMs, each with 128 KB
// of weights in flight: 86-89% of the byte bound, faster than
// torch._grouped_mm, so neither BN 128 at decode (160 blocks, a second
// wave) nor a split of F over a cluster was needed. Per block: 154
// registers at BN 256, 90 at BN 128, no spills; 197,696 B of shared
// memory at BN 256, 230,512 B at BN 128. Tried and dropped for #1 and
// #4: nothing; each kept its first design. One kernel template,
// grouped_down_kernel<T, Q8, COMBINE>, serves #4 (<Tile<2, BN, true>,
// false, false>), #13, #11 and #15; merging #4's kernel into #11's and
// #15's left all three bit-equal (--digest, PERF.md).
//
// grouped_down_fused (#13): partials[row_out[r]] = (h[r] @ Wd[e]) *
// gate_pad[r] over the sorted row tiles, bf16 weights. Bound by bytes at
// decode (0.1754 ms) and prefill (0.2520), by operations in training
// (0.4864). #4's kernel (<Tile<2, 256, true>, false, true>; BN 128 where
// D is not a multiple of 256) with #15's combine epilogue, without the
// scale: each valid row's fp32 sums times its fp32 gate, rounded once,
// stored as bf16 pairs from registers at its row_out row (4-byte stores
// into scattered rows, as #15's). Padding rows (row_out -1) and empty
// tiles store nothing; a warpgroup without rows runs nothing. At decode,
// prefill and in training it runs 0.90-0.98x #4 on the same routing
// (PERF.md). Per block: 154 registers at BN 256, 90 at BN 128, no spill
// (as #4); 197,696 B of shared memory at BN 256.
//
// grouped_down_fused_q8 (#15): partials[row_out[r]] = (h[r] @ Wd[e] *
// s_down[e]) * gate_pad[r] over the sorted row tiles, Wd int8. Bound by
// bytes at decode (5 experts' int8 weights, 294 MB, 0.0877 ms) and at
// prefill (0.1293 ms). The design (grouped_down_kernel<Q8Tile<256>,
// true, true>) is #4's kernel (grid, grouped_tile order,
// clusters of 2, the 64-row h box for tiles whose rows fit one
// warpgroup) with an int8 B: Wd[e] comes as N-major boxes of 128 columns x
// 64 F rows through a UINT8 tensor map (8 KB a box, two a slab at BN 256,
// half #4's bytes), and every slab is widened to the two bf16 boxes a
// 128-column box makes before the slab's wgmma (sm90::widen_s8 into one
// of three bf16 buffers; a fence, one named barrier a slab;
// sm90::consume_s8). All 256 consumer threads widen, so at decode the
// warpgroup with no rows widens half of every slab (sm90::widen_slabs: a
// loop with no accumulator) while the other widens the other half and
// runs the products. The epilogue scales, gates and rounds once in
// registers and stores each valid row at its row_out row; padding rows and
// empty tiles store nothing. Per block: 168 registers (a few bytes spilled
// at BN 256), 230,464 B of shared memory (4 slots of 16 KB h + 16 KB int8
// and three 32 KB bf16 buffers); BN 128: 7 slots, 222,320 B. Tried and
// dropped (variant builds on the card; PERF.md): widening through fp32
// (prmt, fadd per value: slower than the bf16x2 subtraction), a loop that
// both roles share (the idle warpgroup's widening then ran with the
// accumulator's registers live: slower), BN 128 (more blocks than SMs at
// decode), separate rings for h and the int8 boxes so that an int8 slot
// is refilled as soon as it is widened (slower), one warpgroup widening a
// whole slab while the other runs the products, and 16-row h boxes for
// tiles of up to 16 rows (neither faster).
//
// grouped_down_q8 (#11): y = (h @ Wd[e]) * s_down[e] over the sorted row
// tiles, Wd int8, rounded to bf16 once. Bound by bytes: 0.0902 ms at
// decode, 0.1319 at prefill (#15's weights; h read and y written in full).
// #15's kernel with #4's store: the same grid, ring, widening and
// products; the epilogue scales the fp32 accumulator in registers (bf16x2
// scale loads) and stores every row of the tile through store_rows, zeros
// past the valid count; the warpgroup without rows widens its share of
// each slab, then stores its 64 rows of zeros; an empty tile stores zeros
// and loads nothing. Per block: 168 registers with 36 B spilled at BN 256
// (110 and none at BN 128), 230,464 B of shared memory. At decode it runs
// within ~8% of #15 in the same call (PERF.md). BN 128 at decode (160
// blocks on 132 SMs, a second wave) was slower at decode and prefill in a
// variant build on the card, as it was for #15.
//
// grouped_gate_up_q8 (#10): h = silu((x Wg[e]) * s_gate[e]) * ((x Wu[e]) *
// s_up[e]) over the sorted row tiles, Wg and Wu int8, the scales on the
// fp32 sums before silu, rounded to bf16 once. Bound by bytes: 5 experts'
// int8 Wg and Wu (587 MB) at decode, 0.1842 ms; 0.2612 at prefill (141
// GFLOP, 0.142 ms of operations). #1's g | u product on #4's sorted tiles:
// one block per (128-row tile, 128 h columns) in grouped_tile order, as
// clusters of 2, xs the K-major A through 128- and 64-row boxes; a slab's
// B is one 128-column int8 box of Wg[e] and one of Wu[e] (UINT8 maps over
// (E, D, F)), which widen_s8 turns into #1's four 64-column bf16 boxes, so
// the m64n256 accumulator holds g in columns 0-127 and u in 128-255 (#15's
// slab at BN 256: its Q8Tile<256> layout as it is). The epilogue loads the
// scales a column pair at a time after the K loop, applies silu(g) * u in
// fp32 (swiglu, shared with #1) and stores bf16 pairs from registers,
// zeros past the valid count; the warpgroup without rows widens, then
// stores zeros; an empty tile stores zeros. At decode: 5 busy row tiles x
// 112 column blocks = 560 blocks of 64 slabs (~4.2 waves), ~60% of the
// byte bound. Per block: 168 registers, 20 B spilled; 230,464 B of shared
// memory. One kernel template, grouped_gate_up_kernel<T, Q8, GATHER>,
// serves #10 (<Q8Tile<256>, true, false>), #3, #14 and #12.
//
// grouped_gate_up (#3): #10's kernel with bf16 weights (<Tile<2, 256,
// true>, false, false>): a slab's B is #1's four N-major 64-column boxes,
// Wg[e][k, n0:n0+64], Wg[e][k, n0+64:n0+128], then Wu[e]'s two, through
// bf16 maps over (E, D, F); no widening, no scales; the warpgroup without
// rows runs nothing and stores zeros. Bound by bytes at decode (5 experts'
// bf16 Wg and Wu, 1.17 GB, 0.3594 ms) and prefill (0.5065), by operations
// in training (4096 rows, 962 GFLOP, 0.9728 ms). At decode 560 busy blocks
// stream 2 MB each, ~87% of the byte bound; in training ~57% of the
// tensor-core peak, as #1 at C 512. Per block: 154 registers, no spill;
// 197,696 B of shared memory (4 slots of 48 KB, as #4).
//
// grouped_gate_up_fused_q8 (#14): #10's kernel (<Q8Tile<256,
// GATHER_WARPS>, true, true>) with row r of a tile read from the
// token-major x (T, D) at tok_pad[row0 + r] in place of the scattered
// (N_pad, D) buffer. TMA cannot gather rows on sm_90, so two producer
// warps copy the valid rows of each slab's A half by cp.async, 8 lanes a
// row, into the slot's 128B swizzle and arrive on its full barrier,
// beside one thread's TMA of the int8 weight boxes (produce_gathered; the
// slot fills on 1 + 64 arrivals). Rows of the slot past the valid count
// are not copied and are left as they are. The slabs, their order and the
// epilogue are #10's, so h is bit-equal to #10's on the scattered buffer.
// Bound by bytes: 0.1841 ms at decode, 0.2605 at prefill (x read once,
// not the N_pad rows). At decode (up to 3 rows a tile) and at prefill (up
// to 128 rows) it runs ~1.04x #10 (PERF.md). One TMA box of one row a row
// (a 64 x 1 box at a + 128 r, the 128B swizzle taken from the 1024-aligned
// slot address) lands right too, bit-equal, but ran 2.1x slower at
// prefill. Per block (320 threads): 168 registers, 20 B spilled (as #10);
// 230,464 B of shared memory.
//
// grouped_gate_up_fused (#12): #3's kernel (<Tile<2, 256, true, 0, 2,
// GATHER_WARPS>, false, true>) with #14's gather: row r of a tile is
// copied from x[tok_pad[row0 + r]] into the slot by the two producer
// warps, 8 lanes a row (produce_gathered; a slot fills on 1 + 64 arrivals
// and takes no more bytes), beside one thread's TMA of #3's four bf16
// weight boxes. consume has no proxy fence, so the consumers run
// consume_at with a hook that fences the slot (fence_async_smem) after
// its full barrier and before its first wgmma. Rows of the slot past the
// valid count are left as they are and stored as zeros. The slabs, their
// order and the epilogue are #3's, so h is bit-equal to #3's on the
// scattered buffer. Bound by bytes at decode (0.3593 ms) and prefill
// (0.5058), by operations in training (0.9728). It runs 0.98x #3 on the
// same routing at decode and prefill and 1.02-1.06x in training (PERF.md):
// the two warps' copies hide behind the products. Per block (320
// threads): 154 registers, no spill (as #3); 197,696 B of shared memory.
//
// expert_down_q8 (#9): y[e] = (h[e] @ Wd[e]) * s_down[e], Wd int8, the
// scale on the fp32 sums, rounded to bf16 once. Bound by bytes at C 4
// (int8 Wd, 470 MB, 0.1406 ms) and C 100, by operations at C 300 and 512
// (0.2850, 0.4864 ms). The design is #2's padded grid, even row split and
// row-block clusters (h through the 3D map over (E, C, F), so a box past
// C arrives as zeros) with #11's slab: two 128-column int8 boxes of Wd[e]
// a slab at BN 256 (UINT8 map over the real (E, F, D), the expert from the
// grid), widened by consume_s8 into three bf16 buffers. The epilogue
// scales the fp32 sums in registers (bf16x2 scale loads) and stores only
// rows below C (store_rows); a warpgroup with no row below C (at C <= 64
// the second one) widens its share of each slab (widen_slabs) and stores
// nothing. At C 4: 8 experts x 16 column blocks = 128 blocks, one wave.
// Per block: 168 registers, 16 B spilled at BN 256 (108, none at BN 128);
// 230,464 B of shared memory (Q8Tile<256>; 7 slots at BN 128).
//
// expert_gate_up_q8 (#8): h[e] = silu((x[e] Wg[e]) * s_gate[e]) * ((x[e]
// Wu[e]) * s_up[e]), Wg and Wu int8, the scales on the fp32 sums before
// silu, rounded to bf16 once. Bound by bytes at C 4 (939 MB, 0.2809 ms)
// and C 100, by operations at C 300 and 512 (0.5700, 0.9728 ms). #1's
// padded grid, row split and clusters with #10's slab: x[e] through the 3D
// map over (E, C, D), one 128-column int8 box of Wg[e] and one of Wu[e] (UINT8
// maps over the real (E, D, F)) that widen_s8 turns into #1's four bf16
// boxes, g in accumulator columns 0-127 and u in 128-255; #10's epilogue
// (scales a column pair at a time after the K loop, swiglu, bf16 pairs
// from registers), storing only rows below C; a warpgroup with no row
// below C widens and stores nothing. At C 4: 8 x 112 = 896 blocks of 64
// slabs (~6.8 waves). Per block: 168 registers, 20 B spilled; 230,464 B.
//
// #8 and #9 run two consumer warpgroups at every C (Q8Tile), where #1 and
// #2 run one at C <= 64: the warpgroup without rows widens half of every
// slab. A one-warpgroup variant for C <= 64 (Tile<1, 256> with the three
// bf16 buffers: 5 slots, 222,288 B, 243-244 registers, no spill) measured
// 2-4% slower for #8 and 8% slower for #9 at C 4 in a variant build on the
// card (PERF.md), so it was dropped. At C 4 both beat their library
// calls and bf16 twins. At C 300 and 512 both stay 1.33-1.57x their bf16
// twins: in variant builds without the widening the products alone ran
// level with the twins, and the widening alone took ~0.9x the products'
// time, so the widening, which each block of a cluster repeats for the
// same weight slab (3 blocks at C 300, 4 at 512), is what holds them back.
// Sharing one widening across the cluster (distributed shared memory) or
// weights as the register A of a transposed product would remove it; not
// tried.
//
// Left for later: #1 at C 300 (a block of 100 rows on a 128-row tile) and
// the mainloop's ~60-67% of the tensor-core peak at C 512 and in training
// (sm90_gemm.cuh); the padded decode computes all 8 experts at C 4 (#1,
// #2, #8, #9: skipping empty ones changes the function, so it needs a
// per-expert count and a rule for what empty slots hold); a fixed-order
// split over F for #2 at C 300; what is left of the gather's cost (#14
// ~1.04x #10, #12 1.02-1.06x #3 in training); the widening costs
// shared-memory traffic (16 KB read and 32 KB written a slab at BN 256,
// beside the products' reads) that the products do not fully hide, which
// holds the int8 kernels above their bf16 twins at prefill and under
// ~60% of their byte bounds at decode.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "sm90_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_TILE = 128;  // metadata granularity (sorted-buffer alignment)

// ---------------------------------------------------------------------------
// #2 expert_down: y[e] = h[e] @ Wd[e] on the shared wgmma/TMA mainloop
// ---------------------------------------------------------------------------

// rows of an expert per block: its C rows split evenly over ceil(C / BM)
// blocks (C 300: 100, 100, 100 rather than 128, 128, 44), so that no block
// of a cluster streams the weights for a sliver of rows
__host__ __device__ inline int down_rows(int c, int bm) {
  const int nsub = (c + bm - 1) / bm;
  return (c + nsub - 1) / nsub;
}

// h (E, C, F) read in boxes of 64 columns x down_rows rows of one expert;
// Wd (E, F, D) in boxes of 64 output columns x 64 rows of F (N-major B),
// or, int8 (#9), of 128 output columns (widened by consume_s8)
struct DownMaps {
  CUtensorMap h, wd;
};

// blockIdx.x = e * ceil(C / BM) + row block (the fastest grid dimension),
// blockIdx.y = output column block. The row blocks of one expert's weight
// columns launch as thread-block clusters of up to 4 (launch_down), so
// they run at once on SMs of one GPC and share the weights through L2.
// Rows of the box past C arrive as zeros and are not stored; rows of the
// slot past the box are never stored either; a warpgroup with no row of
// its block neither computes nor stores.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
expert_down_kernel(const __grid_constant__ DownMaps maps, bf16* __restrict__ Y, int C, int F, int D) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int nsub = (C + T::BM - 1) / T::BM, R = down_rows(C, T::BM);
  const int e = blockIdx.x / nsub, r0 = (blockIdx.x % nsub) * R;
  const int n0 = blockIdx.y * T::BN;
  const int valid = min(R, C - r0);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a row below C
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n_slabs = F / T::BK;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS)
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, &maps.h, k0, r0, e, bar);
#pragma unroll
        for (int c = 0; c < T::BN / 64; ++c)
          sm90::tma_load_3d(b + c * (T::BK * 128), &maps.wd, n0 + 64 * c, k0, e, bar);
      }, R * 128 + T::B_BYTES);
    return;
  }
  if (wg >= active) return;
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  sm90::consume(ring, n_slabs, wg, acc);
  sm90::store_rows<T, false>(acc, Y + ((size_t)e * C + r0 + wg * 64) * D + n0, D, valid - wg * 64);
}

// blocks of a cluster: the largest divisor of the row blocks per expert up
// to 4 (a cluster's blocks must fit one GPC at once)
int down_cluster(int nsub) {
  for (int c = 4; c > 1; --c)
    if (nsub % c == 0) return c;
  return 1;
}

// the padded grid of #1, #2, #8 and #9: (e * ceil(c / BM) row blocks,
// `cols` column blocks), an expert's row blocks as one cluster; the int8
// kernels' scale pointers (`scales`) go between the maps and the output
template <class T, class K, class Maps, class... Scales>
int launch_padded(K kernel, const Maps& maps, void* out, int e, int c, int cols, int k, int n, cudaStream_t s,
                  Scales... scales) {
  const int nsub = (c + T::BM - 1) / T::BM;
  return sm90::launch_cluster(kernel, dim3(e * nsub, cols), down_cluster(nsub), T::THREADS, T::SMEM, s, maps,
                              scales..., (bf16*)out, c, k, n);
}

template <class T>
int launch_down(const void* h, const void* w_down, void* y, int e, int c, int f, int d, cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(expert_down_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DownMaps maps;
  if (reinterpret_cast<uintptr_t>(y) % 16 || !sm90::map_3d(&maps.h, h, f, c, e, down_rows(c, T::BM)) ||
      !sm90::map_3d(&maps.wd, w_down, d, f, e, 64))
    return (int)cudaErrorInvalidValue;
  return launch_padded<T>(expert_down_kernel<T>, maps, y, e, c, d / T::BN, f, d, s);
}

// ---------------------------------------------------------------------------
// #1 expert_gate_up: h[e] = silu(x[e] Wg[e]) * (x[e] Wu[e]) on the shared
// mainloop, g | u in one m64n256 accumulator
// ---------------------------------------------------------------------------

constexpr int GU_BN = 128;  // h columns per block: g and u, 128 each, side by side

// silu(g) * u in fp32 (#1, #10)
__device__ __forceinline__ float swiglu(float g, float u) { return g * __fdividef(1.0f, 1.0f + expf(-g)) * u; }

// x (E, C, D) in boxes of 64 columns x down_rows rows of one expert; Wg,
// Wu (E, D, F) in boxes of 64 F columns x 64 D rows (N-major B), or, int8
// (#8), of 128 F columns (widened by consume_s8)
struct GateUpMaps {
  CUtensorMap x, wg, wu;
};

// expert_down's grid and row split, h's 128 columns per block: D / 64
// slabs of (x[e]; Wg[e] | Wu[e]) into one accumulator whose columns 0-127
// are g and 128-255 u, then h = silu(g) * u pair by pair from registers
// (element 4j + e of g and 4(j + 16) + e sit at the same row and column).
// Rows past C arrive as zeros and are not stored.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
expert_gate_up_kernel(const __grid_constant__ GateUpMaps maps, bf16* __restrict__ H, int C, int D, int F) {
  static_assert(T::BN == 2 * GU_BN && T::B_MN, "g | u side by side, an N-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int nsub = (C + T::BM - 1) / T::BM, R = down_rows(C, T::BM);
  const int e = blockIdx.x / nsub, r0 = (blockIdx.x % nsub) * R;
  const int n0 = blockIdx.y * GU_BN;
  const int valid = min(R, C - r0);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a row below C
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n_slabs = D / T::BK;
  constexpr int BOX = T::BK * 128;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS)
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, &maps.x, k0, r0, e, bar);
        sm90::tma_load_3d(b, &maps.wg, n0, k0, e, bar);
        sm90::tma_load_3d(b + BOX, &maps.wg, n0 + 64, k0, e, bar);
        sm90::tma_load_3d(b + 2 * BOX, &maps.wu, n0, k0, e, bar);
        sm90::tma_load_3d(b + 3 * BOX, &maps.wu, n0 + 64, k0, e, bar);
      }, R * 128 + T::B_BYTES);
    return;
  }
  if (wg >= active) return;
  float gu[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) gu[i] = 0.f;
  sm90::consume(ring, n_slabs, wg, gu);
  const int rows = valid - wg * 64;  // this warpgroup's rows below C
  const int warp = (tid % 128) / 32, g8 = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g8 + 8 * hh;
    if (r >= rows) continue;
    uint32_t* h = reinterpret_cast<uint32_t*>(H + ((size_t)e * C + r0 + wg * 64 + r) * F + n0 + 2 * t);
#pragma unroll
    for (int j = 0; j < GU_BN / 8; ++j) {
      float o[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) o[q] = swiglu(gu[4 * j + 2 * hh + q], gu[GU_BN / 2 + 4 * j + 2 * hh + q]);
      h[4 * j] = sm90::pack_bf16(o[0], o[1]);
    }
  }
}

template <class T>
int launch_gate_up(const void* xe, const void* w_gate, const void* w_up, void* h, int e, int c, int d, int f,
                   cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(expert_gate_up_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  GateUpMaps maps;
  if (reinterpret_cast<uintptr_t>(h) % 16 || !sm90::map_3d(&maps.x, xe, d, c, e, down_rows(c, T::BM)) ||
      !sm90::map_3d(&maps.wg, w_gate, f, d, e, 64) || !sm90::map_3d(&maps.wu, w_up, f, d, e, 64))
    return (int)cudaErrorInvalidValue;
  return launch_padded<T>(expert_gate_up_kernel<T>, maps, h, e, c, f / GU_BN, d, f, s);
}

// ---------------------------------------------------------------------------
// #4 grouped_down, #11 grouped_down_q8, #13 grouped_down_fused and #15
// grouped_down_fused_q8: y = h @ Wd[e] over the sorted row tiles on the
// shared mainloop, one kernel template; int8 Wd widened in shared memory
// (#11, #15); #13 and #15 end in the gate-weighted combine into the slot
// partials
// ---------------------------------------------------------------------------

// h (N_pad, F) in boxes of 64 columns x 128 rows, or x 64 rows for a tile
// whose valid rows fit the first warpgroup (the idle one's rows are not
// loaded); Wd (E, F, D) in boxes of 64 F rows (N-major B) of 64 bf16 D
// columns (#4, #13) or of 128 int8 ones (#11, #15: widened by consume_s8)
struct GroupedDownMaps {
  CUtensorMap h, h64, wd;
};

// One block per (128-row tile, BN D columns) in grouped_tile order. Q8:
// each slab's int8 boxes are widened to bf16 by all consumer threads (an
// idle warpgroup's among them) before the active warpgroups' wgmma
// (sm90::consume_s8), and the fp32 sums are scaled by s_down[e, col] in
// registers. COMBINE (#13, #15): the epilogue stores only valid rows: row
// r of the tile, (its sum, scaled where Q8) * gate_pad[row0 + r] in fp32,
// rounded to bf16 once, at row row_out[row0 + r] of the (k*T, D) partials;
// an empty tile loads and stores nothing. Otherwise (#4, #11): y at the
// tile's own rows of (N_pad, D): rows past the valid count, all of an idle
// warpgroup's among them, store zeros, and an empty tile stores zeros and
// loads nothing.
template <class T, bool Q8, bool COMBINE>
__global__ void __launch_bounds__(T::THREADS, 1)
grouped_down_kernel(const __grid_constant__ GroupedDownMaps maps, const bf16* __restrict__ S,
                    const int* __restrict__ row_out, const float* __restrict__ gate_pad,
                    const int* __restrict__ tile_group, const int* __restrict__ tile_rows,
                    bf16* __restrict__ out, int F, int D) {
  static_assert(T::BM == ROW_TILE && T::B_MN, "one block per row tile, an N-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  int tile, cb;
  sm90::grouped_tile(D / T::BN, tile, cb);
  const int row0 = tile * T::BM, n0 = cb * T::BN;
  const int valid = min(max(tile_rows[tile], 0), T::BM);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a valid row
  if (active == 0) {  // empty tile: no product; for the combine no row of the partials is its
    if constexpr (!COMBINE) sm90::store_zeros<T::BM, T::BN>(out + (size_t)row0 * D + n0, D, T::THREADS);
    return;
  }
  const int e = tile_group[tile];
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n_slabs = F / T::BK;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS) {
      const CUtensorMap* a_map = active == 1 ? &maps.h64 : &maps.h;
      constexpr int BOX_COLS = Q8 ? 128 : 64;  // a weight box: 64 rows of 128 bytes either way
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, a_map, k0, row0, 0, bar);
#pragma unroll
        for (int c = 0; c < T::BN / BOX_COLS; ++c)
          sm90::tma_load_3d(b + c * (T::BK * 128), &maps.wd, n0 + BOX_COLS * c, k0, e, bar);
      }, active * 64 * 128 + T::B_BYTES);
    }
    return;
  }
  if (wg >= active) {  // no row of this warpgroup's: it widens its share of each slab (int8); zeros, or no store
    if constexpr (Q8) sm90::widen_slabs(ring, n_slabs);
    if constexpr (!COMBINE)
      sm90::store_zeros<64, T::BN>(out + (size_t)(row0 + wg * 64) * D + n0, D, 128, tid % 128);
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  if constexpr (Q8)
    sm90::consume_s8(ring, n_slabs, wg, acc);
  else
    sm90::consume(ring, n_slabs, wg, acc);
  const int warp = (tid % 128) / 32, g = (tid % 32) / 4, t = tid % 4;
  // scales of columns n0 + 8j + 2t, +1 at pair 4j (Q8)
  const __nv_bfloat162* scale =
      Q8 ? reinterpret_cast<const __nv_bfloat162*>(S + (size_t)e * D + n0 + 2 * t) : nullptr;
  if constexpr (!COMBINE) {
    if constexpr (Q8) {
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        const float2 sc = __bfloat1622float2(scale[4 * j]);
        acc[4 * j] *= sc.x;  // rows g and g + 8 of columns 8j + 2t, + 1
        acc[4 * j + 1] *= sc.y;
        acc[4 * j + 2] *= sc.x;
        acc[4 * j + 3] *= sc.y;
      }
    }
    sm90::store_rows<T, true>(acc, out + (size_t)(row0 + wg * 64) * D + n0, D, valid - wg * 64);
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * 64 + warp * 16 + g + 8 * hh;
    if (r >= valid) continue;
    const float gate = gate_pad[row0 + r];
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)row_out[row0 + r] * D + n0 + 2 * t);
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      float lo = acc[4 * j + 2 * hh], hi = acc[4 * j + 2 * hh + 1];
      if constexpr (Q8) {
        const float2 sc = __bfloat1622float2(scale[4 * j]);
        lo *= sc.x;
        hi *= sc.y;
      }
      dst[4 * j] = sm90::pack_bf16(lo * gate, hi * gate);
    }
  }
}

// Tiles with int8 B slots and three bf16 buffers of a widened slab after
// the ring (consume_s8): #8-#11, #14, #15
template <int BN_, int PRODUCERS_ = 1>
using Q8Tile = sm90::Tile<2, BN_, true, 3 * BN_ * 64 * 2, 1, PRODUCERS_>;

// producer warps of the gathering kernels #12 and #14 (produce_gathered)
constexpr int GATHER_WARPS = 2;

// #4 (bf16), #11 (Q8: s_down) -> y (N_pad, D); #13 (COMBINE: row_out,
// gate_pad), #15 (Q8, COMBINE) -> the (k*T, D) partials. The arguments a
// kernel does not read are unused.
template <class T, bool Q8, bool COMBINE>
int launch_grouped_down(const void* h, const void* w_down, const void* s_down, const int* row_out,
                        const float* gate_pad, const int* tile_group, const int* tile_rows, void* out, int n_pad,
                        int f, int d, cudaStream_t s) {
  const auto kernel = grouped_down_kernel<T, Q8, COMBINE>;
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  GroupedDownMaps maps;
  if ((!COMBINE && reinterpret_cast<uintptr_t>(out) % 16) || !sm90::map_3d(&maps.h, h, f, n_pad, 1, T::BM) ||
      !sm90::map_3d(&maps.h64, h, f, n_pad, 1, 64) ||
      !sm90::map_3d(&maps.wd, w_down, d, f, sm90::MAX_EXPERTS, 64, Q8 ? 1 : 2))
    return (int)cudaErrorInvalidValue;
  return sm90::launch_grouped(kernel, (n_pad / T::BM) * (d / T::BN), T::THREADS, T::SMEM, s, maps,
                              (const bf16*)s_down, row_out, gate_pad, tile_group, tile_rows, (bf16*)out, f, d);
}

// ---------------------------------------------------------------------------
// #10 grouped_gate_up_q8, #3 grouped_gate_up, #14 grouped_gate_up_fused_q8
// and #12 grouped_gate_up_fused: #1's g | u product on #4's sorted tiles,
// one kernel template; int8 Wg and Wu widened in shared memory as #15
// widens Wd (#10, #14); #14's and #12's A rows gathered from the
// token-major x into the slot
// ---------------------------------------------------------------------------

// xs (N_pad, D) in boxes of 64 columns x 128 rows, or x 64 rows for a tile
// whose valid rows fit the first warpgroup (#3, #10; #12 and #14 gather
// their rows and read no map of x); Wg, Wu (E, D, F) in boxes of 64 D rows
// (N-major B) of 64 bf16 F columns (#3, #12) or of 128 int8 ones (#10,
// #14: widened by consume_s8)
struct GateUpSortedMaps {
  CUtensorMap x, x64, wg, wu;
};

// The producer warps of #14 and #12: slab i's A half is gathered from the
// token-major x (T, D), row r < valid of the tile being x[tok[r]][k0 .. k0
// + 63]. TMA cannot gather rows on sm_90 (tile::gather4 is sm_100's), so
// the GATHER_WARPS warps copy them by cp.async, 8 lanes a row: warp w's
// lane l copies the 16-byte chunk c = l % 8 of rows w * BM / GATHER_WARPS
// + l / 8 + 4m, so each instruction reads 4 whole 128-byte rows, into the
// 128B swizzle the A descriptor reads (chunk c of row r at chunk c ^ (r %
// 8)); each lane then arrives on the slot's full barrier (noinc: 1 + 32 x
// GATHER_WARPS arrivals fill a slot). The first producer thread first
// expects the weight boxes' bytes and issues them by TMA (load_b) against
// the same barrier. Rows of the slot past the valid count are left as
// they are: wgmma rows are independent, and those rows are stored as
// zeros. A fence_async_smem by each consumer thread after the full barrier
// and before the wgmma makes the copies visible to it (consume_s8's after
// the widening, #14; a consume_at hook, #12). The gathered rows come from
// L2 after the first of the 112 column blocks of a tile reads them.
// Device ms of #12 in training, measured on the card (PERF.md): one warp
// copying a row a lane (32 rows of 16 bytes an instruction, the other half
// of each 32-byte sector read by the next) 2.79-2.82 against 2.35 for one
// warp, 8 lanes a row, in one call (#3 1.72-1.85); in a second call one
// warp 2.23-2.25, two 1.70-1.74, four 1.68-1.72 (#3 1.67-1.76). Two warps
// also took #14 at prefill from 0.627 to 0.575-0.583 ms. One TMA box of
// one row a row (#14) ran 2.1x slower at prefill (the TMA unit's rate for
// 128-byte boxes).
template <class T, class LoadB>
__device__ __forceinline__ void produce_gathered(const sm90::Ring<T>& ring, int n_slabs, const bf16* X,
                                                 const int* tok, int valid, int D, LoadB&& load_b) {
  static_assert(T::BM % (8 * T::PRODUCERS) == 0, "whole 8-row swizzle groups a warp");
  const int lane = threadIdx.x % 32, c = lane % 8, w = (threadIdx.x - T::CONSUMERS) / 32;
  const int r0 = w * (T::BM / T::PRODUCERS) + lane / 8;  // r0 % 8 == lane / 8
  constexpr int M = T::BM / 4 / T::PRODUCERS;
  const bf16* src[M];  // chunk c of rows r0 + 4m of x, or nothing past the valid count
#pragma unroll
  for (int m = 0; m < M; ++m) src[m] = r0 + 4 * m < valid ? X + (size_t)tok[r0 + 4 * m] * D + 8 * c : nullptr;
  // chunk c of row r0 + 4m lands at chunk c ^ ((r0 + 4m) % 8) of its 128-byte row
  const uint32_t sw0 = r0 * 128 + ((c ^ (lane / 8)) * 16), sw1 = r0 * 128 + ((c ^ (lane / 8 + 4)) * 16);
  for (int i = 0; i < n_slabs; ++i) {
    const int s = i % T::STAGES;
    if (i >= T::STAGES) sm90::mbar_wait(ring.empty(s), (i / T::STAGES - 1) & 1);
    const uint32_t full = ring.full(s), a = ring.a(s);
    const int k0 = i * T::BK;
    if (threadIdx.x == T::CONSUMERS) {
      sm90::mbar_expect_tx(full, T::B_BYTES);
      load_b(ring.b(s), k0, full);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (!src[m]) continue;
      sm90::cp_async_16(a + (m % 2 ? sw1 : sw0) + 4 * m * 128, src[m] + k0);
    }
    sm90::cp_async_arrive(full);
  }
  sm90::cp_async_wait_all();
}

// One block per (128-row tile, 128 h columns) in grouped_tile order. A
// slab is (xs; Wg[e] | Wu[e]): #1's four 64-column bf16 boxes (#3, #12), or two
// int8 boxes that widen_s8 turns into those four (#10, #14), so one
// m64n256 accumulator holds g in columns 0-127 and u in 128-255 (element
// 4j + e of g and 4(j + 16) + e of u at the same row and column). The
// epilogue scales each by its column's bf16 scale in fp32 (Q8), applies
// silu(g) * u and stores bf16 pairs from registers: rows past the valid
// count, all of an idle warpgroup's among them, store zeros; an empty tile
// stores zeros and loads nothing. GATHER (#14, #12): row r of the tile is
// x[tok_pad[row0 + r]] (produce_gathered), and h is stored as #10 (#3)
// stores it.
template <class T, bool Q8, bool GATHER>
__global__ void __launch_bounds__(T::THREADS, 1)
grouped_gate_up_kernel(const __grid_constant__ GateUpSortedMaps maps, const bf16* __restrict__ s_gate,
                       const bf16* __restrict__ s_up, const bf16* __restrict__ X, const int* __restrict__ tok_pad,
                       const int* __restrict__ tile_group, const int* __restrict__ tile_rows,
                       bf16* __restrict__ H, int D, int F) {
  static_assert(T::BM == ROW_TILE && T::BN == 2 * GU_BN && T::B_MN, "one block per row tile, g | u side by side");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  int tile, cb;
  sm90::grouped_tile(F / GU_BN, tile, cb);
  const int row0 = tile * T::BM, n0 = cb * GU_BN;
  const int valid = min(max(tile_rows[tile], 0), T::BM);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a valid row
  if (active == 0) {  // empty tile: zeros, no product
    sm90::store_zeros<T::BM, GU_BN>(H + (size_t)row0 * F + n0, F, T::THREADS);
    return;
  }
  const int e = tile_group[tile];
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active, GATHER ? 1 + 32 * T::PRODUCERS : 1);
  __syncthreads();
  const int n_slabs = D / T::BK;
  // a slab's weight boxes: int8, one of 128 columns each of Wg and Wu; bf16, two of 64 each
  auto load_b = [&](uint32_t b, int k0, uint32_t bar) {
    if constexpr (Q8) {
      sm90::tma_load_3d(b, &maps.wg, n0, k0, e, bar);
      sm90::tma_load_3d(b + T::BK * 128, &maps.wu, n0, k0, e, bar);
    } else {
      sm90::tma_load_3d(b, &maps.wg, n0, k0, e, bar);
      sm90::tma_load_3d(b + T::BK * 128, &maps.wg, n0 + 64, k0, e, bar);
      sm90::tma_load_3d(b + 2 * T::BK * 128, &maps.wu, n0, k0, e, bar);
      sm90::tma_load_3d(b + 3 * T::BK * 128, &maps.wu, n0 + 64, k0, e, bar);
    }
  };
  if (wg == T::NWG) {  // the producer warps: one thread issues every copy, or all their lanes gather
    if constexpr (GATHER) {
      produce_gathered(ring, n_slabs, X, tok_pad + row0, valid, D, load_b);
    } else if (tid == T::CONSUMERS) {
      const CUtensorMap* a_map = active == 1 ? &maps.x64 : &maps.x;
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, a_map, k0, row0, 0, bar);
        load_b(b, k0, bar);
      }, active * 64 * 128 + T::B_BYTES);
    }
    return;
  }
  if (wg >= active) {  // no row of this warpgroup's: it widens its share of each slab (int8), then stores zeros
    if constexpr (Q8) sm90::widen_slabs(ring, n_slabs);
    sm90::store_zeros<64, GU_BN>(H + (size_t)(row0 + wg * 64) * F + n0, F, 128, tid % 128);
    return;
  }
  float gu[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) gu[i] = 0.f;
  if constexpr (Q8)  // its fence after the widening also covers a gathered A (#14)
    sm90::consume_s8(ring, n_slabs, wg, gu);
  else if constexpr (GATHER)  // #12: the copies wrote the slot through the generic proxy; fence them for wgmma
    sm90::consume_at<T, T::BN, 0, 1>(ring, 0, n_slabs, wg, gu, [](int, int) { sm90::fence_async_smem(); });
  else
    sm90::consume(ring, n_slabs, wg, gu);
  const int rows = valid - wg * 64;  // this warpgroup's valid rows
  const int warp = (tid % 128) / 32, g8 = (tid % 32) / 4, t = tid % 4;
  // scales of columns n0 + 8j + 2t, +1 at pair 4j, loaded a column pair at a time after the K loop
  const __nv_bfloat162* sg = reinterpret_cast<const __nv_bfloat162*>(s_gate + (size_t)e * F + n0 + 2 * t);
  const __nv_bfloat162* su = reinterpret_cast<const __nv_bfloat162*>(s_up + (size_t)e * F + n0 + 2 * t);
  uint32_t* h = reinterpret_cast<uint32_t*>(H + (size_t)(row0 + wg * 64 + warp * 16 + g8) * F + n0 + 2 * t);
#pragma unroll
  for (int j = 0; j < GU_BN / 8; ++j) {
    float2 a = make_float2(1.f, 1.f), b = a;  // bf16 weights: no scale (x * 1 is x)
    if constexpr (Q8) {
      a = __bfloat1622float2(sg[4 * j]);
      b = __bfloat1622float2(su[4 * j]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = 4 * j + 2 * hh;
      const bool ok = warp * 16 + g8 + 8 * hh < rows;
      h[(size_t)4 * hh * F + 4 * j] =
          ok ? sm90::pack_bf16(swiglu(gu[k] * a.x, gu[GU_BN / 2 + k] * b.x),
                               swiglu(gu[k + 1] * a.y, gu[GU_BN / 2 + k + 1] * b.y))
             : 0u;
    }
  }
}

// #10 (Q8: s_gate, s_up), #3 (bf16; the scales unused), #14 (Q8, GATHER:
// x (T, D) and tok_pad (n_pad,) in place of xs (n_pad, D)) or #12 (GATHER,
// bf16); -> h (n_pad, f)
template <class T, bool Q8, bool GATHER>
int launch_gate_up_sorted(const void* x, const void* w_gate, const void* w_up, const void* s_gate, const void* s_up,
                          const int* tok_pad, const int* tile_group, const int* tile_rows, void* h, int n_pad, int d,
                          int f, cudaStream_t s) {
  const auto kernel = grouped_gate_up_kernel<T, Q8, GATHER>;
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  GateUpSortedMaps maps = {};
  const uint32_t w_elem = Q8 ? 1 : 2;
  const bool x_ok = GATHER ? reinterpret_cast<uintptr_t>(x) % 16 == 0
                           : sm90::map_3d(&maps.x, x, d, n_pad, 1, T::BM) &&
                                 sm90::map_3d(&maps.x64, x, d, n_pad, 1, 64);
  if (reinterpret_cast<uintptr_t>(h) % 16 || !x_ok ||
      !sm90::map_3d(&maps.wg, w_gate, f, d, sm90::MAX_EXPERTS, 64, w_elem) ||
      !sm90::map_3d(&maps.wu, w_up, f, d, sm90::MAX_EXPERTS, 64, w_elem))
    return (int)cudaErrorInvalidValue;
  return sm90::launch_grouped(kernel, (n_pad / T::BM) * (f / GU_BN), T::THREADS, T::SMEM, s, maps,
                              (const bf16*)s_gate, (const bf16*)s_up, (const bf16*)x, tok_pad, tile_group, tile_rows,
                              (bf16*)h, d, f);
}

// ---------------------------------------------------------------------------
// #9 expert_down_q8 and #8 expert_gate_up_q8: #2's and #1's padded grid with
// #11's and #10's int8 slabs, widened in shared memory
// ---------------------------------------------------------------------------

// #2's grid, row split and clusters with #11's slab: each slab's int8 boxes
// are widened to bf16 by all consumer threads before the product
// warpgroups' wgmma. The epilogue scales the fp32 sums by s_down[e] in
// registers and stores only rows below C; a warpgroup with no row below C
// widens its share of each slab and stores nothing.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
expert_down_q8_kernel(const __grid_constant__ DownMaps maps, const bf16* __restrict__ S,
                      bf16* __restrict__ Y, int C, int F, int D) {
  static_assert(T::B_MN, "an N-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int nsub = (C + T::BM - 1) / T::BM, R = down_rows(C, T::BM);
  const int e = blockIdx.x / nsub, r0 = (blockIdx.x % nsub) * R;
  const int n0 = blockIdx.y * T::BN;
  const int valid = min(R, C - r0);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a row below C
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n_slabs = F / T::BK;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS)
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, &maps.h, k0, r0, e, bar);
#pragma unroll
        for (int c = 0; c < T::BN / 128; ++c)
          sm90::tma_load_3d(b + c * (T::BK * 128), &maps.wd, n0 + 128 * c, k0, e, bar);
      }, R * 128 + T::B_BYTES);
    return;
  }
  if (wg >= active) {  // no row below C: it only widens its share of each slab
    sm90::widen_slabs(ring, n_slabs);
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  sm90::consume_s8(ring, n_slabs, wg, acc);
  const __nv_bfloat162* scale = reinterpret_cast<const __nv_bfloat162*>(S + (size_t)e * D + n0 + 2 * (tid % 4));
#pragma unroll
  for (int j = 0; j < T::BN / 8; ++j) {
    const float2 sc = __bfloat1622float2(scale[4 * j]);
    acc[4 * j] *= sc.x;  // rows g and g + 8 of columns 8j + 2t, + 1
    acc[4 * j + 1] *= sc.y;
    acc[4 * j + 2] *= sc.x;
    acc[4 * j + 3] *= sc.y;
  }
  sm90::store_rows<T, false>(acc, Y + ((size_t)e * C + r0 + wg * 64) * D + n0, D, valid - wg * 64);
}

template <class T>
int launch_down_q8_padded(const void* h, const void* w_down, const void* s_down, void* y, int e, int c, int f, int d,
                          cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(expert_down_q8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DownMaps maps;
  if (reinterpret_cast<uintptr_t>(y) % 16 || !sm90::map_3d(&maps.h, h, f, c, e, down_rows(c, T::BM)) ||
      !sm90::map_3d(&maps.wd, w_down, d, f, e, 64, 1))
    return (int)cudaErrorInvalidValue;
  return launch_padded<T>(expert_down_q8_kernel<T>, maps, y, e, c, d / T::BN, f, d, s, (const bf16*)s_down);
}

// #1's grid, row split and clusters with #10's slab: (x[e]; Wg[e] | Wu[e])
// with one 128-column int8 box of each, which widen_s8 turns into #1's four
// bf16 boxes, so the m64n256 accumulator holds g in columns 0-127 and u in
// 128-255. #10's epilogue: the scales loaded a column pair at a time after
// the K loop, silu(g * s_gate) * (u * s_up) in fp32, bf16 pairs stored from
// registers, only rows below C; a warpgroup with no row below C widens its
// share of each slab and stores nothing.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
expert_gate_up_q8_kernel(const __grid_constant__ GateUpMaps maps, const bf16* __restrict__ s_gate,
                         const bf16* __restrict__ s_up, bf16* __restrict__ H, int C, int D, int F) {
  static_assert(T::BN == 2 * GU_BN && T::B_MN, "g | u side by side, an N-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int nsub = (C + T::BM - 1) / T::BM, R = down_rows(C, T::BM);
  const int e = blockIdx.x / nsub, r0 = (blockIdx.x % nsub) * R;
  const int n0 = blockIdx.y * GU_BN;
  const int valid = min(R, C - r0);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a row below C
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n_slabs = D / T::BK;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS)
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const int k0 = i * T::BK;
        sm90::tma_load_3d(a, &maps.x, k0, r0, e, bar);
        sm90::tma_load_3d(b, &maps.wg, n0, k0, e, bar);
        sm90::tma_load_3d(b + T::BK * 128, &maps.wu, n0, k0, e, bar);
      }, R * 128 + T::B_BYTES);
    return;
  }
  if (wg >= active) {  // no row below C: it only widens its share of each slab
    sm90::widen_slabs(ring, n_slabs);
    return;
  }
  float gu[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) gu[i] = 0.f;
  sm90::consume_s8(ring, n_slabs, wg, gu);
  const int rows = valid - wg * 64;  // this warpgroup's rows below C
  const int warp = (tid % 128) / 32, g8 = (tid % 32) / 4, t = tid % 4;
  // scales of columns n0 + 8j + 2t, +1 at pair 4j, loaded a column pair at a time after the K loop
  const __nv_bfloat162* sg = reinterpret_cast<const __nv_bfloat162*>(s_gate + (size_t)e * F + n0 + 2 * t);
  const __nv_bfloat162* su = reinterpret_cast<const __nv_bfloat162*>(s_up + (size_t)e * F + n0 + 2 * t);
  uint32_t* h = reinterpret_cast<uint32_t*>(H + ((size_t)e * C + r0 + wg * 64 + warp * 16 + g8) * F + n0 + 2 * t);
#pragma unroll
  for (int j = 0; j < GU_BN / 8; ++j) {
    const float2 a = __bfloat1622float2(sg[4 * j]), b = __bfloat1622float2(su[4 * j]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = 4 * j + 2 * hh;
      if (warp * 16 + g8 + 8 * hh < rows)
        h[(size_t)4 * hh * F + 4 * j] = sm90::pack_bf16(swiglu(gu[k] * a.x, gu[GU_BN / 2 + k] * b.x),
                                                        swiglu(gu[k + 1] * a.y, gu[GU_BN / 2 + k + 1] * b.y));
    }
  }
}

template <class T>
int launch_gate_up_q8_padded(const void* xe, const void* w_gate, const void* w_up, const void* s_gate,
                             const void* s_up, void* h, int e, int c, int d, int f, cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(expert_gate_up_q8_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  GateUpMaps maps;
  if (reinterpret_cast<uintptr_t>(h) % 16 || !sm90::map_3d(&maps.x, xe, d, c, e, down_rows(c, T::BM)) ||
      !sm90::map_3d(&maps.wg, w_gate, f, d, e, 64, 1) || !sm90::map_3d(&maps.wu, w_up, f, d, e, 64, 1))
    return (int)cudaErrorInvalidValue;
  return launch_padded<T>(expert_gate_up_q8_kernel<T>, maps, h, e, c, f / GU_BN, d, f, s, (const bf16*)s_gate,
                          (const bf16*)s_up);
}

// The tile arguments of the entry points below pick among the tiles each
// one compiles (the autotuner's candidates, kernels/autotune.py): `nwg`
// consumer warpgroups (1 or 2; 64 rows each), `bn` output columns of a
// block (128 or 256). -1 keeps the fixed rule: BN 256 where d allows it,
// one warpgroup for the padded bf16 kernels at c <= 64. Every tile runs the
// same K loop (64-wide slabs in order, fp32 sums), so the outputs do not
// depend on it.
bool wide_tile(int bn, int d) { return bn == 256 || (bn == -1 && d % 256 == 0); }
bool bad_tile(int bn, int d) { return (bn != -1 && bn != 128 && bn != 256) || (bn == 256 && d % 256); }

}  // namespace

// xs (n_pad, d) -> h (n_pad, f): the wgmma/TMA kernel above
extern "C" int grouped_gate_up(const void* xs, const void* w_gate, const void* w_up,
                               const int* tile_group, const int* tile_rows, void* h,
                               int n_pad, int d, int f, void* stream) {
  if (n_pad % ROW_TILE || d % 64 || f % GU_BN) return (int)cudaErrorInvalidValue;
  return launch_gate_up_sorted<sm90::Tile<2, 2 * GU_BN, true>, false, false>(
      xs, w_gate, w_up, nullptr, nullptr, nullptr, tile_group, tile_rows, h, n_pad, d, f, (cudaStream_t)stream);
}

// h (n_pad, f) -> y (n_pad, d): the wgmma/TMA kernel above, BN `bn`
extern "C" int grouped_down(const void* h, const void* w_down, const int* tile_group,
                            const int* tile_rows, void* y, int n_pad, int f, int d, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || f % 64 || d % 128 || bad_tile(bn, d)) return (int)cudaErrorInvalidValue;
  return wide_tile(bn, d)
             ? launch_grouped_down<sm90::Tile<2, 256, true>, false, false>(h, w_down, nullptr, nullptr, nullptr,
                                                                          tile_group, tile_rows, y, n_pad, f, d, s)
             : launch_grouped_down<sm90::Tile<2, 128, true>, false, false>(h, w_down, nullptr, nullptr, nullptr,
                                                                          tile_group, tile_rows, y, n_pad, f, d, s);
}

// xe (E, c, d) -> h (E, c, f): the wgmma/TMA kernel above with `nwg`
// consumer warpgroups a block (the rule: one at c <= 64, decode)
extern "C" int expert_gate_up(const void* xe, const void* w_gate, const void* w_up, void* h,
                              int e, int c, int d, int f, int nwg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (e < 1 || c < 1 || d % 64 || f % GU_BN || (nwg != -1 && nwg != 1 && nwg != 2))
    return (int)cudaErrorInvalidValue;
  return (nwg == -1 ? c <= 64 : nwg == 1) ? launch_gate_up<sm90::Tile<1, 2 * GU_BN, true>>(xe, w_gate, w_up, h, e, c, d, f, s)
                 : launch_gate_up<sm90::Tile<2, 2 * GU_BN, true>>(xe, w_gate, w_up, h, e, c, d, f, s);
}

// h (E, c, f) -> y (E, c, d): the wgmma/TMA kernel above with `nwg`
// consumer warpgroups a block (the rule: one at c <= 64, decode), BN `bn`
extern "C" int expert_down(const void* h, const void* w_down, void* y, int e, int c, int f, int d, int nwg,
                           int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (e < 1 || c < 1 || f % 64 || d % 128 || (nwg != -1 && nwg != 1 && nwg != 2) || bad_tile(bn, d))
    return (int)cudaErrorInvalidValue;
  const bool wide = wide_tile(bn, d);
  if (nwg == -1 ? c <= 64 : nwg == 1)
    return wide ? launch_down<sm90::Tile<1, 256, true>>(h, w_down, y, e, c, f, d, s)
                : launch_down<sm90::Tile<1, 128, true>>(h, w_down, y, e, c, f, d, s);
  return wide ? launch_down<sm90::Tile<2, 256, true>>(h, w_down, y, e, c, f, d, s)
              : launch_down<sm90::Tile<2, 128, true>>(h, w_down, y, e, c, f, d, s);
}

// xe (E, c, d) bf16; w_gate/w_up (E, d, f) int8; s_gate/s_up (E, f) bf16 -> h (E, c, f): the
// wgmma/TMA kernel above
extern "C" int expert_gate_up_q8(const void* xe, const void* w_gate, const void* w_up, const void* s_gate,
                                 const void* s_up, void* h, int e, int c, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (e < 1 || c < 1 || d % 64 || f % GU_BN) return (int)cudaErrorInvalidValue;
  return launch_gate_up_q8_padded<Q8Tile<2 * GU_BN>>(xe, w_gate, w_up, s_gate, s_up, h, e, c, d, f, s);
}

// h (E, c, f) bf16; w_down (E, f, d) int8; s_down (E, d) bf16 -> y (E, c, d): the wgmma/TMA
// kernel above, BN `bn`
extern "C" int expert_down_q8(const void* h, const void* w_down, const void* s_down, void* y, int e, int c, int f,
                              int d, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (e < 1 || c < 1 || f % 64 || d % 128 || bad_tile(bn, d)) return (int)cudaErrorInvalidValue;
  return wide_tile(bn, d) ? launch_down_q8_padded<Q8Tile<256>>(h, w_down, s_down, y, e, c, f, d, s)
                      : launch_down_q8_padded<Q8Tile<128>>(h, w_down, s_down, y, e, c, f, d, s);
}

// xs (n_pad, d) bf16; w_gate/w_up (E, d, f) int8; s_gate/s_up (E, f) bf16 -> h (n_pad, f): the
// wgmma/TMA kernel above
extern "C" int grouped_gate_up_q8(const void* xs, const void* w_gate, const void* w_up,
                                  const void* s_gate, const void* s_up, const int* tile_group,
                                  const int* tile_rows, void* h, int n_pad, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || d % 64 || f % GU_BN) return (int)cudaErrorInvalidValue;
  return launch_gate_up_sorted<Q8Tile<2 * GU_BN>, true, false>(xs, w_gate, w_up, s_gate, s_up, nullptr, tile_group,
                                                                tile_rows, h, n_pad, d, f, s);
}

// h (n_pad, f) bf16; w_down (E, f, d) int8; s_down (E, d) bf16 -> y (n_pad, d): the wgmma/TMA kernel
// above, BN `bn`
extern "C" int grouped_down_q8(const void* h, const void* w_down, const void* s_down, const int* tile_group,
                               const int* tile_rows, void* y, int n_pad, int f, int d, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || f % 64 || d % 128 || bad_tile(bn, d)) return (int)cudaErrorInvalidValue;
  return wide_tile(bn, d) ? launch_grouped_down<Q8Tile<256>, true, false>(h, w_down, s_down, nullptr, nullptr, tile_group,
                                                                      tile_rows, y, n_pad, f, d, s)
                      : launch_grouped_down<Q8Tile<128>, true, false>(h, w_down, s_down, nullptr, nullptr, tile_group,
                                                                      tile_rows, y, n_pad, f, d, s);
}

// x (T, d) token-major; tok_pad (n_pad,) source token of each buffer row -> h (n_pad, f): the wgmma/TMA
// kernel above, its A rows gathered into the slot
extern "C" int grouped_gate_up_fused(const void* x, const void* w_gate, const void* w_up, const int* tok_pad,
                                     const int* tile_group, const int* tile_rows, void* h, int n_pad, int d, int f,
                                     void* stream) {
  if (n_pad % ROW_TILE || d % 64 || f % GU_BN) return (int)cudaErrorInvalidValue;
  return launch_gate_up_sorted<sm90::Tile<2, 2 * GU_BN, true, 0, 2, GATHER_WARPS>, false, true>(
      x, w_gate, w_up, nullptr, nullptr, tok_pad, tile_group, tile_rows, h, n_pad, d, f, (cudaStream_t)stream);
}

// h (n_pad, f); row_out / gate_pad (n_pad,) -> partials (k*T, d), each row written once: the wgmma/TMA kernel
// above, BN `bn`
extern "C" int grouped_down_fused(const void* h, const void* w_down, const int* row_out, const float* gate_pad,
                                  const int* tile_group, const int* tile_rows, void* partials, int n_pad, int f,
                                  int d, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || f % 64 || d % 128 || bad_tile(bn, d)) return (int)cudaErrorInvalidValue;
  return wide_tile(bn, d) ? launch_grouped_down<sm90::Tile<2, 256, true>, false, true>(
                            h, w_down, nullptr, row_out, gate_pad, tile_group, tile_rows, partials, n_pad, f, d, s)
                      : launch_grouped_down<sm90::Tile<2, 128, true>, false, true>(
                            h, w_down, nullptr, row_out, gate_pad, tile_group, tile_rows, partials, n_pad, f, d, s);
}

// x (T, d) token-major; w_gate/w_up (E, d, f) int8; s_gate/s_up (E, f) bf16; tok_pad (n_pad,) source token of
// each buffer row -> h (n_pad, f): the wgmma/TMA kernel above, its A rows gathered into the slot
extern "C" int grouped_gate_up_fused_q8(const void* x, const void* w_gate, const void* w_up, const void* s_gate,
                                        const void* s_up, const int* tok_pad, const int* tile_group,
                                        const int* tile_rows, void* h, int n_pad, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || d % 64 || f % GU_BN) return (int)cudaErrorInvalidValue;
  return launch_gate_up_sorted<Q8Tile<2 * GU_BN, GATHER_WARPS>, true, true>(x, w_gate, w_up, s_gate, s_up, tok_pad,
                                                                             tile_group, tile_rows, h, n_pad, d, f,
                                                                             s);
}

// h (n_pad, f); w_down (E, f, d) int8; s_down (E, d) bf16; row_out / gate_pad (n_pad,) -> partials
// (k*T, d), each row written once: the wgmma/TMA kernel above, BN `bn`
extern "C" int grouped_down_fused_q8(const void* h, const void* w_down, const void* s_down, const int* row_out,
                                     const float* gate_pad, const int* tile_group, const int* tile_rows,
                                     void* partials, int n_pad, int f, int d, int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || f % 64 || d % 128 || bad_tile(bn, d)) return (int)cudaErrorInvalidValue;
  return wide_tile(bn, d) ? launch_grouped_down<Q8Tile<256>, true, true>(h, w_down, s_down, row_out, gate_pad,
                                                                     tile_group, tile_rows, partials, n_pad, f, d, s)
                      : launch_grouped_down<Q8Tile<128>, true, true>(h, w_down, s_down, row_out, gate_pad,
                                                                     tile_group, tile_rows, partials, n_pad, f, d, s);
}
