// Backward of the grouped expert GEMM with fused SwiGLU over the sorted
// (dropless) layout, for Hopper (sm_90a). All three kernels run on the
// warp-specialised wgmma/TMA mainloop of sm90_gemm.cuh.
//
// Replaces the TPU kernels of src/repro/kernels/expert_gemm.py,
// _grouped_bwd_impl:
//   grouped_bwd_dh    (#5) <- _grouped_bwd_dh_kernel (:489): recompute
//                        g = x@Wg[e], u = x@Wu[e], dh = dy@Wd[e]^T in fp32,
//                        then the SwiGLU backward -> h = silu(g)*u,
//                        dg = dh*u*dsilu(g), du = dh*silu(g), each (N_pad, F)
//                        bf16, rounded once;
//   grouped_bwd_dx    (#6) <- _grouped_bwd_dx_kernel (:521):
//                        dx = dg@Wg[e]^T + du@Wu[e]^T;
//   grouped_bwd_wgrad (#7) <- _grouped_bwd_wgrad_kernel (:540): per expert
//                        dWg = x^T dg, dWu = x^T du, dWd = h^T dy.
//
// Input layout as in grouped_gemm.cu: an expert-sorted (N_pad, D) buffer
// whose expert regions are aligned to 128 rows; per 128-row tile,
// tile_group[t] is its expert and tile_rows[t] its valid rows. Rows past
// the valid count come out exactly 0 in h, dg, du and dx; a tile with no
// valid row stores zeros and loads nothing, and a consumer warpgroup whose
// 64 rows hold no valid row runs no product. Each output element is one
// fp32 sum in a fixed order, rounded to bf16 once: no atomics, no split
// over K, and two launches are bit-equal.
//
// What bounds them on an H100: at training shapes (2048 tokens x top-2 =
// 4096 rows in N_pad 5120 over 8 experts, D 4096, F 14336) each is a GEMM
// of ~1-1.4 TFLOP against ~1-3 GB of weights, activations and outputs,
// far on the tensor-core side of the ridge: bound by operations (#5 and
// #7 1.443 TFLOP, 1.459 ms at 989 TFLOP/s; #6 0.962 TFLOP, 0.973 ms). The
// mainloop they share runs at ~50-60% of that peak, held by the bytes each
// SM takes in per FLOP (sm90_gemm.cuh): a 128 x 256 tile at 48 KB a slab.
//
// dh (#5), two launches. The TPU kernel keeps g, u and dh of a tile in
// VMEM; here the three fp32 products would need 192 accumulators a
// consumer thread, and ptxas holds a block of a producer warp and two
// consumer warpgroups to 168 registers (setmaxnreg is ignored; parking dh
// in shared memory left a 3-slot ring and a 128 x 128 dh product well
// below the rate of the 128 x 256 ones). So:
//   1. dh = dy Wd[e]^T, fp32, into a scratch (N_pad, F) the wrapper
//      allocates: one block per (128-row tile, 256 F columns; 128 where F
//      is not a multiple of 256), as #6, a K-major B (Wd[e] is (F, D): a
//      row is one output column along K).
//   2. One block per (128-row tile, 128 F columns): D / 64 slabs of
//      (x; Wg[e] | Wu[e]), one m64n256 product whose B is four N-major
//      boxes (Wg[e] and Wu[e] are (D, F): K on the rows), so accumulator
//      columns 0-127 are g and 128-255 are u; then, as the ring's next
//      slab for each warpgroup, its 64 rows of the fp32 dh tile (four
//      boxes of 32 columns). The SwiGLU backward runs pair by pair: g and
//      u from registers (element 4j + e of g and 4(j + 16) + e of the
//      accumulator sit at the same row and column), dh from shared memory
//      at that row and column, and h, dg, du are stored from registers.
//   Both run their blocks in groups of 8 row tiles, column block by column
//   block (grouped_tile), so a group's x or dy and a column block's weights
//   are read by blocks that run together, launched as clusters of 2.
//   The fp32 dh is summed once and read back unchanged, so h, dg and du are
//   each rounded to bf16 once, as in the TPU kernel. The scratch costs
//   N_pad x F x 4 bytes (294 MB at the training shape) of one write and
//   one read.
//
// dx (#6): one block per (128-row tile, 256 D columns; 128 where D is not
// a multiple of 256); the contraction is one accumulator over 2F: F / 64
// slabs of (dg, Wg[e]) and then F / 64 of (du, Wu[e]), a K-major B.
//
// wgrad (#7): the TPU kernel accumulates fp32 (E, D, F) blocks in HBM
// across its sequential row-tile grid and casts after. Here an output
// tile's K is its expert's rows (~536 at the training groups, ~8 slabs),
// and the output (3 x E x D x F bf16, 2.8 GB, 0.84 ms of bytes) is more
// than half the operation bound, so a block that ran one tile would spend
// much of it filling the ring and storing. The grid is persistent: one
// block per SM walks tiles t = blockIdx.x, + gridDim.x, ... of a fixed
// order, expert by expert: first the (D / 128) x (F / 128) tiles of (dWg |
// dWu), 128 rows of D by 128 columns of F each, column-major (the 32 tiles
// of one F block of dg, du run together and x stays in L2), then the
// (F / 128) x ceil(D / 256) tiles of dWd, 128 rows of F by 256 columns of
// D, row-major (dy stays in L2). Both are one m64n256 product a slab with
// A M-major (x^T or h^T: a box of x has K = rows on its rows; wgmma's
// transpose-A bit) and B N-major (dg | du, or dy). The producer runs ahead
// into the next tile's slabs while the consumers finish the last one; the
// consumers stage the finished tile in shared memory (64 KB, in the 128B
// swizzle) for TMA stores that drain while the next tile's products run,
// so a tile's fill and its store overlap other tiles' products and only
// the pipeline drain at each tile's end and the staging (two barriers and
// 64 shared stores a thread) are left in its path; a store straight from
// registers (16 scattered bytes a row per warp store) left #7 well over its
// library yardstick at the training shape (PERF.md).
// K runs over the expert's rows rounded up to 64 from row_start[e];
// regions are 128-aligned, so the last slab holds only padding rows of the
// same expert past the count, and those rows are cleared in shared memory
// before any product reads them (zero_rows), so no value they hold (NaN
// included) reaches a sum. An expert with no rows stores zeros. A dWd tile
// past D (D not a multiple of 256) loads and stores only its first 128
// columns.
//
// Per block (ptxas -v, build/kernels/grouped_gemm_bwd-*.log; 288 threads,
// no spills): #5 dh = dy Wd^T 154 registers (BN 256; 90 at 128), 197,696 B
// of shared memory; #5 h, dg, du 159, 197,696 B; #6 155 (90 at BN 128),
// 197,696 B; #7 162, 214,064 B (3 ring slots and the staged tile).
//
// Left for later: two consumer warpgroups that alternate whole tiles in
// #7 (each tile ends in a drained pipeline; a ping-pong would hide it),
// and for #5 a single launch once three live products fit a thread's
// registers, or thread-block clusters for #5 and #6 (tiles of one expert
// sharing the weights).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "sm90_gemm.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_TILE = 128;  // metadata granularity (sorted-buffer alignment)

// The weights' expert count is not an argument of dh and dx: tile_group
// names the expert of each tile, so the weight maps span MAX_EXPERTS
// experts and no box is ever asked past the last real one.
constexpr uint64_t MAX_EXPERTS = 1 << 16;

// BM x W bf16 zeros at out (row stride ld), by `threads` threads
template <int BM, int W>
__device__ __forceinline__ void store_zeros(bf16* out, size_t ld, int threads) {
  for (int c = threadIdx.x; c < BM * W / 8; c += threads)
    *reinterpret_cast<uint4*>(out + (c / (W / 8)) * ld + (c % (W / 8)) * 8) = make_uint4(0, 0, 0, 0);
}

// Both launches of #5 run a 1D grid of nr x nc blocks in groups of
// DH_GROUP row tiles, each group's blocks column block by column block,
// its row tiles fastest: the group's activations (x or dy) and each column
// block's weights are read by blocks that run together, so both come from
// L2 more often than in a grid whose row tiles run fastest over all nr
// (faster at the training shape, and alike for groups of 6 to 12; PERF.md).
constexpr int DH_GROUP = 8;

__device__ __forceinline__ void grouped_tile(int nc, int& row, int& col) {
  const int nr = gridDim.x / nc, g = blockIdx.x / (DH_GROUP * nc), r = blockIdx.x % (DH_GROUP * nc);
  const int rows = min(DH_GROUP, nr - g * DH_GROUP);
  row = g * DH_GROUP + r % rows;
  col = r / rows;
}

// ---------------------------------------------------------------------------
// #5 dh, in two launches: dh = dy Wd[e]^T into an fp32 scratch, then x (Wg | Wu)
// with the SwiGLU backward reading dh back through the ring
// ---------------------------------------------------------------------------

constexpr int DH_BN = 128;  // F columns per block of the g | u launch

// dy (N_pad, D) in boxes of 64 columns x 128 rows; Wd (E, F, D) in boxes of
// 64 D columns x BN F rows (K-major B: a row is one output column)
struct DhDownMaps {
  CUtensorMap dy, wd;
};

// dh (N_pad, F) fp32 = dy Wd[e]^T: one block per (128-row tile, BN F
// columns), as #6. Rows past the valid count store zeros; a tile with no
// valid row stores nothing (the second launch never reads it).
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
bwd_dh_down_kernel(const __grid_constant__ DhDownMaps maps, const int* __restrict__ tile_group,
                   const int* __restrict__ tile_rows, float* __restrict__ DH, int D, int F) {
  static_assert(T::BM == ROW_TILE && !T::B_MN, "one block per row tile, a K-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  int tile, cb;
  grouped_tile(F / T::BN, tile, cb);
  const int row0 = tile * T::BM, n0 = cb * T::BN;
  const int valid = min(max(tile_rows[tile], 0), T::BM);
  const int active = (valid + 63) / 64;
  if (active == 0) return;
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int e = tile_group[tile];
  if (wg == T::NWG) {
    if (tid == T::CONSUMERS)
      sm90::produce(ring, D / T::BK, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        sm90::tma_load_3d(a, &maps.dy, i * T::BK, row0, 0, bar);
        sm90::tma_load_3d(b, &maps.wd, i * T::BK, n0, e, bar);
      });
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  if (wg < active) sm90::consume(ring, D / T::BK, wg, acc);
  sm90::store_rows<T, true>(acc, DH + (size_t)(row0 + wg * 64) * F + n0, F, valid - wg * 64);
}

// x (N_pad, D) in boxes of 64 columns x 128 rows; Wg, Wu (E, D, F) in boxes
// of 64 F columns x 64 D rows (N-major B); dh (N_pad, F) fp32 in boxes of
// 32 columns x 64 rows
struct DhMaps {
  CUtensorMap x, wg, wu, dh;
};

// h, dg, du: one block per (128-row tile, 128 F columns). D / 64 slabs of
// (x; Wg[e] | Wu[e]) into one m64n256 accumulator (g | u), then, through
// the same ring, slab D / 64 + w: warpgroup w's 64 rows of dh (fp32, four
// 8 KB boxes). The SwiGLU backward reads dh from shared memory pair by
// pair in the accumulator's layout and stores h, dg, du straight from it.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
bwd_dh_kernel(const __grid_constant__ DhMaps maps, const int* __restrict__ tile_group,
              const int* __restrict__ tile_rows, bf16* __restrict__ H, bf16* __restrict__ DG,
              bf16* __restrict__ DU, int D, int F) {
  static_assert(T::BM == ROW_TILE && T::BN == 2 * DH_BN && T::B_MN, "a 128-row tile of g | u, an N-major B");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  int tile, cb;
  grouped_tile(F / DH_BN, tile, cb);
  const int row0 = tile * T::BM, n0 = cb * DH_BN;
  const int valid = min(max(tile_rows[tile], 0), T::BM);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a valid row
  if (active == 0) {  // empty tile: zeros, no product
    const size_t at = (size_t)row0 * F + n0;
    store_zeros<T::BM, DH_BN>(H + at, F, T::THREADS);
    store_zeros<T::BM, DH_BN>(DG + at, F, T::THREADS);
    store_zeros<T::BM, DH_BN>(DU + at, F, T::THREADS);
    return;
  }
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int n = D / T::BK;  // slabs of the product
  constexpr int BOX = T::BK * 128;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS) {
      const int e = tile_group[tile];
      sm90::produce_at(
          ring, 0, n,
          [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
            const int k0 = i * T::BK;
            sm90::tma_load_3d(a, &maps.x, k0, row0, 0, bar);
            sm90::tma_load_3d(b, &maps.wg, n0, k0, e, bar);
            sm90::tma_load_3d(b + BOX, &maps.wg, n0 + 64, k0, e, bar);
            sm90::tma_load_3d(b + 2 * BOX, &maps.wu, n0, k0, e, bar);
            sm90::tma_load_3d(b + 3 * BOX, &maps.wu, n0 + 64, k0, e, bar);
          },
          [](int) { return (uint32_t)T::STAGE; });
      sm90::produce_at(
          ring, n, active,
          [&](int i, uint32_t a, uint32_t, uint32_t bar) {
#pragma unroll
            for (int c = 0; c < DH_BN / 32; ++c)
              sm90::tma_load_3d(a + c * BOX, &maps.dh, n0 + 32 * c, row0 + 64 * (i - n), 0, bar);
          },
          [](int) { return (uint32_t)(DH_BN / 32 * BOX); });
    }
    return;
  }
  float gu[2 * DH_BN / 2];  // g | u in the m64n256 layout
#pragma unroll
  for (int i = 0; i < DH_BN; ++i) gu[i] = 0.f;
  const int rows = valid - wg * 64;  // this warpgroup's valid rows (none if it is idle)
  if (wg < active) {
    sm90::consume_at<T, 2 * DH_BN, 0, 1>(ring, 0, n, wg, gu);
    sm90::mbar_wait(ring.full((n + wg) % T::STAGES), ((n + wg) / T::STAGES) & 1);
  }
  // SwiGLU backward in fp32, one (row, column pair) at a time: dh from the
  // slot (32 fp32 columns a box, 16-byte chunk c of row r at c ^ (r % 8)),
  // g and u from the accumulator; rows past the valid count store zeros
  const uint32_t dsm = ring.a((n + wg) % T::STAGES);
  const int warp = (tid % 128) / 32, g8 = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g8 + 8 * hh;
    const size_t at = (size_t)(row0 + wg * 64 + r) * F + n0 + 2 * t;
    uint32_t* h = reinterpret_cast<uint32_t*>(H + at);
    uint32_t* dg = reinterpret_cast<uint32_t*>(DG + at);
    uint32_t* du = reinterpret_cast<uint32_t*>(DU + at);
#pragma unroll
    for (int j = 0; j < DH_BN / 8; ++j) {
      if (r >= rows) {
        h[4 * j] = dg[4 * j] = du[4 * j] = 0u;
        continue;
      }
      float d[2], o[3][2];
      const uint32_t chunk = (2 * (j % 4) + (t >> 1)) ^ g8;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(d[0]), "=f"(d[1])
                   : "r"(dsm + (j / 4) * BOX + r * 128 + chunk * 16 + (t & 1) * 8));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float gv = gu[4 * j + 2 * hh + q], uv = gu[DH_BN / 2 + 4 * j + 2 * hh + q];
        const float sig = __fdividef(1.0f, 1.0f + expf(-gv));  // no IEEE division: its slow path is a call
        const float silu = gv * sig;
        const float dsilu = sig * (1.0f + gv * (1.0f - sig));
        o[0][q] = silu * uv;
        o[1][q] = d[q] * uv * dsilu;
        o[2][q] = d[q] * silu;
      }
      h[4 * j] = sm90::pack_bf16(o[0][0], o[0][1]);
      dg[4 * j] = sm90::pack_bf16(o[1][0], o[1][1]);
      du[4 * j] = sm90::pack_bf16(o[2][0], o[2][1]);
    }
  }
}

// Launch a 1D grid of `blocks` as thread-block clusters of DH_CLUSTER
// (where that divides it): two neighbours of the grouped order, which read
// the same weight boxes, run at once on one GPC (no multicast). Both of
// #5's launches ran faster so at the training shape; clusters of 4 did not
// (PERF.md).
constexpr int DH_CLUSTER = 2;

template <class K, class... Args>
int launch_clustered(K kernel, int blocks, int threads, int smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = blocks % DH_CLUSTER ? 1 : DH_CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <class TD>
int launch_dh_down(const void* dy, const void* w_down, const int* tile_group, const int* tile_rows, void* dh32,
                   int n_pad, int d, int f, cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(bwd_dh_down_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize, TD::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DhDownMaps maps;
  if (reinterpret_cast<uintptr_t>(dh32) % 16 || !sm90::map_3d(&maps.dy, dy, d, n_pad, 1, TD::BM) ||
      !sm90::map_3d(&maps.wd, w_down, d, f, MAX_EXPERTS, TD::BN))
    return (int)cudaErrorInvalidValue;
  return launch_clustered(bwd_dh_down_kernel<TD>, (n_pad / TD::BM) * (f / TD::BN), TD::THREADS, TD::SMEM, s, maps,
                          tile_group, tile_rows, (float*)dh32, d, f);
}

int launch_dh(const void* xs, const void* w_gate, const void* w_up, const int* tile_group, const int* tile_rows,
              const void* dh32, void* h, void* dg, void* du, int n_pad, int d, int f, cudaStream_t s) {
  typedef sm90::Tile<2, 2 * DH_BN, true> T;
  static const cudaError_t attr =  // once per process
      cudaFuncSetAttribute(bwd_dh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DhMaps maps;
  if (reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(dg) % 16 ||
      reinterpret_cast<uintptr_t>(du) % 16 || !sm90::map_3d(&maps.x, xs, d, n_pad, 1, T::BM) ||
      !sm90::map_3d(&maps.wg, w_gate, f, d, MAX_EXPERTS, 64) || !sm90::map_3d(&maps.wu, w_up, f, d, MAX_EXPERTS, 64) ||
      !sm90::map_3d(&maps.dh, dh32, f, n_pad, 1, 64, 4))
    return (int)cudaErrorInvalidValue;
  return launch_clustered(bwd_dh_kernel<T>, (n_pad / T::BM) * (f / DH_BN), T::THREADS, T::SMEM, s, maps, tile_group,
                          tile_rows, (bf16*)h, (bf16*)dg, (bf16*)du, d, f);
}

// ---------------------------------------------------------------------------
// #6 dx = dg @ Wg[e]^T + du @ Wu[e]^T on the shared wgmma/TMA mainloop: one
// block per (128-row tile, BN D columns), contraction 2F in one accumulator
// ---------------------------------------------------------------------------

// dg, du (N_pad, F) in boxes of 64 columns x 128 rows; Wg, Wu (E, D, F) in
// boxes of 64 columns x BN rows (K-major B: a row is one output column)
struct DxMaps {
  CUtensorMap dg, du, wg, wu;
};

// The tile's first F / 64 slabs are (dg, Wg[e]), the next F / 64 (du,
// Wu[e]). blockIdx.x = row tile (the fastest grid dimension, so the tiles
// of one expert's weight columns run together), blockIdx.y = column block.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
bwd_dx_kernel(const __grid_constant__ DxMaps maps, const int* __restrict__ tile_group,
              const int* __restrict__ tile_rows, bf16* __restrict__ DX, int D, int F) {
  static_assert(T::BM == ROW_TILE, "one block per row tile of the sorted buffer");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = tid / 128;
  const int tile = blockIdx.x, row0 = tile * T::BM, n0 = blockIdx.y * T::BN;
  const int valid = min(max(tile_rows[tile], 0), T::BM);
  const int active = (valid + 63) / 64;  // consumer warpgroups with a valid row
  if (active == 0) {  // empty tile: zeros, no product
    for (int c = tid; c < T::BM * T::BN / 8; c += T::THREADS) {
      const int r = c / (T::BN / 8), col = (c % (T::BN / 8)) * 8;
      *reinterpret_cast<uint4*>(DX + (size_t)(row0 + r) * D + n0 + col) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * active);
  __syncthreads();
  const int e = tile_group[tile];
  const int half = F / T::BK, n_slabs = 2 * half;
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid == T::CONSUMERS)
      sm90::produce(ring, n_slabs, [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
        const bool up = i >= half;
        const int k0 = (up ? i - half : i) * T::BK;
        sm90::tma_load_3d(a, up ? &maps.du : &maps.dg, k0, row0, 0, bar);
        sm90::tma_load_3d(b, up ? &maps.wu : &maps.wg, k0, n0, e, bar);
      });
    return;
  }
  float acc[T::BN / 2];
#pragma unroll
  for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
  if (wg < active) sm90::consume(ring, n_slabs, wg, acc);
  // rows past the valid count, all of an idle warpgroup's among them, store zeros
  sm90::store_rows<T, true>(acc, DX + (size_t)(row0 + wg * 64) * D + n0, D, valid - wg * 64);
}

template <class T>
int launch_dx(const void* dg, const void* du, const void* w_gate, const void* w_up, const int* tile_group,
              const int* tile_rows, void* dx, int n_pad, int d, int f, cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(bwd_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  DxMaps maps;
  if (reinterpret_cast<uintptr_t>(dx) % 16 || !sm90::map_3d(&maps.dg, dg, f, n_pad, 1, T::BM) ||
      !sm90::map_3d(&maps.du, du, f, n_pad, 1, T::BM) || !sm90::map_3d(&maps.wg, w_gate, f, d, MAX_EXPERTS, T::BN) ||
      !sm90::map_3d(&maps.wu, w_up, f, d, MAX_EXPERTS, T::BN))
    return (int)cudaErrorInvalidValue;
  bwd_dx_kernel<T><<<dim3(n_pad / T::BM, d / T::BN), T::THREADS, T::SMEM, s>>>(maps, tile_group, tile_rows,
                                                                                 (bf16*)dx, d, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// #7 wgrad: a persistent grid over (expert, output tile); K = the expert's rows
// ---------------------------------------------------------------------------

// x, dy (N_pad, D) and h, dg, du (N_pad, F), all in boxes of 64 columns x
// 64 rows: A M-major (x^T, h^T), B N-major (dg, du, dy); the outputs dWg,
// dWu (E, D, F) and dWd (E, F, D) in boxes of 64 columns x 128 rows, the
// TMA stores' destinations
struct WgradMaps {
  CUtensorMap x, dy, h, dg, du, dwg, dwu, dwd;
};

constexpr int WG_STAGE_BYTES = 128 * 256 * 2;  // a 128 x 256 bf16 output tile, staged for the TMA store

// Output tile t of the fixed walk: expert e; a (dWg | dWu) tile (GU) at
// rows m0 of D, columns n0 of F, or a dWd tile at rows m0 of F, columns
// n0 of D (`wide`: all 256 columns lie inside D).
struct WgTile {
  int e, m0, n0;
  bool gu, wide;
};

__device__ __forceinline__ WgTile wgrad_tile(int t, int D, int F) {
  const int gu_m = D / 128, gu_tiles = gu_m * (F / 128), dd_n = (D + 255) / 256;
  const int per_e = gu_tiles + (F / 128) * dd_n;
  WgTile w;
  w.e = t / per_e;
  int l = t % per_e;
  w.gu = l < gu_tiles;
  if (w.gu) {  // column-major: the tiles of one F block run together
    w.m0 = (l % gu_m) * 128;
    w.n0 = (l / gu_m) * 128;
    w.wide = true;
  } else {  // row-major: the tiles of one F block of h run together
    l -= gu_tiles;
    w.m0 = (l / dd_n) * 128;
    w.n0 = (l % dd_n) * 256;
    w.wide = w.n0 + 256 <= D;
  }
  return w;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
bwd_wgrad_kernel(const __grid_constant__ WgradMaps maps, const int* __restrict__ row_start,
                 const int* __restrict__ rows, int n_tiles, int D, int F) {
  static_assert(T::BM == 128 && T::BN == 256 && T::THREADS == T::CONSUMERS + 32 && T::EXTRA == WG_STAGE_BYTES,
                "128 x 256 tiles, a producer warp, the output tile staged after the ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform: a uniform register
  const sm90::Ring<T> ring = sm90::ring_at<T>(smem_raw);
  if (tid == 0) ring.init(4 * T::NWG);
  __syncthreads();
  constexpr int BOX = T::BK * 128;  // one 64 x 64 box
  if (wg == T::NWG) {  // the producer warp: one thread issues every copy
    if (tid != T::CONSUMERS) return;
    int it = 0;  // the block's running slab index
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WgTile w = wgrad_tile(t, D, F);
      const int start = row_start[w.e], n = (rows[w.e] + T::BK - 1) / T::BK;
      const CUtensorMap* A = w.gu ? &maps.x : &maps.h;
      const CUtensorMap* B0 = w.gu ? &maps.dg : &maps.dy;
      const CUtensorMap* B1 = w.gu ? &maps.du : &maps.dy;
      const int b1 = w.gu ? 0 : 128;  // column of B's third box: du's first, or dy's n0 + 128
      sm90::produce_at(
          ring, it, n,
          [&](int i, uint32_t a, uint32_t b, uint32_t bar) {
            const int r = start + (i - it) * T::BK;
            sm90::tma_load_3d(a, A, w.m0, r, 0, bar);
            sm90::tma_load_3d(a + BOX, A, w.m0 + 64, r, 0, bar);
            sm90::tma_load_3d(b, B0, w.n0, r, 0, bar);
            sm90::tma_load_3d(b + BOX, B0, w.n0 + 64, r, 0, bar);
            if (w.wide) {
              sm90::tma_load_3d(b + 2 * BOX, B1, w.n0 + b1, r, 0, bar);
              sm90::tma_load_3d(b + 3 * BOX, B1, w.n0 + b1 + 64, r, 0, bar);
            }
          },
          [&](int) { return (uint32_t)((w.wide ? 6 : 4) * BOX); });
      it += n;
    }
    return;
  }
  // the consumers: products, then the tile through shared memory to a TMA
  // store that drains while the next tile's products run
  constexpr int OUT_BOX = 128 * 128;  // 64 columns x 128 rows of the staged tile
  const uint32_t staged = ring.extra();
  float acc[T::BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int count = rows[wgrad_tile(t, D, F).e], n = (count + T::BK - 1) / T::BK, tail = count % T::BK;
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
    // the last slab's rows past the expert's count are cleared before any product reads them
    sm90::consume_at<T, T::BN, 1, 1>(ring, it, n, wg, acc, [&](int i, int s) {
      if (tail == 0 || i != it + n - 1) return;
      sm90::zero_rows(ring.a(s), T::STAGE / BOX, tail, tid, T::CONSUMERS);
      sm90::named_sync(1, T::CONSUMERS);
    });
    it += n;
    const WgTile w = wgrad_tile(t, D, F);  // recomputed: fewer registers live across the products
    if (tid == 0) sm90::bulk_wait_read<0>();  // the last tile's store has read the staging buffer
    sm90::named_sync(1, T::CONSUMERS);
    if (w.wide)
      sm90::stage_sw128<256, 0>(acc, staged, OUT_BOX, wg * 64);
    else
      sm90::stage_sw128<128, 0>(acc, staged, OUT_BOX, wg * 64);
    sm90::fence_async_smem();
    sm90::named_sync(1, T::CONSUMERS);
    if (tid == 0) {
      if (w.gu) {  // columns 0-127 are dWg's, 128-255 dWu's
        sm90::tma_store_3d(&maps.dwg, w.n0, w.m0, w.e, staged);
        sm90::tma_store_3d(&maps.dwg, w.n0 + 64, w.m0, w.e, staged + OUT_BOX);
        sm90::tma_store_3d(&maps.dwu, w.n0, w.m0, w.e, staged + 2 * OUT_BOX);
        sm90::tma_store_3d(&maps.dwu, w.n0 + 64, w.m0, w.e, staged + 3 * OUT_BOX);
      } else {
        for (int c = 0; c < (w.wide ? 4 : 2); ++c)
          sm90::tma_store_3d(&maps.dwd, w.n0 + 64 * c, w.m0, w.e, staged + c * OUT_BOX);
      }
      sm90::bulk_commit();
    }
  }
  if (tid == 0) sm90::bulk_wait<0>();  // every store has landed before the block's shared memory goes
}

template <class T>
int launch_wgrad(const void* xs, const void* dy, const void* h, const void* dg, const void* du, const int* row_start,
                 const int* rows, void* dwg, void* dwu, void* dwd, int e, int n_pad, int d, int f, cudaStream_t s) {
  static const cudaError_t attr =  // once per process and tile shape
      cudaFuncSetAttribute(bwd_wgrad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  WgradMaps maps;
  if (!sm90::map_3d(&maps.x, xs, d, n_pad, 1, T::BK) || !sm90::map_3d(&maps.dy, dy, d, n_pad, 1, T::BK) ||
      !sm90::map_3d(&maps.h, h, f, n_pad, 1, T::BK) || !sm90::map_3d(&maps.dg, dg, f, n_pad, 1, T::BK) ||
      !sm90::map_3d(&maps.du, du, f, n_pad, 1, T::BK) || !sm90::map_3d(&maps.dwg, dwg, f, d, e, 128) ||
      !sm90::map_3d(&maps.dwu, dwu, f, d, e, 128) || !sm90::map_3d(&maps.dwd, dwd, d, f, e, 128))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = e * ((d / 128) * (f / 128) + (f / 128) * ((d + 255) / 256));
  bwd_wgrad_kernel<T><<<sms < n_tiles ? sms : n_tiles, T::THREADS, T::SMEM, s>>>(maps, row_start, rows, n_tiles, d,
                                                                                  f);
  return (int)cudaGetLastError();
}

}  // namespace

// xs, dy (N_pad, D); w_gate, w_up (E, D, F); w_down (E, F, D) -> h, dg, du
// (N_pad, F) bf16, through dh32 (N_pad, F) fp32 scratch: two launches
// xs, dy (N_pad, D); w_gate, w_up (E, D, F); w_down (E, F, D) -> h, dg, du
// (N_pad, F) bf16, through dh32 (N_pad, F) fp32 scratch: two launches
extern "C" int grouped_bwd_dh(const void* xs, const void* dy, const void* w_gate, const void* w_up,
                              const void* w_down, const int* tile_group, const int* tile_rows, void* h,
                              void* dg, void* du, void* dh32, int n_pad, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || d % 64 || f % DH_BN) return (int)cudaErrorInvalidValue;
  const int err = f % 256 == 0
                      ? launch_dh_down<sm90::Tile<2, 256, false>>(dy, w_down, tile_group, tile_rows, dh32, n_pad, d, f, s)
                      : launch_dh_down<sm90::Tile<2, 128, false>>(dy, w_down, tile_group, tile_rows, dh32, n_pad, d, f, s);
  return err ? err : launch_dh(xs, w_gate, w_up, tile_group, tile_rows, dh32, h, dg, du, n_pad, d, f, s);
}

extern "C" int grouped_bwd_dx(const void* dg, const void* du, const void* w_gate, const void* w_up,
                              const int* tile_group, const int* tile_rows, void* dx, int n_pad, int d,
                              int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_pad % ROW_TILE || f % 64 || d % 128) return (int)cudaErrorInvalidValue;
  return d % 256 == 0
             ? launch_dx<sm90::Tile<2, 256, false>>(dg, du, w_gate, w_up, tile_group, tile_rows, dx, n_pad, d, f, s)
             : launch_dx<sm90::Tile<2, 128, false>>(dg, du, w_gate, w_up, tile_group, tile_rows, dx, n_pad, d, f, s);
}

// (dWg, dWu (E, D, F), dWd (E, F, D)) in one persistent grid. row_start/rows
// (E,) int32: each expert's first row in the aligned buffer and its valid rows.
extern "C" int grouped_bwd_wgrad(const void* xs, const void* dy, const void* h, const void* dg,
                                 const void* du, const int* row_start, const int* rows, void* dwg,
                                 void* dwu, void* dwd, int n_pad, int e, int d, int f, void* stream) {
  if (e < 1 || n_pad % ROW_TILE || d % 128 || f % 128) return (int)cudaErrorInvalidValue;
  return launch_wgrad<sm90::Tile<2, 256, true, WG_STAGE_BYTES>>(xs, dy, h, dg, du, row_start, rows, dwg, dwu, dwd,
                                                                    e, n_pad, d, f, (cudaStream_t)stream);
}


