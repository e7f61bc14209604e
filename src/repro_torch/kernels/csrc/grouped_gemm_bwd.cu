// Backward of the grouped expert GEMM with fused SwiGLU over the sorted
// (dropless) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/expert_gemm.py,
// _grouped_bwd_impl:
//   grouped_bwd_dh    <- _grouped_bwd_dh_kernel: recompute g = x@Wg[e],
//                        u = x@Wu[e], dh = dy@Wd[e]^T in fp32, then the SwiGLU
//                        backward -> h = silu(g)*u, dg = dh*u*dsilu(g),
//                        du = dh*silu(g), each (N_pad, F) bf16;
//   grouped_bwd_dx    <- _grouped_bwd_dx_kernel: dx = dg@Wg[e]^T + du@Wu[e]^T;
//   grouped_bwd_wgrad <- _grouped_bwd_wgrad_kernel: per expert dWg = x^T dg,
//                        dWu = x^T du, dWd = h^T dy.
//
// Input layout as in grouped_gemm.cu: an expert-sorted (N_pad, D) buffer
// whose expert regions are aligned to 128 rows; per 128-row tile,
// tile_group[t] is its expert and tile_rows[t] its valid rows. Rows past the
// valid count come out zero in h, dg, du and dx; a half tile with no valid
// row writes zeros and does no product.
//
// wgrad: the TPU kernel accumulates fp32 (E, D, F) blocks in HBM across its
// sequential row-tile grid and casts after (5.6 GB of fp32 per layer at
// llama3-e8t2 widths). Here blocks run in parallel in no order, so each
// block owns one (expert, 64 x 128) output tile, walks all of that expert's
// rows (row_start[e], rows[e]) itself with the fp32 sums in WMMA
// accumulators, and writes bf16 once: the same fp32 sum, cast once, no
// atomics, and an expert with no rows writes zeros. Rows past rows[e] in
// the last 32-row slab are loaded as zeros.
//
// What bounds them on an H100: at training shapes (2048 tokens x top-2 =
// 4096 rows over 8 experts, D 4096, F 14336) every pass is a GEMM of
// ~0.5-1 TFLOP against ~1 GB of weights and activations, far on the
// tensor-core side of the ridge: bound by operations.
//
// dx (#6) runs on the warp-specialised wgmma/TMA mainloop of
// sm90_gemm.cuh: one block per (128-row tile of the sorted buffer = BM,
// 256 D columns), two consumer warpgroups of 64 rows and a producer warp,
// 4 ring slots of 48 KB. The contraction is one accumulator over 2F: F/64
// slabs of (dg, Wg[e]) and then F/64 of (du, Wu[e]), from four 3D tensor
// maps; Wg[e] and Wu[e] are (D, F), so a row of the box is one output
// column running along F: a K-major B, no transpose. A warpgroup whose 64
// rows hold no valid row (tile_rows[t] <= 64) computes nothing and stores
// zeros; a tile with no valid row stores zeros and loads nothing. Rows
// past the valid count come out exactly 0; the fp32 sum is rounded to
// bf16 once, and two launches are bit-equal (no atomics). At the training
// shape (4096 rows in N_pad 5120, D 4096, F 14336) it is bound by
// operations: 962 GFLOP, 0.973 ms at 989 TFLOP/s. Per block (ptxas -v,
// build/kernels/grouped_gemm_bwd-*.log): 156 registers, no spills,
// 197,696 B of shared memory. Left for later: a persistent grid and
// thread-block clusters (tiles of one expert sharing Wg[e] through L2).
//
// dh (#5) and wgrad (#7), the simple design: the tiles and the two-stage
// cp.async pipeline of grouped_gemm.cu's tile loop (64-row blocks, 128
// output columns, 32-deep slabs, 8 warps of 32 x 32, WMMA bf16 16x16x16
// into fp32). Wd, read transposed in dh, is staged as [columns][32-slab]
// and fed to WMMA as col-major B, so no transpose is ever materialised.
// The SwiGLU backward runs elementwise on the three accumulator fragments
// (same type, same element mapping) before three masked fp32 staging
// passes store bf16. No wgmma, TMA or persistence yet; both are to move
// onto sm90_gemm.cuh's mainloop.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

#include "sm90_gemm.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_TILE = 128;  // metadata granularity (sorted-buffer alignment)
constexpr int BM = 64;         // rows (or wgrad output rows) per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction slab
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns), 32x32 each
constexpr int A_LD = BK + 8;   // [BM][BK] row-major A slabs
constexpr int B_LD = BN + 8;   // [BK][BN] row-major B slabs
constexpr int T_LD = BK + 8;   // [BN][BK] slabs read as col-major B (W^T)
constexpr int W_LD = BM + 8;   // [BK][BM] wgrad A slabs read as col-major A
constexpr int C_LD = BN + 4;   // fp32 epilogue staging

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0, 0, 0, 0);
}

// rows of this 64-row half tile that are valid, in [0, BM]
__device__ __forceinline__ int half_tile_valid(const int* tile_rows, int sub) {
  int valid = tile_rows[sub / (ROW_TILE / BM)] - (sub % (ROW_TILE / BM)) * BM;
  return valid < 0 ? 0 : (valid > BM ? BM : valid);
}

// BM x BN bf16 zeros at out[row0.., n0..] (row stride ld)
__device__ __forceinline__ void store_zeros(bf16* out, int row0, int n0, int ld) {
  for (int c = threadIdx.x; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
    *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * ld + n0 + col) = make_uint4(0, 0, 0, 0);
  }
}

// Stage the warp's 2x2 fragments through ctile and store BM x BN bf16 at
// out[row0.., n0..]; rows >= valid are written as zeros.
__device__ __forceinline__ void store_tile(Acc (&acc)[2][2], float* ctile, bf16* out, int row0,
                                           int n0, int ld, int valid) {
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  __syncthreads();  // ctile free (pipe consumed / previous output stored)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&ctile[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int c = threadIdx.x; c < BM * BN / 2; c += THREADS) {
    const int r = c / (BN / 2), col = (c % (BN / 2)) * 2;
    float v0 = 0.0f, v1 = 0.0f;
    if (r < valid) {
      v0 = ctile[r * C_LD + col];
      v1 = ctile[r * C_LD + col + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * ld + n0 + col) =
        __floats2bfloat162_rn(v0, v1);
  }
}

__device__ __forceinline__ void fill(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

// ---------------------------------------------------------------------------
// #5 dh: one block per (64-row half tile, 128 F columns), contraction over D
// ---------------------------------------------------------------------------

struct DhStage {
  bf16 x[BM * A_LD];
  bf16 dy[BM * A_LD];
  bf16 wg[BK * B_LD];
  bf16 wu[BK * B_LD];
  bf16 wd[BN * T_LD];  // Wd[e][f0 + n][k0 + k]: col-major B of dy @ Wd^T
};
constexpr int DH_SMEM = 2 * (int)sizeof(DhStage) > BM * C_LD * 4 ? 2 * (int)sizeof(DhStage) : BM * C_LD * 4;

__global__ void __launch_bounds__(THREADS)
bwd_dh_kernel(const bf16* __restrict__ X, const bf16* __restrict__ DY, const bf16* __restrict__ WG,
              const bf16* __restrict__ WU, const bf16* __restrict__ WD, const int* __restrict__ tile_group,
              const int* __restrict__ tile_rows, bf16* __restrict__ H, bf16* __restrict__ DG,
              bf16* __restrict__ DU, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DhStage* st = reinterpret_cast<DhStage*>(smem_raw);
  float* ctile = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int sub = blockIdx.x;
  const int row0 = sub * BM;
  const int n0 = blockIdx.y * BN;
  const int valid = half_tile_valid(tile_rows, sub);
  if (valid == 0) {
    store_zeros(H, row0, n0, F);
    store_zeros(DG, row0, n0, F);
    store_zeros(DU, row0, n0, F);
    return;
  }
  const int e = tile_group[sub / (ROW_TILE / BM)];
  const bf16* Xb = X + (size_t)row0 * D;
  const bf16* DYb = DY + (size_t)row0 * D;
  const bf16* WGb = WG + (size_t)e * D * F + n0;
  const bf16* WUb = WU + (size_t)e * D * F + n0;
  const bf16* WDb = WD + ((size_t)e * F + n0) * D;

  auto load_stage = [&](int s, int k0) {
    {  // x, dy slabs: BM x BK, one 16-byte chunk per thread each
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      cp_async16(&st[s].x[r * A_LD + c], Xb + (size_t)r * D + k0 + c);
      cp_async16(&st[s].dy[r * A_LD + c], DYb + (size_t)r * D + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int ch = tid + i * THREADS;
      {  // Wg, Wu slabs: BK rows of BN columns
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        cp_async16(&st[s].wg[r * B_LD + c], WGb + (size_t)(k0 + r) * F + c);
        cp_async16(&st[s].wu[r * B_LD + c], WUb + (size_t)(k0 + r) * F + c);
      }
      {  // Wd slab: BN rows (f) of BK (d)
        const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
        cp_async16(&st[s].wd[r * T_LD + c], WDb + (size_t)r * D + k0 + c);
      }
    }
  };

  const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
  Acc g[2][2], u[2][2], dh[2][2];
  fill(g);
  fill(u);
  fill(dh);

  const int nk = D / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const DhStage& S = st[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ax[2], ad[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ax[i], &S.x[(wm * 32 + i * 16) * A_LD + kk], A_LD);
        wmma::load_matrix_sync(ad[i], &S.dy[(wm * 32 + i * 16) * A_LD + kk], A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bg, bu;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bd;
        wmma::load_matrix_sync(bg, &S.wg[kk * B_LD + n], B_LD);
        wmma::load_matrix_sync(bu, &S.wu[kk * B_LD + n], B_LD);
        wmma::load_matrix_sync(bd, &S.wd[n * T_LD + kk], T_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(g[i][j], ax[i], bg, g[i][j]);
          wmma::mma_sync(u[i][j], ax[i], bu, u[i][j]);
          wmma::mma_sync(dh[i][j], ad[i], bd, dh[i][j]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // SwiGLU backward in fp32, elementwise on the fragments: g <- h, u <- dg, dh <- du
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      for (int t = 0; t < g[i][j].num_elements; ++t) {
        const float gv = g[i][j].x[t], uv = u[i][j].x[t], dv = dh[i][j].x[t];
        const float sig = 1.0f / (1.0f + expf(-gv));
        const float silu = gv * sig;
        const float dsilu = sig * (1.0f + gv * (1.0f - sig));
        g[i][j].x[t] = silu * uv;
        u[i][j].x[t] = dv * uv * dsilu;
        dh[i][j].x[t] = dv * silu;
      }
  store_tile(g, ctile, H, row0, n0, F, valid);
  store_tile(u, ctile, DG, row0, n0, F, valid);
  store_tile(dh, ctile, DU, row0, n0, F, valid);
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

// The weights' expert count is not an argument: tile_group names the expert
// of each tile, so the weight maps span MAX_EXPERTS experts and no box is
// ever asked past the last real one.
constexpr uint64_t MAX_EXPERTS = 1 << 16;

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
// #7 wgrad: one block per (expert, 64 output rows, 128 output columns),
// contraction over that expert's rows. NB = 2: A = x (cols over D),
// B = dg, du (cols over F) -> dWg, dWu; NB = 1: A = h (cols over F),
// B = dy (cols over D) -> dWd.
// ---------------------------------------------------------------------------

template <int NB>
struct WgStage {
  bf16 a[BK * W_LD];      // rows r of A, BM columns: col-major A of A^T
  bf16 b[NB][BK * B_LD];  // rows r of B, BN columns: row-major B
};
template <int NB>
constexpr int wg_smem() {
  return 2 * (int)sizeof(WgStage<NB>) > BM * C_LD * 4 ? 2 * (int)sizeof(WgStage<NB>) : BM * C_LD * 4;
}

template <int NB>
__global__ void __launch_bounds__(THREADS)
bwd_wgrad_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B0,
                 const bf16* __restrict__ B1, int ldb, const int* __restrict__ row_start,
                 const int* __restrict__ rows, bf16* __restrict__ O0, bf16* __restrict__ O1, int M,
                 int N) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  WgStage<NB>* st = reinterpret_cast<WgStage<NB>*>(smem_raw);
  float* ctile = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int start = row_start[e];
  const int count = rows[e];
  const bf16* Bs[2] = {B0, B1};

  auto load_stage = [&](int s, int k0) {
    {  // A slab: BK rows x BM columns, one chunk per thread
      const int r = tid / (BM / 8), c = (tid % (BM / 8)) * 8;
      bf16* dst = &st[s].a[r * W_LD + c];
      if (k0 + r < count)
        cp_async16(dst, A + (size_t)(start + k0 + r) * lda + m0 + c);
      else
        zero16(dst);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
        const int ch = tid + i * THREADS;
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        bf16* dst = &st[s].b[nb][r * B_LD + c];
        if (k0 + r < count)
          cp_async16(dst, Bs[nb] + (size_t)(start + k0 + r) * ldb + n0 + c);
        else
          zero16(dst);
      }
    }
  };

  const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
  Acc acc[NB][2][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) fill(acc[nb]);

  const int nk = (count + BK - 1) / BK;
  if (nk > 0) {
    load_stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const WgStage<NB>& S = st[kt & 1];
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], &S.a[kk * W_LD + wm * 32 + i * 16], W_LD);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, &S.b[nb][kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[nb][i][j], af[i], bfr, acc[nb][i][j]);
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<0>();
  }
  bf16* Os[2] = {O0, O1};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    store_tile(acc[nb], ctile, Os[nb] + (size_t)e * M * N, m0, n0, N, BM);
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int grouped_bwd_dh(const void* xs, const void* dy, const void* w_gate, const void* w_up,
                              const void* w_down, const int* tile_group, const int* tile_rows, void* h,
                              void* dg, void* du, int n_pad, int d, int f, void* stream) {
  int err = set_smem(bwd_dh_kernel, DH_SMEM);
  if (err) return err;
  dim3 grid(n_pad / BM, f / BN);
  bwd_dh_kernel<<<grid, THREADS, DH_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)xs, (const bf16*)dy, (const bf16*)w_gate, (const bf16*)w_up, (const bf16*)w_down,
      tile_group, tile_rows, (bf16*)h, (bf16*)dg, (bf16*)du, d, f);
  return (int)cudaGetLastError();
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

// Both wgrad grids on the stream: (dWg, dWu) then dWd. row_start/rows (E,)
// int32: each expert's first row in the aligned buffer and its valid rows.
extern "C" int grouped_bwd_wgrad(const void* xs, const void* dy, const void* h, const void* dg,
                                 const void* du, const int* row_start, const int* rows, void* dwg,
                                 void* dwu, void* dwd, int e, int d, int f, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = set_smem(bwd_wgrad_kernel<2>, wg_smem<2>());
  if (err) return err;
  err = set_smem(bwd_wgrad_kernel<1>, wg_smem<1>());
  if (err) return err;
  bwd_wgrad_kernel<2><<<dim3(d / BM, f / BN, e), THREADS, wg_smem<2>(), s>>>(
      (const bf16*)xs, d, (const bf16*)dg, (const bf16*)du, f, row_start, rows, (bf16*)dwg, (bf16*)dwu,
      d, f);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_wgrad_kernel<1><<<dim3(f / BM, d / BN, e), THREADS, wg_smem<1>(), s>>>(
      (const bf16*)h, f, (const bf16*)dy, (const bf16*)dy, d, row_start, rows, (bf16*)dwd, (bf16*)dwd, f,
      d);
  return (int)cudaGetLastError();
}
