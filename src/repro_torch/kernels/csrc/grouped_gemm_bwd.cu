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
// What bounds it on an H100: at training shapes (2048 tokens x top-2 =
// 4096 rows over 8 experts, D 4096, F 14336) every pass is a GEMM of
// ~0.5-1 TFLOP against ~1 GB of weights and activations, far on the
// tensor-core side of the ridge: bound by operations.
//
// What this simple design does about it: the tiles and the two-stage
// cp.async pipeline of grouped_gemm.cu (64-row blocks, 128 output columns,
// 32-deep slabs, 8 warps of 32 x 32, WMMA bf16 16x16x16 into fp32).
// Weights read transposed (Wd in dh, Wg/Wu in dx) are staged as [columns]
// [32-slab] and fed to WMMA as col-major B, so no transpose is ever
// materialised. The SwiGLU backward runs elementwise on the three
// accumulator fragments (same type, same element mapping) before three
// masked fp32 staging passes store bf16. No wgmma, TMA or persistence yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

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
// #6 dx: one block per (64-row half tile, 128 D columns), contraction over F
// ---------------------------------------------------------------------------

struct DxStage {
  bf16 dg[BM * A_LD];
  bf16 du[BM * A_LD];
  bf16 wg[BN * T_LD];  // Wg[e][d0 + n][k0 + k]: col-major B of dg @ Wg^T
  bf16 wu[BN * T_LD];
};
constexpr int DX_SMEM = 2 * (int)sizeof(DxStage) > BM * C_LD * 4 ? 2 * (int)sizeof(DxStage) : BM * C_LD * 4;

__global__ void __launch_bounds__(THREADS)
bwd_dx_kernel(const bf16* __restrict__ DGm, const bf16* __restrict__ DUm, const bf16* __restrict__ WG,
              const bf16* __restrict__ WU, const int* __restrict__ tile_group,
              const int* __restrict__ tile_rows, bf16* __restrict__ DX, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DxStage* st = reinterpret_cast<DxStage*>(smem_raw);
  float* ctile = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int sub = blockIdx.x;
  const int row0 = sub * BM;
  const int n0 = blockIdx.y * BN;
  const int valid = half_tile_valid(tile_rows, sub);
  if (valid == 0) {
    store_zeros(DX, row0, n0, D);
    return;
  }
  const int e = tile_group[sub / (ROW_TILE / BM)];
  const bf16* DGb = DGm + (size_t)row0 * F;
  const bf16* DUb = DUm + (size_t)row0 * F;
  const bf16* WGb = WG + ((size_t)e * D + n0) * F;
  const bf16* WUb = WU + ((size_t)e * D + n0) * F;

  auto load_stage = [&](int s, int k0) {
    {
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      cp_async16(&st[s].dg[r * A_LD + c], DGb + (size_t)r * F + k0 + c);
      cp_async16(&st[s].du[r * A_LD + c], DUb + (size_t)r * F + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
      const int ch = tid + i * THREADS;
      const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
      cp_async16(&st[s].wg[r * T_LD + c], WGb + (size_t)r * F + k0 + c);
      cp_async16(&st[s].wu[r * T_LD + c], WUb + (size_t)r * F + k0 + c);
    }
  };

  const int warp = tid / 32, wm = warp / 4, wn = warp % 4;
  Acc acc[2][2];
  fill(acc);
  const int nk = F / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const DxStage& S = st[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ag[2], au[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(ag[i], &S.dg[(wm * 32 + i * 16) * A_LD + kk], A_LD);
        wmma::load_matrix_sync(au[i], &S.du[(wm * 32 + i * 16) * A_LD + kk], A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bg, bu;
        wmma::load_matrix_sync(bg, &S.wg[n * T_LD + kk], T_LD);
        wmma::load_matrix_sync(bu, &S.wu[n * T_LD + kk], T_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::mma_sync(acc[i][j], ag[i], bg, acc[i][j]);
          wmma::mma_sync(acc[i][j], au[i], bu, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  store_tile(acc, ctile, DX, row0, n0, D, valid);
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
  int err = set_smem(bwd_dx_kernel, DX_SMEM);
  if (err) return err;
  dim3 grid(n_pad / BM, d / BN);
  bwd_dx_kernel<<<grid, THREADS, DX_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)dg, (const bf16*)du, (const bf16*)w_gate, (const bf16*)w_up, tile_group, tile_rows,
      (bf16*)dx, d, f);
  return (int)cudaGetLastError();
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
