// Grouped expert GEMM with fused SwiGLU over the sorted (dropless) layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/expert_gemm.py,
// _grouped_fwd_impl: _grouped_gate_up_kernel (h = silu(x@Wg[e]) * (x@Wu[e]))
// and _grouped_down_kernel (y = h@Wd[e]).
//
// Input: an expert-sorted (N_pad, D) bf16 buffer whose expert regions are
// aligned to 128 rows; per 128-row tile, tile_group[t] is its expert and
// tile_rows[t] its valid rows (computed on the device by the wrapper, as
// group_tiling does). Rows past the valid count come out zero; a block
// whose rows are all empty writes zeros and does no product.
//
// What bounds it on an H100: at decode (a few rows per expert) the kernel
// must stream each touched expert's weights once, 3*D*F*2 bytes (352 MB at
// llama3-e8t2 widths): it is bound by bytes, ~105 us per expert at
// 3.35 TB/s. At prefill (hundreds of rows per expert) the products reach
// the tensor-core side of the ridge (~295 FLOP/byte).
//
// What this simple design does about it: one block per (64-row half tile,
// 128 output columns); blocks that share a weight column block are launched
// next to each other (row sub-tile is the fastest grid dim) so the second
// reads the weights from L2. The contraction loop streams 32-deep slabs of
// x and of the weights through shared memory with a two-stage cp.async
// pipeline (16-byte copies, coalesced 256-byte weight rows) and multiplies
// them with WMMA bf16 16x16x16 into fp32 accumulators. The gate/up kernel
// keeps both accumulators and applies silu(g)*u elementwise on the fragments
// (same fragment type, same element mapping) before one fp32 staging pass
// through shared memory masks the rows and stores bf16. Half tiles past the
// valid rows skip the whole product, which halves decode's wasted MMA work.
// No wgmma, TMA or warp specialisation yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int ROW_TILE = 128;  // metadata granularity (sorted-buffer alignment)
constexpr int BM = 64;         // rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction slab
constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (columns), 32x32 each
constexpr int A_LD = BK + 8;   // padded smem strides (bank spread, 32-byte
constexpr int B_LD = BN + 8;   // aligned WMMA fragment pointers)
constexpr int C_LD = BN + 4;

template <int NB>
struct Pipe {
  bf16 a[2][BM * A_LD];
  bf16 b[2][NB][BK * B_LD];
};

template <int NB>
__host__ __device__ constexpr int smem_bytes() {
  return sizeof(Pipe<NB>) > BM * C_LD * sizeof(float) ? (int)sizeof(Pipe<NB>)
                                                       : (int)(BM * C_LD * sizeof(float));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// NB = 2: out = silu(A@W0[e]) * (A@W1[e]); NB = 1: out = A@W0[e].
// A (rows, K) bf16; W (E, K, N) bf16; out (rows, N) bf16.
template <int NB>
__global__ void __launch_bounds__(THREADS)
grouped_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W0, const bf16* __restrict__ W1,
               const int* __restrict__ tile_group, const int* __restrict__ tile_rows,
               bf16* __restrict__ out, int K, int N) {
  __shared__ __align__(128) unsigned char smem_raw[smem_bytes<NB>()];
  Pipe<NB>& pipe = *reinterpret_cast<Pipe<NB>*>(smem_raw);
  float* ctile = reinterpret_cast<float*>(smem_raw);  // epilogue reuses the pipe

  const int tid = threadIdx.x;
  const int sub = blockIdx.x;
  const int tile = sub / (ROW_TILE / BM);
  const int row0 = sub * BM;
  const int n0 = blockIdx.y * BN;
  int valid = tile_rows[tile] - (sub % (ROW_TILE / BM)) * BM;
  valid = valid < 0 ? 0 : (valid > BM ? BM : valid);

  if (valid == 0) {  // empty half tile: zeros, no product
    for (int c = tid; c < BM * BN / 8; c += THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * N + n0 + col) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const size_t e_off = (size_t)tile_group[tile] * K * N + n0;
  const bf16* Ab = A + (size_t)row0 * K;
  const bf16* Wb[2] = {W0 + e_off, W1 + e_off};

  auto load_stage = [&](int stage, int k0) {
    {  // A slab: BM x BK = one 16-byte chunk per thread
      const int r = tid / (BK / 8), c = (tid % (BK / 8)) * 8;
      cp_async16(&pipe.a[stage][r * A_LD + c], Ab + (size_t)r * K + k0 + c);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
        const int ch = tid + i * THREADS;
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        cp_async16(&pipe.b[stage][nb][r * B_LD + c], Wb[nb] + (size_t)(k0 + r) * N + c);
      }
    }
  };

  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[nb][i][j], 0.0f);

  const int nk = K / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // slab kt has landed
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &pipe.a[st][(wm * 32 + i * 16) * A_LD + kk], A_LD);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
          wmma::load_matrix_sync(bfr, &pipe.b[st][nb][kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[nb][i][j], af[i], bfr, acc[nb][i][j]);
        }
      }
    }
    __syncthreads();  // slab kt consumed before its buffer is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if constexpr (NB == 2) {
        for (int t = 0; t < acc[0][i][j].num_elements; ++t) {
          const float g = acc[0][i][j].x[t], u = acc[NB - 1][i][j].x[t];
          acc[0][i][j].x[t] = g / (1.0f + expf(-g)) * u;  // silu(g) * u in fp32
        }
      }
      wmma::store_matrix_sync(&ctile[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[0][i][j],
                              C_LD, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int c = tid; c < BM * BN / 2; c += THREADS) {
    const int r = c / (BN / 2), col = (c % (BN / 2)) * 2;
    float v0 = 0.0f, v1 = 0.0f;
    if (r < valid) {
      v0 = ctile[r * C_LD + col];
      v1 = ctile[r * C_LD + col + 1];
    }
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N + n0 + col) =
        __floats2bfloat162_rn(v0, v1);
  }
}

}  // namespace

extern "C" int grouped_gate_up(const void* xs, const void* w_gate, const void* w_up,
                               const int* tile_group, const int* tile_rows, void* h,
                               int n_pad, int d, int f, void* stream) {
  dim3 grid(n_pad / BM, f / BN);
  grouped_kernel<2><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)xs, (const bf16*)w_gate, (const bf16*)w_up, tile_group, tile_rows, (bf16*)h, d, f);
  return (int)cudaGetLastError();
}

extern "C" int grouped_down(const void* h, const void* w_down, const int* tile_group,
                            const int* tile_rows, void* y, int n_pad, int f, int d, void* stream) {
  dim3 grid(n_pad / BM, d / BN);
  grouped_kernel<1><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)h, (const bf16*)w_down, (const bf16*)w_down, tile_group, tile_rows, (bf16*)y, f, d);
  return (int)cudaGetLastError();
}
