// Flash-attention forward (causal / sliding window, GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py,
// flash_attention -> _fa_call -> _fa_kernel.
//
// q (B, Sq, H, d), k/v (B, Sk, KV, d) bf16 in the model's own layout; out
// (B, Sq, H, d) bf16 and lse (B*H, Sq) fp32. Positions are implicit and
// right-aligned: query i sits at i + Sk - Sq. Masked scores are -1e30 as
// in the TPU kernel; a row's stats m, l and its accumulator stay fp32.
//
// What bounds it on an H100: at prefill lengths (16..512) with d = 128 the
// inputs are small (q, k, v, out: ~0.5 MB per 64 queries of 32 heads) and
// the causal work is 2*2*d*S^2/2 FLOP per head, so the kernel sits near the
// ridge; at these sizes it is bound by latency and occupancy more than by
// either roof.
//
// What this simple design does about it: one block of 4 warps per (64-query
// tile, batch x head); each warp owns 16 query rows. The block reads its KV
// head h / (H/KV) in place (no GQA copy), walks 64-key tiles from the first
// one the window reaches to the last one causality allows (fully masked
// tiles are never loaded), masks the ragged edge (keys >= Sk, queries >= Sq)
// itself, and computes S = Q K^T and P V with WMMA bf16 16x16x16 in fp32.
// The online softmax runs in registers with two lanes per row; scores and
// P V partials pass through a per-warp fp32 staging area in shared memory
// because WMMA does not expose its fragment layout. The probabilities are
// rounded to bf16 before P V, as in the TPU kernel. No double buffering,
// wgmma or TMA yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile
constexpr int THREADS = 128; // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Smem {
  static constexpr int QK_LD = HD + 8;
  static constexpr int S_LD = BKV + 4;
  static constexpr int P_LD = BKV + 8;
  static constexpr int O_LD = HD + 4;
  static constexpr int SCR = 16 * (O_LD > S_LD ? O_LD : S_LD);  // floats per warp
  bf16 q[BQ * QK_LD];
  bf16 k[BKV * QK_LD];
  bf16 v[BKV * QK_LD];
  bf16 p[BQ * P_LD];
  float scratch[THREADS / 32][SCR];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ Kg, const bf16* __restrict__ V,
                 bf16* __restrict__ O, float* __restrict__ LSE,
                 int Sq, int Sk, int H, int KV, float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  constexpr int CH = HD / 8;  // 16-byte chunks per row

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    bf16* dst = &sm.q[r * S::QK_LD + col];
    if (q0 + r < Sq)
      cp_async16(dst, Q + ((size_t)(b * Sq + q0 + r) * H + h) * HD + col);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();  // completes with the first K/V tile's wait

  // key tiles some row of this block can see
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;

  const int r_loc = lane / 2, half = lane % 2;  // two lanes per query row
  const int qrow = q0 + warp * 16 + r_loc;
  const int qpos = qrow + q_offset;
  float m = NEG_INF, l = 0.0f;
  float o[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) o[c] = 0.0f;
  float* scr = sm.scratch[warp];

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      bf16* dk = &sm.k[r * S::QK_LD + col];
      bf16* dv = &sm.v[r * S::QK_LD + col];
      if (k0 + r < Sk) {
        const size_t off = ((size_t)(b * Sk + k0 + r) * KV + kvh) * HD + col;
        cp_async16(dk, Kg + off);
        cp_async16(dv, V + off);
      } else {
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(sacc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, &sm.q[warp * 16 * S::QK_LD + kk], S::QK_LD);
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;  // K^T
        wmma::load_matrix_sync(kb, &sm.k[j * 16 * S::QK_LD + kk], S::QK_LD);
        wmma::mma_sync(sacc[j], qa, kb, sacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j)
      wmma::store_matrix_sync(&scr[j * 16], sacc[j], S::S_LD, wmma::mem_row_major);
    __syncwarp();

    // online softmax over this lane's half row
    const int cb = half * (BKV / 2);
    float sc[BKV / 2];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const int key = k0 + cb + c;
      const bool ok = key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
      sc[c] = ok ? scr[r_loc * S::S_LD + cb + c] * scale : NEG_INF;
      mx = fmaxf(mx, sc[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float rs = 0.0f;
    bf16* prow = &sm.p[(warp * 16 + r_loc) * S::P_LD + cb];
#pragma unroll
    for (int c = 0; c < BKV / 2; ++c) {
      const float p = expf(sc[c] - m_new);
      rs += p;
      prow[c] = __float2bfloat16(p);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();  // P written, scores read: the staging area is free

    // P V for this warp's rows -> staging, then rescale-and-add per lane
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BKV / 16];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wmma::load_matrix_sync(pa[kk], &sm.p[warp * 16 * S::P_LD + kk * 16], S::P_LD);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::fill_fragment(oacc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, &sm.v[kk * 16 * S::QK_LD + n * 16], S::QK_LD);
        wmma::mma_sync(oacc, pa[kk], vb, oacc);
      }
      wmma::store_matrix_sync(&scr[n * 16], oacc, S::O_LD, wmma::mem_row_major);
    }
    __syncwarp();
    const float* orow = &scr[r_loc * S::O_LD + half * (HD / 2)];
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) o[c] = o[c] * corr + orow[c];
    __syncwarp();
  }
  cp_async_wait_all();

  if (qrow < Sq) {
    const float ls = fmaxf(l, 1e-30f);
    bf16* dst = O + ((size_t)(b * Sq + qrow) * H + h) * HD + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(o[c] / ls, o[c + 1] / ls);
    if (half == 0) LSE[(size_t)bh * Sq + qrow] = m + logf(ls);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq, int Sk,
           int H, int KV, float scale, int causal, int window, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<HD>);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)lse, Sq, Sk, H, KV, scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                         int Sq, int Sk, int H, int KV, int d, float scale, int causal, int window,
                         void* stream) {
  if (d == 128)
    return launch<128>(q, k, v, out, lse, B, Sq, Sk, H, KV, scale, causal, window, (cudaStream_t)stream);
  if (d == 64)
    return launch<64>(q, k, v, out, lse, B, Sq, Sk, H, KV, scale, causal, window, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
