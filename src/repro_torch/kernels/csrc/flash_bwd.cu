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
// score gives. Both kernels walk only the tiles that causality and the
// window leave some live pair in, with the same bounds as the forward.
//
// Rounding: the TPU kernel keeps p and ds in fp32 for its products. Here
// s, dp, p and ds are computed in fp32, then p and ds are rounded to bf16 to
// feed the tensor cores (dq += ds K, dv += P^T dO, dk += dS^T Q); the sums
// stay fp32 and dq, dk, dv are rounded to bf16 once. The rounding of p and
// ds (relative 2^-9 each) is what the 2e-2 x max|plain| tolerance of the
// checks covers.
//
// What bounds it on an H100: at training shapes (S 2048, d 128, H 32/KV 8)
// the causal work is ~2.5x the forward's, 4 or 5 products of 2*d*pairs
// FLOP, against a few tens of MB of inputs: bound by operations.
//
// What this simple design does about it:
// * dq: one block of 4 warps per (64-query tile, batch x head); each warp
//   owns 16 query rows and keeps dq (16 x d) in WMMA fp32 accumulators across
//   all key tiles (no rescaling is needed in the backward). Q, dO, lse and
//   delta stay in shared memory; each key tile loads K and V once.
// * dk/dv: one block of 4 warps per (64-key tile, batch x KV head); each
//   warp owns 16 keys and keeps dk and dv (16 x d each) in accumulators
//   while the block walks the G query heads and their live q tiles, so no
//   GQA copy, no (B*H, Sk, d) staging and no atomics. It computes S^T = K Q^T
//   and dP^T = V dO^T directly, so P^T and dS^T are row-major A operands.
// Scores pass through a per-warp fp32 staging area because WMMA does not
// expose its fragment layout. No double buffering, wgmma or TMA yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // queries per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int ST_LD = 64 + 4; // fp32 staging of a 16 x 64 score block
constexpr int P_LD = 64 + 8;  // bf16 p / ds tiles

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBr;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBc;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;     // bf16 rows of q / dO / k / v
  static constexpr int O_LD = HD + 4;   // fp32 staging of a 16 x d result
  static constexpr int SCR = 2 * 16 * ST_LD > 16 * O_LD ? 2 * 16 * ST_LD : 16 * O_LD;
  bf16 q[BQ * LD];
  bf16 dout[BQ * LD];
  bf16 k[BKV * LD];
  bf16 v[BKV * LD];
  bf16 p[64 * P_LD];   // dq: ds (queries x keys); dkv: P^T (keys x queries)
  bf16 ds[64 * P_LD];  // dkv: dS^T
  float lse[BQ];
  float delta[BQ];
  float scratch[THREADS / 32][SCR];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 64 rows of d bf16 from a (B, S, NH, d) tensor: row r is (b, s0 + r, head);
// rows at or past S are zeros.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int b, int s0, int S, int NH,
                                          int head) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    bf16* d = dst + r * Smem<HD>::LD + col;
    if (s0 + r < S)
      cp_async16(d, src + ((size_t)(b * S + s0 + r) * NH + head) * HD + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// out (16 x 64, fp32 staging at scr, ld ST_LD) = A_rows (16 x HD, row-major
// at a) times the 64 rows of bt (read as col-major B: out = A bt^T)
template <int HD>
__device__ __forceinline__ void scores16(float* scr, const bf16* a, const bf16* bt) {
  constexpr int LD = Smem<HD>::LD;
  Acc acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc fb;
      wmma::load_matrix_sync(fb, bt + j * 16 * LD + kk, LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::store_matrix_sync(scr + j * 16, acc[j], ST_LD, wmma::mem_row_major);
}

// Stage the warp's 16 x HD accumulators and write bf16 row r_loc's half
// `half` to dst (row-major, HD contiguous) if `live`.
template <int HD>
__device__ __forceinline__ void write_rows(Acc (&acc)[HD / 16], float* scr, bf16* dst, bool live,
                                           int r_loc, int half) {
  constexpr int O_LD = Smem<HD>::O_LD;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::store_matrix_sync(scr + n * 16, acc[n], O_LD, wmma::mem_row_major);
  __syncwarp();
  if (live) {
    const float* row = scr + r_loc * O_LD + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + half * (HD / 2) + c) = __floats2bfloat162_rn(row[c], row[c + 1]);
  }
  __syncwarp();
}

__device__ __forceinline__ bool live_pair(int key, int qpos, int Sk, bool qvalid, int causal, int window) {
  return qvalid && key < Sk && (!causal || key <= qpos) && (window <= 0 || key > qpos - window);
}

// ---------------------------------------------------------------------------
// #17 dq
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ Kg, const bf16* __restrict__ V,
                    const bf16* __restrict__ DO, const float* __restrict__ LSE,
                    const float* __restrict__ DELTA, bf16* __restrict__ DQ, int Sq, int Sk, int H, int KV,
                    float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q_offset = Sk - Sq;

  load_rows<HD>(sm.q, Q, b, q0, Sq, H, h);
  load_rows<HD>(sm.dout, DO, b, q0, Sq, H, h);
  if (tid < BQ) {
    const bool ok = q0 + tid < Sq;
    sm.lse[tid] = ok ? LSE[(size_t)bh * Sq + q0 + tid] : 0.0f;
    sm.delta[tid] = ok ? DELTA[(size_t)bh * Sq + q0 + tid] : 0.0f;
  }
  cp_async_commit();

  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;

  const int r_loc = lane / 2, half = lane % 2;
  const int qrow = q0 + warp * 16 + r_loc;
  const int qpos = qrow + q_offset;
  float* scr = sm.scratch[warp];
  Acc dq[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(dq[n], 0.0f);

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD>(sm.k, Kg, b, k0, Sk, KV, kvh);
    load_rows<HD>(sm.v, V, b, k0, Sk, KV, kvh);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    scores16<HD>(scr, &sm.q[warp * 16 * S::LD], sm.k);                 // S = Q K^T
    scores16<HD>(scr + 16 * ST_LD, &sm.dout[warp * 16 * S::LD], sm.v); // dP = dO V^T
    __syncwarp();
    const float lse = sm.lse[warp * 16 + r_loc], delta = sm.delta[warp * 16 + r_loc];
    bf16* dsrow = &sm.p[(warp * 16 + r_loc) * P_LD + half * 32];
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const bool ok = live_pair(k0 + col, qpos, Sk, qrow < Sq, causal, window);
      const float p = ok ? expf(scr[r_loc * ST_LD + col] * scale - lse) : 0.0f;
      const float dp = scr[16 * ST_LD + r_loc * ST_LD + col];
      dsrow[c] = __float2bfloat16(p * (dp - delta) * scale);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      FragA da;
      wmma::load_matrix_sync(da, &sm.p[warp * 16 * P_LD + kk * 16], P_LD);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        FragBr kb;
        wmma::load_matrix_sync(kb, &sm.k[kk * 16 * S::LD + n * 16], S::LD);
        wmma::mma_sync(dq[n], da, kb, dq[n]);
      }
    }
  }
  cp_async_wait_all();
  write_rows<HD>(dq, scr, DQ + ((size_t)(b * Sq + qrow) * H + h) * HD, qrow < Sq, r_loc, half);
}

// ---------------------------------------------------------------------------
// #18 dk, dv
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ Kg, const bf16* __restrict__ V,
                     const bf16* __restrict__ DO, const float* __restrict__ LSE,
                     const float* __restrict__ DELTA, bf16* __restrict__ DK, bf16* __restrict__ DV, int Sq,
                     int Sk, int H, int KV, float scale, int causal, int window) {
  using S = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BKV;
  const int bkv = blockIdx.y;
  const int b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const int q_offset = Sk - Sq;

  load_rows<HD>(sm.k, Kg, b, k0, Sk, KV, kvh);
  load_rows<HD>(sm.v, V, b, k0, Sk, KV, kvh);
  cp_async_commit();

  // query rows that see some key of this tile
  const int k_last = min(k0 + BKV, Sk) - 1;
  const int qi_begin = causal ? max(0, k0 - q_offset) : 0;
  const int qi_end = window > 0 ? min(Sq, k_last + window - q_offset) : Sq;  // exclusive
  const int t_begin = qi_begin / BQ;
  const int t_end = qi_begin < qi_end ? (qi_end + BQ - 1) / BQ : t_begin;

  const int r_loc = lane / 2, half = lane % 2;
  const int key = k0 + warp * 16 + r_loc;
  float* scr = sm.scratch[warp];
  Acc dk[HD / 16], dv[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.0f);
    wmma::fill_fragment(dv[n], 0.0f);
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int bh = b * H + h;
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_rows<HD>(sm.q, Q, b, q0, Sq, H, h);
      load_rows<HD>(sm.dout, DO, b, q0, Sq, H, h);
      if (tid < BQ) {
        const bool ok = q0 + tid < Sq;
        sm.lse[tid] = ok ? LSE[(size_t)bh * Sq + q0 + tid] : 0.0f;
        sm.delta[tid] = ok ? DELTA[(size_t)bh * Sq + q0 + tid] : 0.0f;
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();

      scores16<HD>(scr, &sm.k[warp * 16 * S::LD], sm.q);                 // S^T = K Q^T
      scores16<HD>(scr + 16 * ST_LD, &sm.v[warp * 16 * S::LD], sm.dout); // dP^T = V dO^T
      __syncwarp();
      bf16* prow = &sm.p[(warp * 16 + r_loc) * P_LD + half * 32];
      bf16* dsrow = &sm.ds[(warp * 16 + r_loc) * P_LD + half * 32];
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c;
        const int qi = q0 + col;
        const bool ok = live_pair(key, qi + q_offset, Sk, qi < Sq, causal, window);
        const float p = ok ? expf(scr[r_loc * ST_LD + col] * scale - sm.lse[col]) : 0.0f;
        const float dp = scr[16 * ST_LD + r_loc * ST_LD + col];
        prow[c] = __float2bfloat16(p);
        dsrow[c] = __float2bfloat16(p * (dp - sm.delta[col]) * scale);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        FragA pa, da;
        wmma::load_matrix_sync(pa, &sm.p[warp * 16 * P_LD + kk * 16], P_LD);
        wmma::load_matrix_sync(da, &sm.ds[warp * 16 * P_LD + kk * 16], P_LD);
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
          FragBr ob, qb;
          wmma::load_matrix_sync(ob, &sm.dout[kk * 16 * S::LD + n * 16], S::LD);
          wmma::mma_sync(dv[n], pa, ob, dv[n]);
          wmma::load_matrix_sync(qb, &sm.q[kk * 16 * S::LD + n * 16], S::LD);
          wmma::mma_sync(dk[n], da, qb, dk[n]);
        }
      }
    }
  }
  cp_async_wait_all();
  const size_t off = ((size_t)(b * Sk + key) * KV + kvh) * HD;
  write_rows<HD>(dk, scr, DK + off, key < Sk, r_loc, half);
  write_rows<HD>(dv, scr, DV + off, key < Sk, r_loc, half);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV, float scale, int causal,
           int window, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<HD>);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (dq) {
    flash_bwd_dq_kernel<HD><<<dim3((Sq + BQ - 1) / BQ, B * H), THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (bf16*)dq, Sq, Sk, H, KV, scale, causal, window);
  } else {
    flash_bwd_dkv_kernel<HD><<<dim3((Sk + BKV - 1) / BKV, B * KV), THREADS, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk, H, KV, scale, causal, window);
  }
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
