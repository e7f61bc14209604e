// Paged-attention decode (one query token per sequence, GQA) for Hopper
// (sm_90a), for bf16 KV pages and for int8 KV pages with per-token scales.
//
// Replaces the TPU kernels of src/repro/kernels/paged_attention.py:
// paged_attention -> _pa_kernel (bf16 pages) and paged_attention_q8 ->
// _pa_kernel_q8 (int8 pages, dequantised in the tile).
//
// q (B, H, d) bf16; k/v pools (num_pages, ps, KV, d), bf16 or int8; for
// int8 the fp32 scale sidecars (num_pages, ps, KV, 1); block_table (B,
// maxP) int32, -1 = no page; seq_lens (B,) int32, the current token
// included; out (B, H, d) bf16. Logical key j of sequence b lives at
// pool[block_table[b, j / ps], j % ps]. A key at position p is live iff
// p < seq_lens[b] and, with a window, p > seq_lens[b] - 1 - window. A row
// with no live key (an idle slot) writes zeros.
//
// What bounds it on an H100: bytes. Each live KV page is read once per KV
// head and does 4*G*d FLOP per key against 2*d (bf16) or d + 4 (int8)
// bytes, far below the card's ~295 FLOP/byte ridge.
//
// What this simple design does about it: one block of 4 warps per (KV
// head, sequence), so each page of that head is read once for all G = H/KV
// query heads, as in the TPU kernel. The block walks block_table on the
// device and reads K and V straight from the pool (no gathered copy); the
// warps take pages in turn. Pages that are -1, start at or past seq_lens,
// or lie wholly below the window are skipped without being loaded (the
// TPU BlockSpec clamps the page id to 0 and loads it; this kernel never
// dereferences page -1). Within a page the lanes split d (coalesced row
// loads) and each score is reduced with warp shuffles; each warp keeps fp32
// m, l and acc for its G heads, updated once per KCH keys, and the warps
// merge through shared memory at the end. bf16: p is rounded to bf16 before
// P.V as in _pa_kernel. int8: the score is (q . k_i8) * k_scale * scale and
// v_scale is folded into p, all in fp32. No split over pages across blocks
// yet, so a small batch fills few SMs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 4;              // warps per block
constexpr int THREADS = NW * 32;
constexpr int GMAX = 8;            // most query heads per KV head
constexpr int KCH = 8;             // keys per online-softmax update
constexpr float NEG_INF = -1e30f;

template <int EPL>
__device__ __forceinline__ void load_row(const bf16* p, float (&o)[EPL]) {
#pragma unroll
  for (int i = 0; i < EPL; i += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    o[i] = f.x;
    o[i + 1] = f.y;
  }
}

template <int EPL>
__device__ __forceinline__ void load_row(const int8_t* p, float (&o)[EPL]) {
#pragma unroll
  for (int i = 0; i < EPL; i += 2) {
    const char2 c = *reinterpret_cast<const char2*>(p + i);
    o[i] = (float)c.x;
    o[i + 1] = (float)c.y;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename KT, int HD, bool Q8>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const bf16* __restrict__ Q, const KT* __restrict__ Kp,
                       const KT* __restrict__ Vp, const float* __restrict__ Ks,
                       const float* __restrict__ Vs, const int* __restrict__ BT,
                       const int* __restrict__ SL, bf16* __restrict__ O, int H, int KV,
                       int ps, int maxP, float scale, int window) {
  constexpr int EPL = HD / 32;  // elements of d per lane
  __shared__ float sm_m[NW][GMAX], sm_l[NW][GMAX];
  __shared__ float sm_acc[NW][GMAX][HD];

  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, h0 = kv * G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = SL[b];
  const int lo = window > 0 ? n - window : -1;  // live keys: lo <= pos < n

  float q[GMAX][EPL], m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = q[g][i] = 0.0f;
    if (g < G) load_row<EPL>(Q + ((size_t)b * H + h0 + g) * HD + lane * EPL, q[g]);
  }

  for (int j = warp; j < maxP; j += NW) {
    const int page = BT[(size_t)b * maxP + j];
    const int start = j * ps;
    if (page < 0 || start >= n || start + ps - 1 < lo) continue;  // never loaded
    const size_t row0 = (size_t)page * ps;
    for (int t0 = 0; t0 < ps; t0 += KCH) {
      float s[GMAX][KCH];
      bool ok[KCH];
#pragma unroll
      for (int t = 0; t < KCH; ++t) {
        const int pos = start + t0 + t;
        ok[t] = t0 + t < ps && pos < n && pos >= lo;  // the same for the whole warp
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[g][t] = NEG_INF;
        if (!ok[t]) continue;
        const size_t r = (row0 + t0 + t) * KV + kv;
        float kf[EPL];
        load_row<EPL>(Kp + r * HD + lane * EPL, kf);
        const float ks = Q8 ? Ks[r] * scale : scale;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            float part = 0.0f;
#pragma unroll
            for (int i = 0; i < EPL; ++i) part += q[g][i] * kf[i];
            s[g][t] = warp_sum(part) * ks;
          }
        }
      }
      // online softmax over these KCH keys; s becomes p
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          float mx = m[g];
#pragma unroll
          for (int t = 0; t < KCH; ++t) mx = fmaxf(mx, s[g][t]);
          const float corr = expf(m[g] - mx);
          float rs = 0.0f;
#pragma unroll
          for (int t = 0; t < KCH; ++t) {
            s[g][t] = ok[t] ? expf(s[g][t] - mx) : 0.0f;
            rs += s[g][t];
          }
          l[g] = l[g] * corr + rs;
          m[g] = mx;
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] *= corr;
        }
      }
#pragma unroll
      for (int t = 0; t < KCH; ++t) {
        if (!ok[t]) continue;
        const size_t r = (row0 + t0 + t) * KV + kv;
        float vf[EPL];
        load_row<EPL>(Vp + r * HD + lane * EPL, vf);
        const float vs = Q8 ? Vs[r] : 1.0f;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            // bf16: round p to the value type as _pa_kernel does; int8: fp32
            const float p = Q8 ? s[g][t] * vs : __bfloat162float(__float2bfloat16(s[g][t]));
#pragma unroll
            for (int i = 0; i < EPL; ++i) acc[g][i] += p * vf[i];
          }
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += THREADS) {
    const int g = idx / HD, c = idx % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][c] * f;
    }
    O[((size_t)b * H + h0 + g) * HD + c] = __float2bfloat16(L > 0.0f ? A / L : 0.0f);
  }
}

template <typename KT, int HD, bool Q8>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* bt, const void* sl, void* out, int B, int H, int KV, int ps, int maxP,
           float scale, int window, cudaStream_t stream) {
  dim3 grid(KV, B);
  paged_attention_kernel<KT, HD, Q8><<<grid, THREADS, 0, stream>>>(
      (const bf16*)q, (const KT*)k, (const KT*)v, (const float*)ks, (const float*)vs,
      (const int*)bt, (const int*)sl, (bf16*)out, H, KV, ps, maxP, scale, window);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int H, int KV, int ps, int maxP) {
  return B > 0 && KV > 0 && H % KV == 0 && H / KV <= GMAX && ps > 0 && maxP > 0;
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const void* block_table, const void* seq_lens, void* out,
                                    int B, int H, int KV, int d, int ps, int maxP, float scale,
                                    int window, void* stream) {
  if (!shapes_ok(B, H, KV, ps, maxP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<bf16, 128, false>(q, k_pool, v_pool, nullptr, nullptr, block_table, seq_lens,
                                    out, B, H, KV, ps, maxP, scale, window, s);
  if (d == 64)
    return launch<bf16, 64, false>(q, k_pool, v_pool, nullptr, nullptr, block_table, seq_lens,
                                   out, B, H, KV, ps, maxP, scale, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_attention_q8(const void* q, const void* k_pool, const void* v_pool,
                                  const void* k_scale, const void* v_scale,
                                  const void* block_table, const void* seq_lens, void* out, int B,
                                  int H, int KV, int d, int ps, int maxP, float scale, int window,
                                  void* stream) {
  if (!shapes_ok(B, H, KV, ps, maxP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch<int8_t, 128, true>(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                                     out, B, H, KV, ps, maxP, scale, window, s);
  if (d == 64)
    return launch<int8_t, 64, true>(q, k_pool, v_pool, k_scale, v_scale, block_table, seq_lens,
                                    out, B, H, KV, ps, maxP, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
