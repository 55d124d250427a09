// Flash-decode for Hopper (sm_90a), written by hand: one new query token per
// row against a contiguous KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode.py:131
// `_contig_kernel` -> `_decode_body` (:60), launched by `flash_decode`
// (:200). Per row b it computes softmax(q K^T * scale) V over the first
// kv_len[b] cache positions (kv_len == 0 gives exact zeros), optionally
// gated by a sliding window (kp > (kv_len - 1) - window). With num_splits > 1
// each split folds its slice of KV tiles into raw f32 (acc, m, l) partials,
// which the wrapper merges with online_softmax.merge_many + finalize.
//
// What bounds it: one query row per head does 4 D operations per cached
// position on 2 D elements of K and V, far below the card's operations per
// byte, so it is bound by device memory: bytes(K) + bytes(V).
//
// What the design does about that: one thread block per (split, kv head,
// batch) streams its K/V slice from device memory exactly once, and the
// whole GQA group of G = Hq / Hkv query heads (G = 4 for granite, 5 for
// qwen3; any G <= 8, no padding) shares every K/V tile it loads. Tiles past
// kv_len or outside the window are never loaded. Splits add parallel blocks
// when B * Hkv alone would leave SMs idle. The simple first version stages
// each tile in shared memory as f32; overlapping loads with compute
// (cp.async / TMA double buffering) is later work.
//
// The cache is read through a `Cache` type that maps (b, kv head, tile) to
// rows of K and V: `ContigCache` here; the paged variants of decode.py
// (`_paged_kernel`, `_paged_valid_kernel`) become a block-table `Cache` (plus
// a per-tile validity gate) in the same template.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKV = 128;        // cache rows per tile (kernels/decode.py TILE)
constexpr int NTHREADS = 128;   // one score column per thread
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;         // largest GQA group handled
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Contiguous cache [B, Hkv, S, D]: tile ik of (b, hk) is rows
// [ik * BKV, ik * BKV + BKV) of that head's slab.
template <typename T, int D>
struct ContigCache {
  const T* k; const T* v; int Hkv, S;
  __device__ size_t row0(int b, int hk, int ik) const {
    return ((size_t)(b * Hkv + hk) * S + (size_t)ik * BKV) * D;
  }
};

struct DecodeParams {
  const void* q;                 // [B, Hq, D]
  const int* kv_len;             // [B]
  void* o;                       // [B, Hq, D] (num_splits == 1) or null
  float* acc_part;               // [B, Hkv, ns, G, D] (num_splits > 1)
  float* m_part; float* l_part;  // [B, Hkv, ns, G]
  int Hq, Hkv, G, S, nk, ns, nj;
  float scale;
  int window;                    // <= 0: none
};

template <typename T, int D, typename Cache>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const DecodeParams p, const Cache cache) {
  constexpr int RGRP = NTHREADS / D;               // row groups in the P.V phase
  constexpr int RPT = (MAXG + RGRP - 1) / RGRP;    // rows per thread there
  extern __shared__ float smem[];
  float* sK = smem;                                // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);                  // [BKV][D]
  __shared__ float sQ[MAXG][D];
  __shared__ float sP[MAXG][BKV];
  __shared__ float sRed[NWARPS][MAXG];
  __shared__ float sM[MAXG], sL[MAXG], sAlpha[MAXG], sMsafe[MAXG];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = p.G;
  const int kv_len = min(p.kv_len[b], p.S);
  const int q_pos = kv_len - 1;                    // the query token's position

  const T* qg = static_cast<const T*>(p.q) + (size_t)(b * p.Hq + hk * G) * D;
  for (int i = tid; i < MAXG * D; i += NTHREADS) {
    const int g = i / D, c = i % D;
    sQ[g][c] = (g < G) ? to_f(qg[(size_t)g * D + c]) : 0.f;
  }
  if (tid < MAXG) { sM[tid] = NEG_INF; sL[tid] = 0.f; }

  const int c_out = tid % D, g_out = tid / D;      // P.V: column, first row
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  const int ik_end = min((split + 1) * p.nj, p.nk);
  for (int ik = split * p.nj; ik < ik_end; ++ik) {
    const int kv_start = ik * BKV;
    if (kv_start >= kv_len) break;                 // past this row's cache
    if (p.window > 0 && kv_start + BKV - 1 <= q_pos - p.window) continue;

    __syncthreads();                               // last tile's readers done
    const size_t base = cache.row0(b, hk, ik);
    const int rows = min(BKV, p.S - kv_start);
    for (int i = tid; i < BKV * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const bool in = r < rows;
      sK[r * (D + 1) + c] = in ? to_f(cache.k[base + (size_t)r * D + c]) : 0.f;
      sV[r * D + c] = in ? to_f(cache.v[base + (size_t)r * D + c]) : 0.f;
    }
    __syncthreads();

    // ---- scores of column j = tid for every group row ----
    const int kp = kv_start + tid;
    bool ok = kp < kv_len;
    if (p.window > 0) ok &= kp > q_pos - p.window;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = sK[tid * (D + 1) + d];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) s[g] = fmaf(sQ[g][d], kd, s[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      s[g] = ok ? s[g] * p.scale : NEG_INF;
      float mx = s[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) sRed[warp][g] = mx;
    }
    __syncthreads();
    if (tid < MAXG) {   // rows >= G are zero-q padding, kept finite
      float mx = sRed[0][tid];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) mx = fmaxf(mx, sRed[w][tid]);
      const float m_new = fmaxf(sM[tid], mx);
      sAlpha[tid] = expf(sM[tid] - m_new);
      sMsafe[tid] = (m_new == NEG_INF) ? 0.f : m_new;
      sM[tid] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float pg = expf(s[g] - sMsafe[g]);
      sP[g][tid] = to_f(from_f<T>(pg));            // P cast to v.dtype
      float sum = pg;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) sRed[warp][g] = sum;
    }
    __syncthreads();
    if (tid < MAXG) {   // rows >= G are zero-q padding, kept finite
      float sum = sRed[0][tid];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) sum += sRed[w][tid];
      sL[tid] = sL[tid] * sAlpha[tid] + sum;
    }

    // ---- acc = acc * alpha + P V (reads only sP, sV, sAlpha) ----
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int g = g_out + RGRP * r;
      if (g < MAXG) acc[r] *= sAlpha[g];
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float vj = sV[j * D + c_out];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int g = g_out + RGRP * r;
        if (g < MAXG) acc[r] = fmaf(sP[g][j], vj, acc[r]);
      }
    }
  }
  __syncthreads();                                 // sL / sM final

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int g = g_out + RGRP * r;
    if (g >= G) continue;
    if (p.o != nullptr) {
      const float l_safe = (sL[g] == 0.f) ? 1.f : sL[g];
      static_cast<T*>(p.o)[(size_t)(b * p.Hq + hk * G + g) * D + c_out] =
          from_f<T>(acc[r] / l_safe);
    } else {
      const size_t row = ((size_t)(b * p.Hkv + hk) * p.ns + split) * G + g;
      p.acc_part[row * D + c_out] = acc[r];
      if (c_out == 0) { p.m_part[row] = sM[g]; p.l_part[row] = sL[g]; }
    }
  }
}

template <typename T, int D>
int launch(const DecodeParams& p, const void* k, const void* v, int B,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BKV * (D + 1) + BKV * D);
  using Cache = ContigCache<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, Cache>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Cache cache{static_cast<const T*>(k), static_cast<const T*>(v), p.Hkv, p.S};
  const dim3 grid(p.ns, p.Hkv, B);
  decode_kernel<T, D, Cache><<<grid, NTHREADS, smem, stream>>>(p, cache);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const DecodeParams& p, const void* k, const void* v, int B, int d,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, k, v, B, stream);
    case 32: return launch<T, 32>(p, k, v, B, stream);
    case 64: return launch<T, 64>(p, k, v, B, stream);
    case 128: return launch<T, 128>(p, k, v, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. With num_splits == 1 `o` is written and
// the partial pointers may be null; otherwise `o` is null and the partials
// are written. Returns the cudaError_t of the launch (0 = success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, void* o, float* acc_part,
                        float* m_part, float* l_part, int B, int Hq, int Hkv,
                        int S, int D, int dtype, float scale, int window,
                        int num_splits, void* stream) {
  DecodeParams p;
  p.q = q; p.kv_len = kv_len; p.o = o;
  p.acc_part = acc_part; p.m_part = m_part; p.l_part = l_part;
  p.Hq = Hq; p.Hkv = Hkv; p.G = Hq / Hkv; p.S = S;
  p.nk = (S + BKV - 1) / BKV;
  p.ns = num_splits;
  p.nj = (p.nk + num_splits - 1) / num_splits;
  p.scale = scale; p.window = window;
  if (p.G > MAXG || p.G * Hkv != Hq || num_splits < 1) return (int)cudaErrorInvalidValue;
  if ((num_splits == 1) != (o != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, k, v, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, k, v, B, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
