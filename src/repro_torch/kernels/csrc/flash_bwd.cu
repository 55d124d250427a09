// Fused attention backward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/flash_bwd.py,
// `_dkv_kernel` (:98) and `_dq_kernel` (:164), launched by `flash_bwd` (:221).
// Both recompute the probabilities from the forward's stored log-sum-exp,
//   P = exp(S * scale - lse_safe)      (lse_safe = 0 where lse == NEG_INF),
// so S and P never exist in device memory, and with
//   dP = dO V^T,  dS = P o (dP~ - delta) * scale,  delta = rowsum(dO o O),
// where P~ and dP~ carry the forward's dropout (the keep mask of
// kernels/rng.py, regenerated bit for bit from the coordinates):
//   dkv_kernel:  dV += P~^T dO,  dK += dS^T Q
//   dq_kernel:   dQ += dS K
// q is the suffix of kv (q_offset = Skv - Sq); causal, sliding window,
// segment ids (negative = padding, zero gradient) and ragged tails are
// masked as in the forward; padded q rows and kv columns get no gradient.
// With ACC16 each tile product (S, dP, the dV/dK/dQ tile updates) is rounded
// to bf16 before it is used or added into the f32 accumulator, which is what
// JAX's `preferred_element_type=bfloat16` does per block.
//
// What bounds it: at training shapes (granite-3-2b: B 4, 32/8 heads, S 2048,
// D 64, causal) the work is 8 D flops per causal (q, k) pair and q head for
// dK/dV (S, dP, dV, dK) and 6 D for dQ (S, dP, dQ) on O(S D) bytes, so both
// kernels are bound by operations, not by device memory.
//
// What the simple design does about that: the TPU's sequential "arbitrary"
// grid axis becomes a loop inside the block. dkv_kernel: one block per
// (kv tile, kv head, batch) keeps its K/V tile in shared memory and dK/dV in
// registers while it loops over the G q heads of its GQA group and over every
// q tile the causal, window and segment skips leave, so the group sum happens
// on chip, in a fixed order (deterministic) and with no [B, Hq, Skv, D]
// intermediate. dq_kernel: one block per (q tile, q head, batch) keeps Q, dO
// and dQ on chip and loops over kv tiles (no atomics). 256 threads: dK plus
// dV of a 64-row tile are 2 * 64 * D f32 values, D / 2 registers a thread.
// Products run as f32 FMAs from shared memory; tensor cores (mma.sync /
// wgmma) and TMA-fed pipelines are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile    (kernels/flash_bwd.py TILE)
constexpr int BKV = 64;         // kv rows per tile   (kernels/flash_bwd.py TILE)
constexpr int NTHREADS = 256;
constexpr int GR = 16;          // 16 row groups x 16 column groups
constexpr int RPT = BQ / GR;    // 4 rows per thread (score and product tiles)
constexpr int CPT = BKV / GR;   // 4 score columns per thread
constexpr float NEG_INF = -1e30f;   // core/online_softmax.py NEG_INF

// kernels/rng.py constants
constexpr uint32_t M1 = 0x85EBCA6Bu, M2 = 0xC2B2AE35u, M3 = 0x27D4EB2Fu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= M1;
  x ^= x >> 13;
  x *= M2;
  x ^= x >> 16;
  return x;
}

struct BwdParams {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;                     // [B, Hq, Sq]
  void* dq; void* dk; void* dv;
  const int* q_seg; const int* kv_seg;                      // null: no segments
  const int* qs_min; const int* qs_max;                     // [B, nq]
  const int* ks_min; const int* ks_max;                     // [B, nk]
  int B, Hq, Hkv, Sq, Skv, nq, nk;
  float scale;
  int causal, window;                                       // window <= 0: none
  int dropout; uint32_t seed, threshold; float keep_div;    // keep_div = 1 - rate
};

// Block-uniform tile skip, the `needed` test of both TPU kernels.
__device__ __forceinline__ bool tile_needed(const BwdParams& p, int b, int iq, int ik) {
  const int q_start = iq * BQ + (p.Skv - p.Sq);
  const int kv_start = ik * BKV;
  bool needed = true;
  if (p.causal) needed &= kv_start <= q_start + BQ - 1;
  if (p.window > 0) needed &= kv_start + BKV - 1 > q_start - p.window;
  if (p.q_seg != nullptr)
    needed &= p.ks_min[b * p.nk + ik] <= p.qs_max[b * p.nq + iq] &&
              p.ks_max[b * p.nk + ik] >= p.qs_min[b * p.nq + iq];
  return needed;
}

// rows [row0, row0 + 64) of a [rows, D] tensor into shared [64][D + 1] f32;
// rows past `valid` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int valid,
                                          int tid) {
  for (int i = tid; i < 64 * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (row0 + r < valid) ? to_f(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// The recompute shared by both kernels, for one (q tile, kv tile) of head h:
// S = Q K^T and dP = dO V^T on a 4x4 register tile a thread, then the mask,
// P from lse, dropout and dS. Writes dS (rounded to T, as JAX casts it to
// q.dtype) to sdS and, with WRITE_P, P~ (rounded to T) to sP.
template <typename T, int D, bool ACC16, bool WRITE_P>
__device__ __forceinline__ void ds_tile(const BwdParams& p, const float* sQ, const float* sdO,
                                        const float* sK, const float* sV, const float* sLse,
                                        const float* sDelta, const int* sQseg,
                                        const int* sKseg, float* sP, float* sdS, int b,
                                        int h, int q0, int kv_start, int tid) {
  const int rg = tid / GR, cg = tid % GR;
  float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      qv[i] = sQ[(rg + GR * i) * (D + 1) + d];
      ov[i] = sdO[(rg + GR * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      kv[j] = sK[(cg + GR * j) * (D + 1) + d];
      vv[j] = sV[(cg + GR * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const int q_off = p.Skv - p.Sq;
  const bool segments = p.q_seg != nullptr;
  const uint32_t hs = (p.seed * GOLDEN + (uint32_t)b * M3) ^ ((uint32_t)h + GOLDEN);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + GR * i, qr = q0 + r, qp = qr + q_off;
    const float lse = sLse[r];
    const float lse_safe = (lse == NEG_INF) ? 0.f : lse;   // flash_bwd.py:68
    const float delta = sDelta[r];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + GR * j, kp = kv_start + c;
      bool ok = qr < p.Sq && kp < p.Skv;
      if (p.causal) ok &= kp <= qp;
      if (p.window > 0) ok &= kp > qp - p.window;
      if (segments) ok &= (sQseg[r] == sKseg[c]) && (sQseg[r] >= 0);
      float sv = s[i][j], dpv = dp[i][j];
      if (ACC16) {
        sv = round_bf16(sv);
        dpv = round_bf16(dpv);
      }
      const float pr = ok ? expf(sv * p.scale - lse_safe) : 0.f;
      float pk = pr;
      if (p.dropout) {
        const uint32_t x = (uint32_t)qp * M1 + (uint32_t)kp * M2 + hs;
        const bool keep = mix32(mix32(x) * M3 + GOLDEN) >= p.threshold;
        pk = keep ? pr / p.keep_div : 0.f;
        dpv = keep ? dpv / p.keep_div : 0.f;
      }
      const float ds = pr * (dpv - delta) * p.scale;
      if (WRITE_P) sP[r * (BKV + 1) + c] = to_f(from_f<T>(pk));
      sdS[r * (BKV + 1) + c] = to_f(from_f<T>(ds));
    }
  }
}

template <int D>
__device__ __forceinline__ void load_rows_f32(float* sLse, float* sDelta, int* sQseg,
                                              const BwdParams& p, int b, int h, int q0,
                                              int tid) {
  const size_t row = (size_t)(b * p.Hq + h) * p.Sq;
  for (int i = tid; i < BQ; i += NTHREADS) {
    const bool in = q0 + i < p.Sq;
    sLse[i] = in ? p.lse[row + q0 + i] : 0.f;
    sDelta[i] = in ? p.delta[row + q0 + i] : 0.f;
    if (p.q_seg != nullptr) sQseg[i] = in ? p.q_seg[(size_t)b * p.Sq + q0 + i] : -1;
  }
}

template <typename T, int D, bool ACC16>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(const BwdParams p) {
  constexpr int DPT = D / GR;                 // dK / dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                           // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);             // [BKV][D + 1]
  float* sQ = sV + BKV * (D + 1);             // [BQ][D + 1]
  float* sdO = sQ + BQ * (D + 1);             // [BQ][D + 1]
  float* sP = sdO + BQ * (D + 1);             // [BQ][BKV + 1]
  float* sdS = sP + BQ * (BKV + 1);           // [BQ][BKV + 1]
  __shared__ float sLse[BQ], sDelta[BQ];
  __shared__ int sQseg[BQ], sKseg[BKV];

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, rg = tid / GR, cg = tid % GR;
  const int kv_start = ik * BKV;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Skv * D;

  load_tile<T, D>(sK, static_cast<const T*>(p.k) + kv_off, kv_start, p.Skv, tid);
  load_tile<T, D>(sV, static_cast<const T*>(p.v) + kv_off, kv_start, p.Skv, tid);
  if (p.q_seg != nullptr)
    for (int i = tid; i < BKV; i += NTHREADS)
      sKseg[i] = (kv_start + i < p.Skv) ? p.kv_seg[(size_t)b * p.Skv + kv_start + i] : -1;

  float dk[RPT][DPT], dv[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = (size_t)(b * p.Hq + h) * p.Sq * D;
    for (int iq = 0; iq < p.nq; ++iq) {
      // uniform over the block, so every thread reaches the barriers or none
      if (!tile_needed(p, b, iq, ik)) continue;
      const int q0 = iq * BQ;
      __syncthreads();                        // last tile's readers are done
      load_tile<T, D>(sQ, static_cast<const T*>(p.q) + q_off, q0, p.Sq, tid);
      load_tile<T, D>(sdO, static_cast<const T*>(p.dout) + q_off, q0, p.Sq, tid);
      load_rows_f32<D>(sLse, sDelta, sQseg, p, b, h, q0, tid);
      __syncthreads();
      ds_tile<T, D, ACC16, true>(p, sQ, sdO, sK, sV, sLse, sDelta, sQseg, sKseg, sP, sdS,
                                 b, h, q0, kv_start, tid);
      __syncthreads();
      // dV += P~^T dO and dK += dS^T Q over this tile's q rows; a thread owns
      // kv rows rg + 16 i and columns cg + 16 c
      float tv[RPT][DPT], tk[RPT][DPT];
      if (ACC16) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) tv[i][c] = tk[i][c] = 0.f;
      }
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pv[RPT], sv[RPT], ov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = sP[j * (BKV + 1) + rg + GR * i];
          sv[i] = sdS[j * (BKV + 1) + rg + GR * i];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          ov[c] = sdO[j * (D + 1) + cg + GR * c];
          qv[c] = sQ[j * (D + 1) + cg + GR * c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            if (ACC16) {
              tv[i][c] = fmaf(pv[i], ov[c], tv[i][c]);
              tk[i][c] = fmaf(sv[i], qv[c], tk[i][c]);
            } else {
              dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
              dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
            }
          }
      }
      if (ACC16) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c) {
            dv[i][c] += round_bf16(tv[i][c]);
            dk[i][c] += round_bf16(tk[i][c]);
          }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kr = kv_start + rg + GR * i;
    if (kr >= p.Skv) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      dkg[(size_t)kr * D + cg + GR * c] = from_f<T>(dk[i][c]);
      dvg[(size_t)kr * D + cg + GR * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int D, bool ACC16>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const BwdParams p) {
  constexpr int DPT = D / GR;                 // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                           // [BQ][D + 1]
  float* sdO = sQ + BQ * (D + 1);             // [BQ][D + 1]
  float* sK = sdO + BQ * (D + 1);             // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);             // [BKV][D + 1]
  float* sdS = sV + BKV * (D + 1);            // [BQ][BKV + 1]
  __shared__ float sLse[BQ], sDelta[BQ];
  __shared__ int sQseg[BQ], sKseg[BKV];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, rg = tid / GR, cg = tid % GR;
  const int q0 = iq * BQ;
  const size_t q_off = (size_t)(b * p.Hq + h) * p.Sq * D;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Skv * D;

  load_tile<T, D>(sQ, static_cast<const T*>(p.q) + q_off, q0, p.Sq, tid);
  load_tile<T, D>(sdO, static_cast<const T*>(p.dout) + q_off, q0, p.Sq, tid);
  load_rows_f32<D>(sLse, sDelta, sQseg, p, b, h, q0, tid);

  float dq[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dq[i][c] = 0.f;

  for (int ik = 0; ik < p.nk; ++ik) {
    if (!tile_needed(p, b, iq, ik)) continue;   // block-uniform
    const int kv_start = ik * BKV;
    __syncthreads();                          // last tile's readers are done
    load_tile<T, D>(sK, static_cast<const T*>(p.k) + kv_off, kv_start, p.Skv, tid);
    load_tile<T, D>(sV, static_cast<const T*>(p.v) + kv_off, kv_start, p.Skv, tid);
    if (p.q_seg != nullptr)
      for (int i = tid; i < BKV; i += NTHREADS)
        sKseg[i] = (kv_start + i < p.Skv) ? p.kv_seg[(size_t)b * p.Skv + kv_start + i] : -1;
    __syncthreads();
    ds_tile<T, D, ACC16, false>(p, sQ, sdO, sK, sV, sLse, sDelta, sQseg, sKseg, nullptr,
                                sdS, b, h, q0, kv_start, tid);
    __syncthreads();
    // dQ += dS K; a thread owns q rows rg + 16 i and columns cg + 16 c
    float tq[RPT][DPT];
    if (ACC16) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) tq[i][c] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float sv[RPT], kv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) sv[i] = sdS[(rg + GR * i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) kv[c] = sK[j * (D + 1) + cg + GR * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          if (ACC16) tq[i][c] = fmaf(sv[i], kv[c], tq[i][c]);
          else dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
        }
    }
    if (ACC16) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) dq[i][c] += round_bf16(tq[i][c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + q_off;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + rg + GR * i;
    if (qr >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) dqg[(size_t)qr * D + cg + GR * c] = from_f<T>(dq[i][c]);
  }
}

template <typename T, int D, bool ACC16>
int launch(const BwdParams& p, bool dkv, cudaStream_t stream) {
  if (dkv) {
    constexpr size_t smem = sizeof(float) * (2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                                             2 * BQ * (BKV + 1));
    cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel<T, D, ACC16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dkv_kernel<T, D, ACC16><<<dim3(p.nk, p.Hkv, p.B), NTHREADS, smem, stream>>>(p);
  } else {
    constexpr size_t smem = sizeof(float) * (2 * BQ * (D + 1) + 2 * BKV * (D + 1) +
                                             BQ * (BKV + 1));
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, D, ACC16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dq_kernel<T, D, ACC16><<<dim3(p.nq, p.Hq, p.B), NTHREADS, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool ACC16>
int launch_d(const BwdParams& p, int d, bool dkv, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, ACC16>(p, dkv, stream);
    case 32: return launch<T, 32, ACC16>(p, dkv, stream);
    case 64: return launch<T, 64, ACC16>(p, dkv, stream);
    case 128: return launch<T, 128, ACC16>(p, dkv, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(bool dkv, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv,
               const int* q_seg, const int* kv_seg, const int* qs_min, const int* qs_max,
               const int* ks_min, const int* ks_max, int B, int Hq, int Hkv, int Sq,
               int Skv, int D, int dtype, int acc_bf16, float scale, int causal,
               int window, int dropout, int seed, unsigned int threshold, float keep_div,
               void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.q_seg = q_seg; p.kv_seg = kv_seg;
  p.qs_min = qs_min; p.qs_max = qs_max; p.ks_min = ks_min; p.ks_max = ks_max;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  p.nq = (Sq + BQ - 1) / BQ;
  p.nk = (Skv + BKV - 1) / BKV;
  p.scale = scale; p.causal = causal; p.window = window;
  p.dropout = dropout; p.seed = (uint32_t)seed; p.threshold = threshold;
  p.keep_div = keep_div;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return acc_bf16 ? launch_d<float, true>(p, D, dkv, s) : launch_d<float, false>(p, D, dkv, s);
  if (dtype == 1)
    return acc_bf16 ? launch_d<__nv_bfloat16, true>(p, D, dkv, s)
                    : launch_d<__nv_bfloat16, false>(p, D, dkv, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; acc_bf16: round each tile product to
// bf16. Segment pointers are all null or all set. q, k, v, dout, dq, dk, dv
// are contiguous [B, H, S, D]; lse and delta [B, Hq, Sq] f32. Each returns
// the cudaError_t of its launch (0 = success).
#define BWD_ARGS                                                                        \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,     \
      const float *delta, void *dq, void *dk, void *dv, const int *q_seg,              \
      const int *kv_seg, const int *qs_min, const int *qs_max, const int *ks_min,      \
      const int *ks_max, int B, int Hq, int Hkv, int Sq, int Skv, int D, int dtype,    \
      int acc_bf16, float scale, int causal, int window, int dropout, int seed,        \
      unsigned int threshold, float keep_div, void *stream
#define BWD_PASS                                                                        \
  q, k, v, dout, lse, delta, dq, dk, dv, q_seg, kv_seg, qs_min, qs_max, ks_min, ks_max, \
      B, Hq, Hkv, Sq, Skv, D, dtype, acc_bf16, scale, causal, window, dropout, seed,   \
      threshold, keep_div, stream

int flash_bwd_dkv_launch(BWD_ARGS) { return launch_any(true, BWD_PASS); }

int flash_bwd_dq_launch(BWD_ARGS) { return launch_any(false, BWD_PASS); }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
