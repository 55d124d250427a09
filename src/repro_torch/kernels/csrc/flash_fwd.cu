// Fused attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_fwd.py:46
// `_fwd_kernel` (launched by `flash_fwd`, :155). It computes
//   O = dropout(softmax(Q K^T * scale)) V   and   lse = m + log(l)
// with q as the suffix of kv (q_offset = Skv - Sq), causal masking, a sliding
// window, packed-sequence segment ids (negative = padding), ragged tails, the
// coordinate-hash dropout of kernels/rng.py (bit-identical keep mask) and the
// online-softmax fold of src/repro/kernels/common.py:43 (m_safe guard, l
// updated before dropout, P cast to the value type before P.V, l_safe at
// finalize so fully masked rows give o = 0 and lse = NEG_INF).
//
// What bounds it: at prefill shapes (granite: Sq = Skv = 512..2048, D = 64,
// 32 q heads) attention does O(S^2 D) operations on O(S D) bytes, so it is
// bound by operations, not by device memory.
//
// What the design does about that: one thread block per (q tile, q head,
// batch) keeps its Q tile and the (m, l, acc) state on chip for the whole KV
// loop; S and P never leave the SM, so device memory sees Q, K, V read and O
// written once per q tile. Tiles wholly above the causal diagonal, outside
// the window or with disjoint segment ranges are skipped without loading.
// Products run as f32 FMAs from shared memory on a 4x8 register tile per
// thread (S) and 4 x D/8 (P.V). This is the simple first kernel: tensor-core
// products (mma.sync / wgmma) and TMA-fed K/V pipelines are later work.
//
// bf16-ACC (template flag ACC16, JAX's acc_dtype=bfloat16, paper §3.1): the
// score tile is rounded to bf16 after the D loop, before the scale, and each
// tile's P.V is summed in scratch registers, rounded to bf16 and only then
// folded into the f32 accumulator (flash_fwd.py:89, common.py:76-78).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per block   (kernels/flash_fwd.py TILE)
constexpr int BKV = 64;         // kv rows per tile   (kernels/flash_fwd.py TILE)
constexpr int NTHREADS = 128;
constexpr int CG = 8;           // column groups: thread owns cols cg + 8*j
constexpr int RG = NTHREADS / CG;   // 16 row groups: rows rg + 16*i
constexpr int RPT = BQ / RG;        // 4 rows per thread
constexpr int CPT = BKV / CG;       // 8 score columns per thread
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

struct FwdParams {
  const void* q; const void* k; const void* v;
  void* o; float* lse;
  const int* q_seg; const int* kv_seg;                      // null: no segments
  const int* qs_min; const int* qs_max;                     // [B, nq]
  const int* ks_min; const int* ks_max;                     // [B, nk]
  int B, Hq, Hkv, Sq, Skv, nq, nk;
  float scale;
  int causal, window;                                       // window <= 0: none
  int dropout; uint32_t seed, threshold; float keep_div;    // keep_div = 1 - rate
};

template <typename T, int D, bool ACC16>
__global__ void __launch_bounds__(NTHREADS) fwd_kernel(const FwdParams p) {
  constexpr int DPT = D / CG;                 // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                           // [BQ][D + 1]
  float* sK = sQ + BQ * (D + 1);              // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);             // [BKV][D]
  float* sP = sV + BKV * D;                   // [BQ][BKV + 1]
  __shared__ int sQseg[BQ];
  __shared__ int sKseg[BKV];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, rg = tid / CG, cg = tid % CG;
  const int q0 = iq * BQ;                     // first q row of this tile
  const int q_start = q0 + (p.Skv - p.Sq);    // its global position
  const bool segments = p.q_seg != nullptr;

  const T* qg = static_cast<const T*>(p.q) + (size_t)(b * p.Hq + h) * p.Sq * D;
  const T* kg = static_cast<const T*>(p.k) + (size_t)(b * p.Hkv + hk) * p.Skv * D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)(b * p.Hkv + hk) * p.Skv * D;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    sQ[r * (D + 1) + c] = (q0 + r < p.Sq) ? to_f(qg[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (segments)
    for (int i = tid; i < BQ; i += NTHREADS)
      sQseg[i] = (q0 + i < p.Sq) ? p.q_seg[(size_t)b * p.Sq + q0 + i] : -1;

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  const uint32_t hs = (p.seed * GOLDEN + (uint32_t)b * M3) ^ ((uint32_t)h + GOLDEN);

  for (int ik = 0; ik < p.nk; ++ik) {
    const int kv_start = ik * BKV;
    // block-level early exit; uniform over the block, so the barriers below
    // are reached by every thread or by none
    bool needed = true;
    if (p.causal) needed &= kv_start <= q_start + BQ - 1;
    if (p.window > 0) needed &= kv_start + BKV - 1 > q_start - p.window;
    if (segments)
      needed &= p.ks_min[b * p.nk + ik] <= p.qs_max[b * p.nq + iq] &&
                p.ks_max[b * p.nk + ik] >= p.qs_min[b * p.nq + iq];
    if (!needed) continue;

    __syncthreads();                          // last tile's readers are done
    for (int i = tid; i < BKV * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      const bool in = kv_start + r < p.Skv;
      const size_t off = (size_t)(kv_start + r) * D + c;
      sK[r * (D + 1) + c] = in ? to_f(kg[off]) : 0.f;
      sV[r * D + c] = in ? to_f(vg[off]) : 0.f;
    }
    if (segments)
      for (int i = tid; i < BKV; i += NTHREADS)
        sKseg[i] = (kv_start + i < p.Skv) ? p.kv_seg[(size_t)b * p.Skv + kv_start + i] : -1;
    __syncthreads();

    // ---- S = Q K^T on a 4x8 register tile ----
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(rg + RG * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = sK[(cg + CG * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // ---- mask, then the online fold (common.py online_fold) ----
    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i, qp = q_start + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + CG * j, kp = kv_start + c;
        bool ok = kp < p.Skv;
        if (p.causal) ok &= kp <= qp;
        if (p.window > 0) ok &= kp > qp - p.window;
        if (segments) ok &= (sQseg[r] == sKseg[c]) && (sQseg[r] >= 0);
        const float sv = ACC16 ? round_bf16(s[i][j]) : s[i][j];
        s[i][j] = ok ? sv * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes sharing a row are lanes 8k..8k+7 of one warp
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      const float m_safe = (m_new == NEG_INF) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < CG; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;           // l sees pre-dropout probabilities
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + CG * j;
        float pj = s[i][j];
        if (p.dropout) {
          const uint32_t x = (uint32_t)qp * M1 + (uint32_t)(kv_start + c) * M2 + hs;
          const uint32_t bits = mix32(mix32(x) * M3 + GOLDEN);
          pj = (bits >= p.threshold) ? pj / p.keep_div : 0.f;
        }
        sP[r * (BKV + 1) + c] = to_f(from_f<T>(pj));   // P cast to v.dtype
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V (ACC16: the tile's P V rounded to bf16) ----
    float pv[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        if (ACC16) pv[i][c] = 0.f;
        else acc[i][c] *= alpha[i];
      }
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = sV[j * D + cg + CG * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pj = sP[(rg + RG * i) * (BKV + 1) + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          if (ACC16) pv[i][c] = fmaf(pj, vv[c], pv[i][c]);
          else acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
        }
      }
    }
    if (ACC16) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = acc[i][c] * alpha[i] + round_bf16(pv[i][c]);
    }
  }

  // ---- finalize: l_safe guard, o in q.dtype, lse in f32 ----
  T* og = static_cast<T*>(p.o) + (size_t)(b * p.Hq + h) * p.Sq * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qr = q0 + rg + RG * i;
    if (qr >= p.Sq) continue;
    const float l_safe = (l[i] == 0.f) ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      og[(size_t)qr * D + cg + CG * c] = from_f<T>(acc[i][c] / l_safe);
    if (cg == 0) p.lse[(size_t)(b * p.Hq + h) * p.Sq + qr] = m[i] + logf(l_safe);
  }
}

template <typename T, int D, bool ACC16>
int launch(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) *
      (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D, ACC16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nq, p.Hq, p.B);
  fwd_kernel<T, D, ACC16><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool ACC16>
int launch_d(const FwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, ACC16>(p, stream);
    case 32: return launch<T, 32, ACC16>(p, stream);
    case 64: return launch<T, 64, ACC16>(p, stream);
    case 128: return launch<T, 128, ACC16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; acc_bf16: round each tile product to
// bf16 (bf16-ACC). Segment pointers are all null or all set.
// Returns the cudaError_t of the launch (0 = success).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const int* q_seg, const int* kv_seg,
                     const int* qs_min, const int* qs_max, const int* ks_min,
                     const int* ks_max, int B, int Hq, int Hkv, int Sq, int Skv,
                     int D, int dtype, int acc_bf16, float scale, int causal,
                     int window,
                     int dropout, int seed, unsigned int threshold,
                     float keep_div, void* stream) {
  FwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
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
    return acc_bf16 ? launch_d<float, true>(p, D, s) : launch_d<float, false>(p, D, s);
  if (dtype == 1)
    return acc_bf16 ? launch_d<__nv_bfloat16, true>(p, D, s)
                    : launch_d<__nv_bfloat16, false>(p, D, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
