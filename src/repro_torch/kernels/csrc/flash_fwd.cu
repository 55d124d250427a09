// Fused attention forward for Hopper (sm_90a), written by hand, its products
// on tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_fwd.py:46
// `_fwd_kernel` (launched by `flash_fwd`, :155). It computes
//   O = dropout(softmax(Q K^T * scale)) V   and   lse = m + log(l)
// with q as the suffix of kv (q_offset = Skv - Sq), causal masking, a sliding
// window, packed-sequence segment ids (negative = padding), ragged tails, GQA,
// the coordinate-hash dropout of kernels/rng.py (bit-identical keep mask) and
// the online-softmax fold of src/repro/kernels/common.py:43 over 64-row KV
// tiles (m_safe guard, l updated before dropout, P cast to the value type
// before P.V, each tile's P.V summed on its own and folded as acc * alpha +
// pv, l_safe at finalize so fully masked rows give o = 0 and lse = NEG_INF).
// bf16-ACC (ACC16, JAX's acc_dtype=bfloat16, paper §3.1): the score tile is
// rounded to bf16 before the scale, and each tile's P.V before the fold
// (flash_fwd.py:89, common.py:76-78).
//
// What bounds it on this card: operations. S = Q K^T and P V are 4 D flops
// a causal (q, k) pair and q head on O(S D) bytes. At the training shape
// (granite-3-2b: B 4, 32/8 heads, S 2048, D 64, causal) that is 68.7 GFLOP
// on 169 MB (f32): 0.139 ms at the TF32 peak, 0.417 ms as 3xTF32 (three
// TF32 products an f32 product), 0.069 ms in bf16, against 0.050 ms of
// bytes. At the prefill shape (B 8, S 512) 8.6 GFLOP on 84 MB: the bytes
// (0.025 ms) and the 3xTF32 operations (0.052 ms) are the same order. Measured
// (PERF.md, perf/fwd_ablation.py): mma.sync's TF32 rate bounds the f32
// kernel (about half the TF32 peak a pass), then the K/V copies.
//
// What the design does about that:
// - Tensor cores. Both products are mma.sync through csrc/mma.cuh: 3xTF32
//   on m16n8k8 for f32 (each operand split hi + lo, lo*hi + hi*lo + hi*hi:
//   one TF32 product cannot hold the 2e-5 tolerance), one m16n8k16 bf16
//   product with f32 accumulators for bf16.
// - Warps own q rows. A block of NW warps takes 16 NW q rows; warp w holds
//   rows 16w..16w+15 through the whole KV loop: its Q fragments (split once
//   for f32; reread from shared memory where they would not fit the
//   registers, f32 at D 128), the S/P tile, each row's m and l and the
//   output accumulator. A row's max and sum are joined across the quad of
//   lanes that holds it with two shuffles. P is the A operand of P V
//   straight from S's accumulator registers (acc_to_a: packed neighbours
//   for bf16, a permuted k order for TF32): no S or P goes through shared
//   memory, and the softmax needs no block barrier.
// - Head dim 256 (recurrentgemma-2b) takes its own shape: a warp's f32
//   accumulator of 16 rows x 256 columns is 128 registers a lane, so two
//   warps share each 16 q rows (8 warps a block), both compute the rows' S,
//   m and l (the same products in the same order, so the same values) and
//   each keeps half of O's columns; and the K/V tiles are 32 rows, since a
//   64-row f32 stage alone is 133 KB: Q 64 x 260 words and two stages of
//   32-row K and V take 195 KB (bf16 99 KB). The fold's tile is then 32
//   rows, which the plain version follows (flash_fwd.py kv_tile).
// - Head dim 80 (hubert-xlarge, non-causal) keeps the D <= 128 shape: an
//   80-wide row is 20 f32 or 10 bf16 16-byte chunks, which a block's 128
//   threads do not divide, so the copies walk rows x chunks flat
//   (mma.cuh load_rows); O's 10 n-tiles of 8 take one P V pass; Q's f32
//   fragments (320 bytes a row) are reread from shared memory, bf16 ones
//   stay in registers; rows of 84 words (f32) and 88 halves (bf16) keep the
//   ldmatrix rows on distinct banks.
// - Each tile's P V is summed into zeroed fragments and folded into the f32
//   accumulator as acc * alpha + pv (bf16-rounded first under ACC16): JAX's
//   fold, and a chain of mma into one accumulator over a long sequence would
//   drift, since the tensor core's accumulation truncates.
// - A K/V ring. K and V tiles are copied in their stored dtype by cp.async,
//   16 bytes a request, into a two-stage ring; the next needed tile is in
//   flight while this one's products run; one block barrier a tile. Rows
//   are padded by 16 bytes, so the ldmatrix and the f32 V loads are free of
//   bank conflicts.
// - Masks only where they bite. Tiles that no row of the block may read
//   (above the causal diagonal, behind the window, disjoint segment ranges)
//   are never loaded; a warp skips a loaded tile that none of its 16 rows
//   may read (exact: such a tile leaves the state unchanged); a tile wholly
//   inside the causal, window and length limits with no segments takes a
//   path with no per-element mask. Diagonal, window-edge, ragged and segment
//   tiles mask on the fragments. Softmax runs in base 2 (scores times
//   scale * log2 e, one ex2 an element); dropout scales a kept P by a
//   multiply with 1 / (1 - rate), within an ulp of JAX's division (an f32
//   division an element cost more than the whole dropout hash).
// - Heavy tiles first. Blocks are numbered q tile major from the last q tile,
//   so under causal masking the longest rows start first and the short ones
//   fill the last wave.
// - Deterministic: no atomics; two launches on the same inputs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int SUB = 64;         // rows of a segment-bound tile (flash_fwd.py TILE, _tile_minmax)
constexpr float NEG_INF = -1e30f;   // core/online_softmax.py NEG_INF
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// kernels/rng.py constants
constexpr uint32_t M1 = 0x85EBCA6Bu, M2 = 0xC2B2AE35u, M3 = 0x27D4EB2Fu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
  const int* qs_min; const int* qs_max;                     // [B, nq64]
  const int* ks_min; const int* ks_max;                     // [B, nk64]
  int B, Hq, Hkv, Sq, Skv, nq, nq64, nk, nk64;              // nq, nk: the Cfg's tiles
  float scale;
  int causal, window;                                       // window <= 0: none
  int dropout; uint32_t seed, threshold; float keep_div;    // keep_div = 1 - rate
  int b_off, h_off;     // global batch row and q head of local (0, 0): the mask's
                        // coordinates on a rank that holds a shard of B or Hq
};

// The layout of one (T, D): warps, the ring, shared memory.
template <typename T, int D>
struct Cfg {
  // warps that share 16 q rows, each holding 1 / DS of O's columns: at D
  // 256 one warp's f32 accumulator (128 registers a lane) would not leave
  // room for S and the operands, so two warps take 128 columns each and
  // both compute the rows' S (and so the same m and l)
  static constexpr int DS = D > 128 ? 2 : 1;
  static constexpr int DW = D / DS;               // O's columns a warp
  static constexpr int NW = 4 * DS;               // warps
  static constexpr int BQ = 16 * NW / DS;         // q rows a block
  static constexpr int NT = 32 * NW;
  static constexpr int NST = 2;                   // K/V ring stages
  // kv rows a tile, the fold's tile (kernels/flash_fwd.py kv_tile): at D
  // 256 a 64-row f32 ring stage alone is 133 KB, so two stages of 32 rows
  static constexpr int BKV = D > 128 ? 32 : 64;
  // blocks an SM the registers must allow: three for bf16 up to D 64 (at
  // two, perf/fwd_ablation.py's "no register cap", it is 22 % slower),
  // else what the code needs (two f32 blocks at D 64 fit in any case)
  static constexpr int MINB = sizeof(T) == 2 && D <= 64 ? 3 : 1;
  static constexpr int LD = D + 16 / (int)sizeof(T);    // Q, K, V rows, padded 16 bytes
  // Q's fragments live in registers (f32 hi and lo: 2 D words a lane; bf16
  // D / 4) unless that would crowd out the accumulators (f32 at D 128)
  static constexpr bool QREG = (int)sizeof(T) * D <= 256;
  static constexpr int SMEM = (int)sizeof(T) * (BQ + 2 * NST * BKV) * LD + 4 * NST * BKV;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// s <- s * scale * log2(e), rounded to bf16 first with ACC16; with MASK,
// NEG_INF where a pair lies past Skv, above the diagonal, outside the window
// or across segments. Fragment element e of n-tile j: row qp[e >> 1],
// column kv_start + 8 j + 2 t + (e & 1).
template <bool ACC16, bool MASK, int NJ>
__device__ __forceinline__ void scale_mask(float (&s)[NJ][4], const FwdParams& p, float sl2,
                                           int kv_start, const int (&qp)[2],
                                           const int (&qseg)[2], const int* kseg, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sv = (ACC16 ? round_bf16(s[j][e]) : s[j][e]) * sl2;
      if (!MASK) {
        s[j][e] = sv;
        continue;
      }
      const int c = 8 * j + 2 * t + (e & 1), kp = kv_start + c, q = qp[e >> 1];
      bool ok = kp < p.Skv;
      if (p.causal) ok &= kp <= q;
      if (p.window > 0) ok &= kp > q - p.window;
      if (kseg != nullptr) ok &= qseg[e >> 1] == kseg[c] && qseg[e >> 1] >= 0;
      s[j][e] = ok ? sv : NEG_INF;
    }
}

template <typename T, int D, bool ACC16>
__global__ void __launch_bounds__(Cfg<T, D>::NT, Cfg<T, D>::MINB) fwd_kernel(const FwdParams p) {
  using C = Cfg<T, D>;
  using M = Mma<T>;
  constexpr int BQ = C::BQ, NT = C::NT, LD = C::LD, NST = C::NST, BKV = C::BKV, DW = C::DW;
  constexpr int KQ = D / M::K;                    // k-steps of S = Q K^T
  constexpr int KP = BKV / M::K;                  // k-steps of P V
  // n-tiles of P V a pass (pv's registers): all of them up to D 64 and at
  // D 80 (10), else 8
  constexpr int NC = DW / 8 <= 8 || DW / 8 % 8 ? DW / 8 : 8;
  constexpr int NQF = C::QREG ? KQ : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);             // [BQ][LD]
  T* sK = sQ + BQ * LD;                           // [NST][BKV][LD]
  T* sV = sK + NST * BKV * LD;                    // [NST][BKV][LD]
  int* sKseg = reinterpret_cast<int*>(sV + NST * BKV * LD);   // [NST][BKV]

  // heavy tiles first: q tile major, from the last q tile down
  const int bh = (int)(blockIdx.x % (p.B * p.Hq));
  const int iq = p.nq - 1 - (int)(blockIdx.x / (p.B * p.Hq));
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int c0w = (warp % C::DS) * DW;            // the warp's first column of O
  const int q0 = iq * BQ, r0 = 16 * (warp / C::DS);   // the block's and the warp's first q row
  const int q_start = q0 + (p.Skv - p.Sq);        // the block's first q position
  const int qw = q_start + r0;                    // the warp's
  const bool segments = p.q_seg != nullptr;
  const size_t q_row0 = (size_t)(b * p.Hq + h) * p.Sq;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Skv * D;
  const T* kg = static_cast<const T*>(p.k) + kv_off;
  const T* vg = static_cast<const T*>(p.v) + kv_off;

  // the block-uniform tile test (the TPU kernel's `needed`), over the
  // block's q rows; segment bounds come in 64-row tiles
  int qs_lo = 0, qs_hi = -1;
  if (segments) {
    qs_lo = 0x7fffffff;
    for (int s = q0 / SUB; s < p.nq64 && s < (q0 + BQ) / SUB; ++s) {
      qs_lo = min(qs_lo, p.qs_min[b * p.nq64 + s]);
      qs_hi = max(qs_hi, p.qs_max[b * p.nq64 + s]);
    }
  }
  auto next_tile = [&](int ik) {
    for (; ik < p.nk; ++ik) {
      const int kv_start = ik * BKV;
      if (p.causal && kv_start > q_start + BQ - 1) return p.nk;   // and every later tile
      if (p.window > 0 && kv_start + BKV - 1 <= q_start - p.window) continue;
      if (segments && (p.ks_min[b * p.nk64 + kv_start / SUB] > qs_hi ||
                       p.ks_max[b * p.nk64 + kv_start / SUB] < qs_lo))
        continue;
      return ik;
    }
    return p.nk;
  };
  auto load_kv = [&](int ik, int st) {
    const int kv_start = ik * BKV;
    load_rows<T, D, NT>(sK + st * BKV * LD, LD, kg, kv_start, BKV, p.Skv, tid);
    load_rows<T, D, NT>(sV + st * BKV * LD, LD, vg, kv_start, BKV, p.Skv, tid);
    if (segments)
      for (int i = tid; i < BKV; i += NT) {
        const bool ok = kv_start + i < p.Skv;
        cp_async4(sKseg + st * BKV + i, p.kv_seg + (size_t)b * p.Skv + (ok ? kv_start + i : 0),
                  ok ? 4 : 0);
      }
  };

  // the ring: tile t_ld is the next to load, into stage n_ld % NST; a
  // group is committed even when nothing is left to load, so that
  // cp_async_wait<NST - 2> always means "the tile to compute has landed"
  int t_ld = next_tile(0), n_ld = 0;
  auto issue = [&]() {
    if (t_ld < p.nk) {
      load_kv(t_ld, n_ld % NST);
      ++n_ld;
      t_ld = next_tile(t_ld + 1);
    }
    cp_async_commit();
  };
  // the Q tile (rows past Sq zero) with the first K/V tile, then the rest
  // of the ring's first fill
  load_rows<T, D, NT>(sQ, LD, static_cast<const T*>(p.q) + q_row0 * D, q0, BQ, p.Sq, tid);
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) issue();

  // this lane's two rows (g and g + 8 of the warp's 16)
  const bool live = q0 + r0 < p.Sq;               // rows past Sq are never written
  const int qp[2] = {qw + g, qw + g + 8};
  int qseg[2] = {-1, -1};
  if (segments)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + r0 + g + 8 * i;
      if (r < p.Sq) qseg[i] = p.q_seg[(size_t)b * p.Sq + r];
    }
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DW / 8][4];
  zero(acc);
  const uint32_t hs = (p.seed * GOLDEN + (uint32_t)(b + p.b_off) * M3) ^
                      ((uint32_t)(h + p.h_off) + GOLDEN);
  const float inv_keep = 1.f / p.keep_div;
  const float sl2 = p.scale * LOG2E;

  cp_async_wait<NST - 2>();
  __syncthreads();
  typename M::A qf[NQF];
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t r[4];
      ld_a<false>(r, sQ, LD, r0, kk * M::K, lane);
      qf[kk] = M::make_a(r);
    }
  }

  for (int i = 0, cur = next_tile(0); cur < p.nk; ++i, cur = next_tile(cur + 1)) {
    const int st = i % NST;
    cp_async_wait<NST - 2>();
    __syncthreads();                      // tile cur landed; stage (i - 1) % NST is read
    issue();                              // the next tile loads while this one computes
    const int kv_start = cur * BKV;
    // a tile none of the warp's rows may read leaves their state as it is
    if (!live || (p.causal && kv_start > qw + 15) ||
        (p.window > 0 && kv_start + BKV - 1 <= qw - p.window))
      continue;
    const T* k_s = sK + st * BKV * LD;
    const T* v_s = sV + st * BKV * LD;

    // ---- S = Q K^T: the warp's 16 rows x 64 columns ----
    float s[BKV / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      typename M::A a;
      if constexpr (C::QREG) {
        a = qf[kk];
      } else {
        uint32_t r[4];
        ld_a<false>(r, sQ, LD, r0, kk * M::K, lane);
        a = M::make_a(r);
      }
#pragma unroll
      for (int j = 0; j < BKV / 8; j += 2) {
        uint32_t rb[4];
        ld_b2<false>(rb, k_s, LD, 8 * j, kk * M::K, lane);
        M::mma(s[j], a, M::make_b(rb[0], rb[1]));
        M::mma(s[j + 1], a, M::make_b(rb[2], rb[3]));
      }
    }

    // ---- scale and mask: no mask where every pair is allowed ----
    const bool inside = !segments && kv_start + BKV <= p.Skv &&
                        (!p.causal || kv_start + BKV - 1 <= qw) &&
                        (p.window <= 0 || kv_start > qw + 15 - p.window);
    if (inside)
      scale_mask<ACC16, false, BKV / 8>(s, p, sl2, kv_start, qp, qseg, nullptr, t);
    else
      scale_mask<ACC16, true, BKV / 8>(s, p, sl2, kv_start, qp, qseg,
                                       segments ? sKseg + st * BKV : nullptr, t);

    // ---- the online fold (common.py online_fold), base 2 ----
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = ex2(m[r] - m_new);
      const float m_safe = (m_new == NEG_INF) ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = ex2(s[j][e] - m_safe);
          sum += s[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;       // l sees pre-dropout probabilities
      m[r] = m_new;
    }
    if (p.dropout) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t kp = (uint32_t)(kv_start + 8 * j + 2 * t + (e & 1));
          const uint32_t x = (uint32_t)qp[e >> 1] * M1 + kp * M2 + hs;
          const bool keep = mix32(mix32(x) * M3 + GOLDEN) >= p.threshold;
          s[j][e] = keep ? s[j][e] * inv_keep : 0.f;
        }
    }

    // ---- acc = acc * alpha + P V over the warp's DW columns, P from S's
    // registers, NC n-tiles a pass ----
#pragma unroll
    for (int c0 = 0; c0 < DW / 8; c0 += NC) {
      float pv[NC][4];
      zero(pv);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        const typename M::A a = acc_to_a<T>(s, kk);
#pragma unroll
        for (int j = 0; j < NC; j += 2) {
          uint32_t rb[4];
          ld_b2_acc(rb, v_s, LD, c0w + 8 * (c0 + j), kk * M::K, lane);
          M::mma(pv[j], a, M::make_b(rb[0], rb[1]));
          M::mma(pv[j + 1], a, M::make_b(rb[2], rb[3]));
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 + j][e] = acc[c0 + j][e] * alpha[e >> 1] + (ACC16 ? round_bf16(pv[j][e]) : pv[j][e]);
    }
  }

  // ---- finalize: l_safe guard, o in q.dtype, lse in f32 ----
  if (!live) return;
  T* og = static_cast<T*>(p.o) + q_row0 * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + r0 + g + 8 * r;
    if (qr >= p.Sq) continue;
    const float l_safe = (l[r] == 0.f) ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DW / 8; ++j)
      store_pair(og + (size_t)qr * D + c0w + 8 * j + 2 * t, acc[j][2 * r] / l_safe,
                 acc[j][2 * r + 1] / l_safe);
    if (t == 0 && c0w == 0) p.lse[q_row0 + qr] = (m[r] == NEG_INF) ? NEG_INF : m[r] * LN2 + logf(l_safe);
  }
}

template <typename T, int D, bool ACC16>
int launch(FwdParams p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, D, ACC16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  p.nq = (p.Sq + C::BQ - 1) / C::BQ;
  p.nk = (p.Skv + C::BKV - 1) / C::BKV;
  const unsigned blocks = (unsigned)p.nq * p.Hq * p.B;
  fwd_kernel<T, D, ACC16><<<blocks, C::NT, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool ACC16>
int launch_d(const FwdParams& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, ACC16>(p, stream);
    case 32: return launch<T, 32, ACC16>(p, stream);
    case 64: return launch<T, 64, ACC16>(p, stream);
    case 80: return launch<T, 80, ACC16>(p, stream);
    case 128: return launch<T, 128, ACC16>(p, stream);
    case 256: return launch<T, 256, ACC16>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; acc_bf16: round each tile product to
// bf16 (bf16-ACC); D 16, 32, 64, 80, 128 or 256. Segment pointers are all null
// or all set; the segment bounds are over 64-row tiles. q, k, v, o are contiguous [B, H, S, D] of
// dtype, 16-byte aligned; lse [B, Hq, Sq] f32.
// batch_offset, head_offset: the global batch row and q head of the tensors'
// first ones, which the dropout mask hashes (a rank's shard of B or Hq).
// Returns the cudaError_t of the launch (0 = success).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, const int* q_seg, const int* kv_seg,
                     const int* qs_min, const int* qs_max, const int* ks_min,
                     const int* ks_max, int B, int Hq, int Hkv, int Sq, int Skv,
                     int D, int dtype, int acc_bf16, float scale, int causal,
                     int window,
                     int dropout, int seed, unsigned int threshold,
                     float keep_div, int batch_offset, int head_offset,
                     void* stream) {
  FwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_seg = q_seg; p.kv_seg = kv_seg;
  p.qs_min = qs_min; p.qs_max = qs_max; p.ks_min = ks_min; p.ks_max = ks_max;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv;
  p.nq = p.nk = 0;                        // set by launch for its BQ, BKV
  p.nq64 = (Sq + SUB - 1) / SUB;
  p.nk64 = (Skv + SUB - 1) / SUB;
  p.scale = scale; p.causal = causal; p.window = window;
  p.dropout = dropout; p.seed = (uint32_t)seed; p.threshold = threshold;
  p.keep_div = keep_div;
  p.b_off = batch_offset; p.h_off = head_offset;
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
