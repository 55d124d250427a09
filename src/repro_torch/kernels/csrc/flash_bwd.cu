// Fused attention backward for Hopper (sm_90a), written by hand: one kernel
// for dQ, dK and dV, with its products on tensor cores.
//
// Replaces both Pallas TPU kernels of src/repro/kernels/flash_bwd.py,
// `_dkv_kernel` (:98) and `_dq_kernel` (:164), launched by `flash_bwd` (:221).
// The TPU splits the backward into two passes only because it has no atomics
// to device memory (flash_bwd.py:1-15); this is the paper's one kernel
// (§3.3): a block owns a kv tile, accumulates dK/dV on chip and scatters dQ
// with atomic adds. It recomputes the probabilities from the forward's
// stored log-sum-exp,
//   P = exp(S * scale - lse_safe)      (lse_safe = 0 where lse == NEG_INF),
// so S and P never exist in device memory, and with
//   dP = dO V^T,  dS = P o (dP~ - delta) * scale,  delta = rowsum(dO o O),
// where P~ and dP~ carry the forward's dropout (the keep mask of
// kernels/rng.py, regenerated bit for bit from the coordinates):
//   dV += P~^T dO,   dK += dS^T Q,   dQ += dS K.
// q is the suffix of kv (q_offset = Skv - Sq); causal, sliding window,
// segment ids (negative = padding, zero gradient) and ragged tails are
// masked as in the forward; padded q rows and kv columns get no gradient.
// With ACC16 each tile product (S, dP, the dV/dK tile updates over 64 q rows
// and the dQ update over 64 kv rows) is rounded to bf16 before it is used or
// added in f32, which is what JAX's `preferred_element_type=bfloat16` does
// per 64-wide block; the dQ update is rounded before its atomic add.
//
// What bounds it: at training shapes (granite-3-2b: B 4, 32/8 heads, S 2048,
// D 64, causal) the work is 10 D flops per causal (q, k) pair and q head (S,
// dP, dV, dK, dQ at 2 D each) on O(S D) bytes: operations, not bytes.
//
// What the design does about that:
// - Tensor cores. Every product is an mma.sync. bf16 inputs use
//   m16n8k16 bf16 with f32 accumulators (exact products, JAX's
//   preferred_element_type=f32). f32 inputs use 3xTF32 on m16n8k8: each
//   operand is split as a = hi + lo, hi = tf32(a) rounded to nearest (ties
//   away, cvt.rna's rounding), lo = a - hi read as TF32 by the tensor core
//   (toward zero), and a product is lo*hi + hi*lo + hi*hi, small terms
//   first. That keeps about 2^-21 relative per product, inside f32's own
//   summation noise; one TF32 product (2^-11) cannot hold the JAX suite's
//   5e-5 gradient tolerance. The split happens as a fragment is loaded from
//   shared memory (ldmatrix where the operand is row-major).
// - One pass. One block per (kv tile, kv head, batch) keeps K and V in
//   shared memory and dK/dV in registers as mma accumulators while it loops
//   over the G q heads of its GQA group and the q tiles the causal, window
//   and segment skips leave: the group sum happens on chip in a fixed order,
//   so dK and dV are bit-reproducible. Warp w owns kv rows 16w..16w+15, so
//   S^T = K Q^T and dP^T = V dO^T come out in the rows of its dK/dV
//   accumulators. P~^T and dS^T go through shared memory (rounded to T, as
//   JAX casts them to q.dtype); dQ = dS K for the tile is computed by all
//   warps and added into an f32 buffer with atomicAdd (red.global.add.f32).
//   The order of those adds changes from run to run, so dQ is reproducible
//   only to f32 rounding. The wrapper zeroes the buffer; the kernel
//   allocates nothing.
// - Overlap. Q, dO, lse, delta (and q segment ids) of the next q tile are
//   loaded with cp.async into a second stage while the current one computes.
// - Balance. Blocks are numbered kv tile major, so under causal masking the
//   heaviest tiles (kv tile 0 sees every q tile) are scheduled first.
// Tile sizes: 64 q rows; 128 kv rows (8 warps) where K, V, two stages of
// Q/dO and the P~^T/dS^T tiles fit in shared memory, else 64 (4 warps) with
// one stage (f32 at D 128). Rows are padded by 16 bytes, so the fragment
// loads along rows are free of bank conflicts (those across rows 2-way).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile    (kernels/flash_bwd.py TILE)
constexpr int SUB = 64;         // the 64-row tile of the segment bounds and bf16-ACC
constexpr int SMEM_MAX = 232448;    // shared memory a block may use (227 KB)
constexpr float NEG_INF = -1e30f;   // core/online_softmax.py NEG_INF

// kernels/rng.py constants
constexpr uint32_t M1 = 0x85EBCA6Bu, M2 = 0xC2B2AE35u, M3 = 0x27D4EB2Fu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;

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
  float* dq;                                                // [B, Hq, Sq, D] f32, zeroed
  void* dk; void* dv;
  const int* q_seg; const int* kv_seg;                      // null: no segments
  const int* qs_min; const int* qs_max;                     // [B, nq]
  const int* ks_min; const int* ks_max;                     // [B, nk64]
  int B, Hq, Hkv, Sq, Skv, nq, nk64;
  float scale;
  int causal, window;                                       // window <= 0: none
  int dropout; uint32_t seed, threshold; float keep_div;    // keep_div = 1 - rate
};

// Shared-memory plan of one (T, D): kv rows a block, Q/dO stages, threads.
template <typename T, int D>
struct Cfg {
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int LD = D + PAD;          // K, V, Q, dO rows
  static constexpr int LDP = BQ + PAD;        // P~^T, dS^T rows
  __host__ __device__ static constexpr int bytes(int bkv, int stages) {
    return 4 * (3 * stages * BQ + bkv) +
           (int)sizeof(T) * (2 * bkv * LD + stages * 2 * BQ * LD + 2 * bkv * LDP);
  }
  static constexpr int BKV = bytes(128, 2) <= SMEM_MAX ? 128 : 64;
  static constexpr int STAGES = bytes(BKV, 2) <= SMEM_MAX ? 2 : 1;
  static constexpr int NW = BKV / 16;         // warps: 16 kv rows each
  static constexpr int NT = 32 * NW;
  static constexpr int SMEM = bytes(BKV, STAGES);
};

// ---- tensor-core fragments (PTX ISA, mma.m16n8k8 .tf32 / m16n8k16 .bf16) --
// An operand is read as a logical [row][k] matrix from shared memory stored
// row-major (TR false: element (r, c) at s[r * ld + c]) or transposed (TR
// true: at s[c * ld + r]). A is [m][k], B is [n][k] (mma's "col" layout).
// Row-major operands of both types and transposed bf16 ones load with
// ldmatrix (an f32 8x4 block is an 8x8 b16 matrix: lane L gets row L / 4,
// column L % 4, the tf32 fragment layout); transposed f32 ones element by
// element. Raw fragments are 32-bit registers: an f32, or two bf16.

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// A at (m0, k0): 16 x 8 f32 or 16 x 16 bf16
template <bool TR>
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], const float* s, int ld, int m0, int k0,
                                     int lane) {
  if (!TR) {
    ldsm_x4<false>(r, s + (m0 + (lane & 15)) * ld + k0 + 4 * (lane >> 4));
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  r[0] = bits(s[(k0 + t) * ld + m0 + g]);
  r[1] = bits(s[(k0 + t) * ld + m0 + g + 8]);
  r[2] = bits(s[(k0 + t + 4) * ld + m0 + g]);
  r[3] = bits(s[(k0 + t + 4) * ld + m0 + g + 8]);
}
template <bool TR>
__device__ __forceinline__ void ld_a(uint32_t (&r)[4], const __nv_bfloat16* s, int ld, int m0,
                                     int k0, int lane) {
  if (!TR)
    ldsm_x4<false>(r, s + (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
  else
    ldsm_x4<true>(r, s + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1));
}

// B of the two n-tiles at n0 and n0 + 8: {b0, b1} of the first, then the second
template <bool TR>
__device__ __forceinline__ void ld_b2(uint32_t (&r)[4], const float* s, int ld, int n0, int k0,
                                      int lane) {
  if (!TR) {
    ldsm_x4<false>(r, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 4 * ((lane >> 3) & 1));
    return;
  }
  const int g = lane >> 2, t = lane & 3;
  r[0] = bits(s[(k0 + t) * ld + n0 + g]);
  r[1] = bits(s[(k0 + t + 4) * ld + n0 + g]);
  r[2] = bits(s[(k0 + t) * ld + n0 + 8 + g]);
  r[3] = bits(s[(k0 + t + 4) * ld + n0 + 8 + g]);
}
template <bool TR>
__device__ __forceinline__ void ld_b2(uint32_t (&r)[4], const __nv_bfloat16* s, int ld, int n0,
                                      int k0, int lane) {
  if (!TR)
    ldsm_x4<false>(r, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1));
  else
    ldsm_x4<true>(r, s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4));
}

// B of one n-tile at n0
template <bool TR>
__device__ __forceinline__ void ld_b1(uint32_t (&r)[2], const float* s, int ld, int n0, int k0,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
  r[0] = bits(TR ? s[(k0 + t) * ld + n0 + g] : s[(n0 + g) * ld + k0 + t]);
  r[1] = bits(TR ? s[(k0 + t + 4) * ld + n0 + g] : s[(n0 + g) * ld + k0 + t + 4]);
}
template <bool TR>
__device__ __forceinline__ void ld_b1(uint32_t (&r)[2], const __nv_bfloat16* s, int ld, int n0,
                                      int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  for (int i = 0; i < 2; ++i) {
    const int k = k0 + 2 * t + 8 * i, n = n0 + g;
    r[i] = TR ? (uint32_t)u[k * ld + n] | ((uint32_t)u[(k + 1) * ld + n] << 16)
              : *reinterpret_cast<const uint32_t*>(s + n * ld + k);
  }
}

template <typename T> struct Mma;

template <> struct Mma<float> {
  static constexpr int K = 8;
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  // hi = tf32(x), rounded to nearest with ties away (cvt.rna's rounding, in
  // two integer ops: cvt.rna.tf32.f32 compiles to a longer sequence on
  // sm_90a); lo = x - hi, exact in f32, which the tensor core reads as TF32
  // by dropping its low 13 bits (toward zero, as CUTLASS's 3xTF32 does)
  static __device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
    hi = (x + 0x1000u) & 0xFFFFE000u;
    lo = bits(__uint_as_float(x) - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A make_a(const uint32_t (&r)[4]) {
    A a;
#pragma unroll
    for (int i = 0; i < 4; ++i) split(r[i], a.hi[i], a.lo[i]);
    return a;
  }
  static __device__ __forceinline__ B make_b(uint32_t r0, uint32_t r1) {
    B b;
    split(r0, b.hi[0], b.lo[0]);
    split(r1, b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ void one(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // 3xTF32, small terms first
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    one(c, a.lo, b.hi);
    one(c, a.hi, b.lo);
    one(c, a.hi, b.hi);
  }
};

template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ A make_a(const uint32_t (&r)[4]) {
    return A{{r[0], r[1], r[2], r[3]}};
  }
  static __device__ __forceinline__ B make_b(uint32_t r0, uint32_t r1) { return B{{r0, r1}}; }
  static __device__ __forceinline__ void mma(float (&c)[4], const A& a, const B& b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
};

// One warp: acc[j] += A[m0 .. m0+16, k0 .. k0+KD) B[n0+8j .. n0+8j+8, k0 .. k0+KD)^T.
// Accumulator element e of n-tile j sits at row m0 + lane/4 + 8 (e >> 1),
// column n0 + 8 j + 2 (lane % 4) + (e & 1).
template <typename T, int NT, int KD, bool TA, bool TB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const T* a, int lda, int m0,
                                          const T* b, int ldb, int n0, int k0, int lane) {
  using M = Mma<T>;
#pragma unroll
  for (int k = 0; k < KD; k += M::K) {
    uint32_t ra[4];
    ld_a<TA>(ra, a, lda, m0, k0 + k, lane);
    const typename M::A fa = M::make_a(ra);
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t rb[4];
      ld_b2<TB>(rb, b, ldb, n0 + 8 * j, k0 + k, lane);
      M::mma(acc[j], fa, M::make_b(rb[0], rb[1]));
      M::mma(acc[j + 1], fa, M::make_b(rb[2], rb[3]));
    }
    if (NT % 2) {
      uint32_t rb[2];
      ld_b1<TB>(rb, b, ldb, n0 + 8 * (NT - 1), k0 + k, lane);
      M::mma(acc[NT - 1], fa, M::make_b(rb[0], rb[1]));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += tmp (rounded to bf16 first with ACC16), element by element, in
// IEEE f32. The tensor core's own accumulation truncates, so one chain of
// mma into dK/dV over every q tile drifts toward zero: at the training shape
// (S 2048, a group of 4: 1024 3xTF32 k-steps a row) dK and dV came out
// 6.4e-5 and 6.9e-5 of max|dK|, max|dV| off the f32 plain version. Each
// tile's product is summed on its own (24 mma) and added here.
template <bool ACC16, int NT>
__device__ __forceinline__ void add_tile(float (&acc)[NT][4], const float (&tmp)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += ACC16 ? round_bf16(tmp[j][e]) : tmp[j][e];
}

__device__ __forceinline__ void store_pair(float* s, float x0, float x1) {
  *reinterpret_cast<float2*>(s) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* s, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(x0, x1);
}

// ---- cp.async ------------------------------------------------------------
// src-size 0 zero-fills the destination without reading the source

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;"); }

// rows [row0, row0 + rows) of a [*, D] tensor into shared [rows][ld];
// rows past `valid` become zeros
template <typename T, int D, int NT>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                                          int valid, int tid) {
  constexpr int CH = D * (int)sizeof(T) / 16;         // 16-byte chunks a row
  constexpr int PER = 16 / (int)sizeof(T);
  for (int i = tid; i < rows * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * PER;
    const bool ok = row0 + r < valid;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? row0 + r : 0) * D + c, ok);
  }
}

// Block-uniform tile skip, the `needed` test of both TPU kernels, for q
// tile iq (64 rows) and kv tile ik (bkv rows, bkv / 64 segment tiles).
__device__ __forceinline__ bool tile_needed(const BwdParams& p, int b, int iq, int ik,
                                            int bkv) {
  const int q_start = iq * BQ + (p.Skv - p.Sq);
  const int kv_start = ik * bkv;
  if (p.causal && kv_start > q_start + BQ - 1) return false;
  if (p.window > 0 && kv_start + bkv - 1 <= q_start - p.window) return false;
  if (p.q_seg == nullptr) return true;
  const int lo = p.qs_min[b * p.nq + iq], hi = p.qs_max[b * p.nq + iq];
  for (int s = kv_start / SUB; s < p.nk64 && s < (kv_start + bkv) / SUB; ++s)
    if (p.ks_min[b * p.nk64 + s] <= hi && p.ks_max[b * p.nk64 + s] >= lo) return true;
  return false;
}

// The elementwise step on the warp's S^T and dP^T fragments (kv rows r0 +
// lane/4 (+ 8), q columns 8 j + 2 (lane % 4) (+ 1) of the tile): the mask
// (MASK false: every pair is allowed and in range), P from lse, dropout and
// dS. Leaves P~ in s and dS in dp.
template <bool ACC16, bool MASK, int BKV>
__device__ __forceinline__ void probs(const BwdParams& p, float (&s)[BQ / 8][4],
                                      float (&dp)[BQ / 8][4], const float* lse_s,
                                      const float* delta_s, const int* qseg_s,
                                      const int* sKseg, int b, int h, int q0, int kv_start,
                                      int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int q_shift = p.Skv - p.Sq;
  const uint32_t hs = (p.seed * GOLDEN + (uint32_t)b * M3) ^ ((uint32_t)h + GOLDEN);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1);          // kv row in the tile
      const int c = 8 * j + 2 * t + (e & 1);        // q row in the tile
      const int qp = q0 + c + q_shift, kp = kv_start + r;
      bool ok = true;
      if (MASK) {
        ok = q0 + c < p.Sq && kp < p.Skv;
        if (p.causal) ok &= kp <= qp;
        if (p.window > 0) ok &= kp > qp - p.window;
        if (p.q_seg != nullptr) ok &= (qseg_s[c] == sKseg[r]) && (qseg_s[c] >= 0);
      }
      float sv = s[j][e], dpv = dp[j][e];
      if (ACC16) {
        sv = round_bf16(sv);
        dpv = round_bf16(dpv);
      }
      const float lse = lse_s[c];
      const float lse_safe = (lse == NEG_INF) ? 0.f : lse;   // flash_bwd.py:68
      const float prob = ok ? __expf(sv * p.scale - lse_safe) : 0.f;
      float pk = prob;
      if (p.dropout) {
        const uint32_t x = (uint32_t)qp * M1 + (uint32_t)kp * M2 + hs;
        const bool keep = mix32(mix32(x) * M3 + GOLDEN) >= p.threshold;
        pk = keep ? prob / p.keep_div : 0.f;
        dpv = keep ? dpv / p.keep_div : 0.f;
      }
      s[j][e] = pk;
      dp[j][e] = prob * (dpv - delta_s[c]) * p.scale;
    }
}

template <typename T, int D, bool ACC16>
__global__ void __launch_bounds__(Cfg<T, D>::NT, 1) flash_bwd_kernel(const BwdParams p) {
  using C = Cfg<T, D>;
  constexpr int BKV = C::BKV, NT = C::NT, LD = C::LD, LDP = C::LDP, ST = C::STAGES;
  constexpr int WPR = C::NW / 4;          // warps sharing 16 q rows of the dQ product
  constexpr int NTQ = D / 8 / WPR;        // dQ n-tiles a warp
  constexpr int KCQ = ACC16 ? SUB : BKV;  // kv rows a rounded dQ update sums
  extern __shared__ __align__(16) unsigned char smem[];
  float* sLse = reinterpret_cast<float*>(smem);       // [ST][BQ]
  float* sDelta = sLse + ST * BQ;                     // [ST][BQ]
  int* sQseg = reinterpret_cast<int*>(sDelta + ST * BQ);   // [ST][BQ]
  int* sKseg = sQseg + ST * BQ;                       // [BKV]
  T* sK = reinterpret_cast<T*>(sKseg + BKV);          // [BKV][LD]
  T* sV = sK + BKV * LD;                              // [BKV][LD]
  T* sQ = sV + BKV * LD;                              // [ST][BQ][LD]
  T* sdO = sQ + ST * BQ * LD;                         // [ST][BQ][LD]
  T* sP = sdO + ST * BQ * LD;                         // P~^T [BKV][LDP]
  T* sdS = sP + BKV * LDP;                            // dS^T [BKV][LDP]

  // kv tile major: under causal masking the heaviest tiles start first
  const int ik = blockIdx.x / (p.B * p.Hkv);
  const int b = (blockIdx.x / p.Hkv) % p.B, hk = blockIdx.x % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kv_start = ik * BKV, r0 = 16 * warp;
  const size_t kv_off = (size_t)(b * p.Hkv + hk) * p.Skv * D;
  const bool segments = p.q_seg != nullptr;
  const int q_shift = p.Skv - p.Sq;

  load_rows<T, D, NT>(sK, LD, static_cast<const T*>(p.k) + kv_off, kv_start, BKV, p.Skv, tid);
  load_rows<T, D, NT>(sV, LD, static_cast<const T*>(p.v) + kv_off, kv_start, BKV, p.Skv, tid);
  if (segments)
    for (int i = tid; i < BKV; i += NT)
      sKseg[i] = (kv_start + i < p.Skv) ? p.kv_seg[(size_t)b * p.Skv + kv_start + i] : -1;

  // the (q head, q tile) items of the group, head major; skipped tiles dropped
  const int n_items = G * p.nq;
  auto next_item = [&](int it) {
    while (it < n_items && !tile_needed(p, b, it % p.nq, ik, BKV)) ++it;
    return it;
  };
  // Q, dO, lse, delta and q segment ids of an item into stage `st`
  auto load_q_tile = [&](int it, int st) {
    const int h = hk * G + it / p.nq, q0 = (it % p.nq) * BQ;
    const size_t row = (size_t)(b * p.Hq + h) * p.Sq;
    load_rows<T, D, NT>(sQ + st * BQ * LD, LD, static_cast<const T*>(p.q) + row * D, q0, BQ,
                        p.Sq, tid);
    load_rows<T, D, NT>(sdO + st * BQ * LD, LD, static_cast<const T*>(p.dout) + row * D, q0,
                        BQ, p.Sq, tid);
    for (int i = tid; i < BQ; i += NT) {
      const bool ok = q0 + i < p.Sq;
      const size_t at = ok ? row + q0 + i : row;
      cp_async4(sLse + st * BQ + i, p.lse + at, ok);
      cp_async4(sDelta + st * BQ + i, p.delta + at, ok);
      if (segments)
        cp_async4(sQseg + st * BQ + i, p.q_seg + (size_t)b * p.Sq + (ok ? q0 + i : 0), ok);
    }
  };

  int cur = next_item(0);
  if (ST == 2 && cur < n_items) load_q_tile(cur, 0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];       // kv rows r0 + g (+ 8), all D columns
  zero(dk);
  zero(dv);

  for (int i = 0; cur < n_items; ++i) {
    const int nxt = next_item(cur + 1);
    const int st = ST == 2 ? (i & 1) : 0;
    if (ST == 1) {
      __syncthreads();                    // the last tile's readers are done
      load_q_tile(cur, 0);
      cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();                      // this tile landed; the last one is read
    if (ST == 2 && nxt < n_items) {       // the next tile loads while this computes
      load_q_tile(nxt, st ^ 1);
      cp_async_commit();
    }
    const int h = hk * G + cur / p.nq, q0 = (cur % p.nq) * BQ;
    const T* q_s = sQ + st * BQ * LD;
    const T* do_s = sdO + st * BQ * LD;
    const float* lse_s = sLse + st * BQ;
    const float* delta_s = sDelta + st * BQ;
    const int* qseg_s = sQseg + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T on the warp's 16 kv rows x 64 q columns
    float s[BQ / 8][4], dp[BQ / 8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, BQ / 8, D, false, false>(s, sK, LD, r0, q_s, LD, 0, 0, lane);
    warp_gemm<T, BQ / 8, D, false, false>(dp, sV, LD, r0, do_s, LD, 0, 0, lane);

    // mask, P from lse, dropout, dS; P~ into s, dS into dp. A tile whose
    // every pair is allowed and in range skips the mask.
    const int qp0 = q0 + q_shift;
    const bool inside = !segments && q0 + BQ <= p.Sq && kv_start + BKV <= p.Skv &&
                        (!p.causal || kv_start + BKV - 1 <= qp0) &&
                        (p.window <= 0 || kv_start > qp0 + BQ - 1 - p.window);
    if (inside)
      probs<ACC16, false, BKV>(p, s, dp, lse_s, delta_s, qseg_s, sKseg, b, h, q0, kv_start, r0,
                               lane);
    else
      probs<ACC16, true, BKV>(p, s, dp, lse_s, delta_s, qseg_s, sKseg, b, h, q0, kv_start, r0,
                              lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = 8 * j + 2 * t;
      store_pair(sP + (r0 + g) * LDP + c, s[j][0], s[j][1]);
      store_pair(sP + (r0 + g + 8) * LDP + c, s[j][2], s[j][3]);
      store_pair(sdS + (r0 + g) * LDP + c, dp[j][0], dp[j][1]);
      store_pair(sdS + (r0 + g + 8) * LDP + c, dp[j][2], dp[j][3]);
    }
    __syncwarp();

    // dV += P~^T dO and dK += dS^T Q over this tile's 64 q rows (own kv rows)
    {
      float tmp[D / 8][4];
      zero(tmp);
      warp_gemm<T, D / 8, BQ, false, true>(tmp, sP, LDP, r0, do_s, LD, 0, 0, lane);
      add_tile<ACC16>(dv, tmp);
      zero(tmp);
      warp_gemm<T, D / 8, BQ, false, true>(tmp, sdS, LDP, r0, q_s, LD, 0, 0, lane);
      add_tile<ACC16>(dk, tmp);
    }
    __syncthreads();                      // every warp's dS^T rows are written

    // dQ += dS K: the warp owns q rows qm0 .. qm0+16 and D / WPR columns
    const int qm0 = 16 * (warp % 4), dn0 = (warp / 4) * (D / WPR);
    float dq[NTQ][4];
    zero(dq);
#pragma unroll
    for (int kc = 0; kc < BKV; kc += KCQ) {
      if (ACC16) {
        float tmp[NTQ][4];
        zero(tmp);
        warp_gemm<T, NTQ, KCQ, true, true>(tmp, sdS, LDP, qm0, sK, LD, dn0, kc, lane);
        add_tile<true>(dq, tmp);
      } else {
        warp_gemm<T, NTQ, KCQ, true, true>(dq, sdS, LDP, qm0, sK, LD, dn0, kc, lane);
      }
    }
    float* dqg = p.dq + (size_t)(b * p.Hq + h) * p.Sq * D;
#pragma unroll
    for (int j = 0; j < NTQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = q0 + qm0 + g + 8 * (e >> 1);
        if (qr < p.Sq) atomicAdd(dqg + (size_t)qr * D + dn0 + 8 * j + 2 * t + (e & 1), dq[j][e]);
      }
    cur = nxt;
  }

  // dK and dV once, summed over the group on chip
  T* dkg = static_cast<T*>(p.dk) + kv_off;
  T* dvg = static_cast<T*>(p.dv) + kv_off;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = kv_start + r0 + g + 8 * (e >> 1);
      if (kr >= p.Skv) continue;
      const size_t at = (size_t)kr * D + 8 * j + 2 * t + (e & 1);
      dkg[at] = from_f<T>(dk[j][e]);
      dvg[at] = from_f<T>(dv[j][e]);
    }
}

template <typename T, int D, bool ACC16>
int launch(const BwdParams& p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<T, D, ACC16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.Skv + C::BKV - 1) / C::BKV * p.B * p.Hkv;
  flash_bwd_kernel<T, D, ACC16><<<blocks, C::NT, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool ACC16>
int launch_d(const BwdParams& p, int d, cudaStream_t stream) {
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
// bf16. Segment pointers are all null or all set. q, k, v, dout, dk, dv are
// contiguous [B, H, S, D] of dtype, 16-byte aligned; dq is a zeroed f32
// [B, Hq, Sq, D] that the kernel adds into; lse and delta [B, Hq, Sq] f32.
// Returns the cudaError_t of the launch (0 = success).
int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, float* dq, void* dk, void* dv,
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
  p.nk64 = (Skv + SUB - 1) / SUB;
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
