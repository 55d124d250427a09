// Helpers shared by the hand-written Hopper kernels (csrc/flash_fwd.cu,
// csrc/flash_bwd.cu, csrc/flash_decode.cu): cp.async copies into shared
// memory, and warp-level mma.sync on fragments loaded from shared memory or
// handed on in registers, 3xTF32 for f32 and one bf16 product for bf16. One
// copy, so the kernels keep the same f32 arithmetic that their 2e-5 / 5e-5
// tolerances rest on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- cp.async: src_bytes 0 zero-fills the destination without reading ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [row0, row0 + rows) of a [*, D] tensor into shared [rows][ld] by the
// block's NT threads, 16 bytes a request; rows past `valid` become zeros.
// Where NT is a multiple of the CH chunks of a row, a thread keeps one
// 16-byte column and steps NT / CH rows at a time, so a request costs two
// adds and a compare. Else (D 80: 20 f32 or 10 bf16 chunks a row) the
// block walks the rows x CH chunks flat, NT at a time.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                                          int valid, int tid) {
  constexpr int CH = D * (int)sizeof(T) / 16;         // 16-byte chunks a row
  constexpr int E = 16 / (int)sizeof(T);              // elements a chunk
  static_assert(D * (int)sizeof(T) % 16 == 0, "rows of whole 16-byte chunks");
  if constexpr (NT % CH == 0) {
    constexpr int RS = NT / CH;                       // rows a step
    const int r = tid / CH, c = (tid % CH) * E;
    const T* s = src + (size_t)(row0 + r) * D + c;
    T* d = dst + r * ld + c;
#pragma unroll 4
    for (int i = 0; r + i < rows; i += RS) {
      const bool ok = row0 + r + i < valid;
      cp_async16(d + i * ld, ok ? s + (size_t)i * D : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < rows * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * E;
      const bool ok = row0 + r < valid;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)(row0 + r) * D + c : src, ok ? 16 : 0);
    }
  }
}

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

// ---- an accumulator handed on as the next product's A operand ------------
// P (the accumulator of S = Q K^T, NT n-tiles of 8 columns) as the A operand
// of P V for k-step kk, straight from registers, rounded to T (P cast to the
// value type). bf16 (k 16): n-tiles 2kk and 2kk + 1, neighbouring columns
// packed into one register, which is m16n8k16's A layout. f32 (k 8): n-tile
// kk; TF32's A wants columns t and t + 4 of a lane's quad where the
// accumulator holds 2t and 2t + 1, so the k order is permuted rather than
// the values moved (A's column t carries column 2t, its column t + 4 column
// 2t + 1), and ld_b2_acc reads B's rows in that same order.
template <typename T, int NT>
__device__ __forceinline__ typename Mma<T>::A acc_to_a(const float (&c)[NT][4], int kk) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t r[4] = {bits(c[kk][0]), bits(c[kk][2]), bits(c[kk][1]), bits(c[kk][3])};
    return Mma<float>::make_a(r);
  } else {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * kk + (i >> 1)][2 * (i & 1)],
                                                     c[2 * kk + (i >> 1)][2 * (i & 1) + 1]);
      r[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return Mma<T>::make_a(r);
  }
}

// B of the two n-tiles at n0 and n0 + 8 for the k-step at k0 of a product
// whose A comes from acc_to_a, read from shared [k][n] (row-major, ld): f32
// rows k0 + 2t and k0 + 2t + 1 (acc_to_a's k order; ld = 4 mod 16 words
// puts the 32 lanes on distinct banks), bf16 the transposed ldmatrix.
__device__ __forceinline__ void ld_b2_acc(uint32_t (&r)[4], const float* s, int ld, int n0,
                                          int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* row = s + (k0 + 2 * t) * ld + n0 + g;
  r[0] = bits(row[0]);
  r[1] = bits(row[ld]);
  r[2] = bits(row[8]);
  r[3] = bits(row[ld + 8]);
}
__device__ __forceinline__ void ld_b2_acc(uint32_t (&r)[4], const __nv_bfloat16* s, int ld,
                                          int n0, int k0, int lane) {
  ld_b2<true>(r, s, ld, n0, k0, lane);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ void store_pair(float* s, float x0, float x1) {
  *reinterpret_cast<float2*>(s) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* s, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace
