// Tensor-core helpers shared by the hand-written Hopper kernels
// (csrc/flash_bwd.cu, csrc/flash_decode.cu): warp-level mma.sync on
// fragments loaded from shared memory, 3xTF32 for f32 and one bf16 product
// for bf16. One copy, so both kernels keep the same f32 arithmetic that
// their 2e-5 / 5e-5 tolerances rest on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ void store_pair(float* s, float x0, float x1) {
  *reinterpret_cast<float2*>(s) = make_float2(x0, x1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* s, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace
