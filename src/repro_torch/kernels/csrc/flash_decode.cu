// Flash-decode for Hopper (sm_90a), written by hand: one new query token per
// row against a KV cache, contiguous or paged.
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode.py:131
// `_contig_kernel`, :136 `_paged_kernel` and :144 `_paged_valid_kernel`, all
// -> `_decode_body` (:60), launched by `flash_decode` (:200),
// `flash_paged_decode` (:316) and `flash_paged_decode_partials` (:355). Per row b
// it computes softmax(q K^T * scale) V over the first kv_len[b] cache
// positions (kv_len == 0 gives exact zeros), optionally gated by a sliding
// window (kp > (kv_len - 1) - window). With num_splits > 1 each split folds
// its slice of KV tiles into raw f32 (acc, m, l) partials, which the wrapper
// merges with online_softmax.merge_many + finalize.
//
// What bounds it: one query row per head does 4 D operations per cached
// position on 2 D elements of K and V, far below the card's operations per
// byte, so it is bound by device memory: bytes(K) + bytes(V) of the rows
// inside kv_len and the window.
//
// What the design does about that: one thread block per (row, kv head,
// split) streams its K/V slice from device memory exactly once, and the
// whole GQA group of G = Hq / Hkv query heads (G = 4 for granite, 5 for
// qwen3; any G <= 8, no padding) shares every K/V tile it loads. Tiles past
// kv_len or outside the window are never loaded, and inside a tile only the
// rows the row may read are loaded (the rest are zero): a warp reads whole
// cache rows with 8- or 16-byte loads, resolving each row's offset once.
// Splits add parallel blocks when B * Hkv alone would leave SMs idle. The
// simple first version stages each tile in shared memory as f32;
// overlapping loads with compute (cp.async / TMA double buffering) is later
// work.
//
// The cache is read through a `Cache` type that maps (b, kv head, position)
// to the offset of that K/V row: `ContigCache` ([B, Hkv, S, D]) or
// `PagedCache`, a head-major page pool [Hkv, P, page_size, D] read through
// the row's block table [B, T]. A 128-row tile spans 128 / page_size pages
// (or part of one page), so the paged cache resolves every row on its own:
// the tile is not a page. JAX folds page-sized blocks instead; the two differ
// only in the order of f32 sums, and paged == contiguous on gathered pages is
// bit-exact here because both walk the same tiles. Table entries past a
// row's allocation name the trash page (0), which may hold anything (1e6
// under the engine's poison hook): such rows lie at positions >= kv_len or
// outside the window and are never loaded.
//
// The gated variant (`_paged_valid_kernel`, distributed paged serving) adds
// `valid [B, T]` to the paged cache: a shard of a page-sharded pool reads
// only the table entries it owns (valid != 0); the others name its local
// trash page. JAX gates whole page blocks; here the gate is per row, since a
// tile spans several pages, some owned and some not: a row is loaded only if
// it is inside kv_len and the window and its page is owned, every other row
// is zero and masked like a row past kv_len, so the positions folded are
// JAX's and only the order of f32 sums differs. A tile with no such row is
// skipped (`__syncthreads_or`); a shard may own nothing of a row, which then
// keeps m == NEG_INF, l == 0, acc == 0 (the m_safe guard). This variant always
// writes the raw f32 (acc, m, l) partials, even with one split: the caller
// merges them across shards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKV = 128;        // cache rows per tile (kernels/decode.py TILE)
constexpr int NTHREADS = 128;   // one score column per thread
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;         // largest GQA group handled
constexpr float NEG_INF = -1e30f;
static_assert(NTHREADS == BKV, "the tile loader resolves one row per thread");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_row_part(const T* src, float* out) {
  struct alignas(sizeof(T) * VEC) Pack { T v[VEC]; };
  const Pack pk = *reinterpret_cast<const Pack*>(src);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f(pk.v[e]);
}

// Contiguous cache [B, Hkv, S, D]: position pos of (b, hk) is row pos of
// that head's slab.
template <typename T, int D>
struct ContigCache {
  const T* k; const T* v; int Hkv, S;
  __device__ size_t row(int b, int hk, int pos) const {
    return (((size_t)b * Hkv + hk) * S + pos) * D;
  }
  __device__ bool owned(int, int) const { return true; }
};

// Paged cache: a head-major pool [Hkv, P, ps, D] shared by all rows, a
// block table [B, T] naming the physical page of each logical block and,
// for a shard of a sharded pool, `valid [B, T]` (0: not this shard's entry;
// null: every entry is owned).
template <typename T, int D>
struct PagedCache {
  const T* k; const T* v; const int* bt; const int* valid; int P, ps, width;
  __device__ size_t row(int b, int hk, int pos) const {
    const int page = bt[(size_t)b * width + pos / ps];
    return (((size_t)hk * P + page) * ps + pos % ps) * D;
  }
  __device__ bool owned(int b, int pos) const {
    return valid == nullptr || valid[(size_t)b * width + pos / ps] != 0;
  }
};

struct DecodeParams {
  const void* q;                 // [B, Hq, D]
  const int* kv_len;             // [B]
  void* o;                       // [B, Hq, D] (num_splits == 1) or null
  float* acc_part;               // [B, Hkv, ns, G, D] (when o is null)
  float* m_part; float* l_part;  // [B, Hkv, ns, G]
  int Hq, Hkv, G, S, nk, ns, nj;  // S: cache rows per row (T * ps when paged)
  float scale;
  int window;                    // <= 0: none
};

template <typename T, int D, typename Cache>
__global__ void __launch_bounds__(NTHREADS)
decode_kernel(const DecodeParams p, const Cache cache) {
  constexpr int RGRP = NTHREADS / D;               // row groups in the P.V phase
  constexpr int RPT = (MAXG + RGRP - 1) / RGRP;    // rows per thread there
  // tile loader: elements of a cache row a lane loads with one instruction
  // (8 or 16 bytes at f32); the wrapper checks that k/v are aligned to it
  constexpr int VEC = D >= 128 ? 4 : (D >= 64 ? 2 : 1);
  constexpr int LPR = D / VEC;                     // lanes a cache row
  constexpr int RPW = 32 / LPR;                    // rows a warp step
  static_assert(LPR <= 32 && 32 % LPR == 0, "a warp loads whole rows");
  extern __shared__ float smem[];
  float* sK = smem;                                // [BKV][D + 1]
  float* sV = sK + BKV * (D + 1);                  // [BKV][D]
  __shared__ float sQ[MAXG][D];
  __shared__ float sP[MAXG][BKV];
  __shared__ float sRed[NWARPS][MAXG];
  __shared__ float sM[MAXG], sL[MAXG], sAlpha[MAXG], sMsafe[MAXG];
  __shared__ long long sRow[BKV];                  // this tile's row offsets, -1: not read

  const int b = blockIdx.x, hk = blockIdx.y, split = blockIdx.z;
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
  const int c_ld = (lane % LPR) * VEC;             // tile loader: first column
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  const int ik_end = min((split + 1) * p.nj, p.nk);
  for (int ik = split * p.nj; ik < ik_end; ++ik) {
    const int kv_start = ik * BKV;
    if (kv_start >= kv_len) break;                 // past this row's cache
    if (p.window > 0 && kv_start + BKV - 1 <= q_pos - p.window) continue;

    __syncthreads();                               // last tile's readers done
    // one row per thread (NTHREADS == BKV): only rows this query reads, at
    // the same position as this thread's score column below
    const int kp = kv_start + tid;
    bool ok = kp < kv_len;                         // kv_len <= S bounds the last tile
    if (p.window > 0) ok &= kp > q_pos - p.window;
    ok = ok && cache.owned(b, kp);
    sRow[tid] = ok ? (long long)cache.row(b, hk, kp) : -1ll;
    if (!__syncthreads_or(ok)) continue;           // no row of this tile is read
    // LPR lanes load one row, VEC elements each, so a warp reads whole rows
    // (256 coalesced bytes a row at f32 D 64) and resolves each row once
#pragma unroll 4
    for (int r = warp * RPW + lane / LPR; r < BKV; r += NWARPS * RPW) {
      const long long base = sRow[r];
      float kx[VEC], vx[VEC];
      if (base >= 0) {
        load_row_part<T, VEC>(cache.k + base + c_ld, kx);
        load_row_part<T, VEC>(cache.v + base + c_ld, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sK[r * (D + 1) + c_ld + e] = kx[e];
        sV[r * D + c_ld + e] = vx[e];
      }
    }
    __syncthreads();

    // ---- scores of column j = tid for every group row ----
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

// The cache's pointers: k/v and, for a paged cache, the block table (null for
// a contiguous one), the ownership gate (null: all owned) and the pool's page
// count, page size and table width.
struct CacheArgs {
  const void* k; const void* v; const int* bt; const int* valid; int P, ps, width;
};

template <typename T, int D, typename Cache>
int launch_cache(const DecodeParams& p, const Cache& cache, int B,
                 cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (BKV * (D + 1) + BKV * D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, Cache>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, p.Hkv, p.ns);   // rows on x: B * S token rows may exceed 65535
  decode_kernel<T, D, Cache><<<grid, NTHREADS, smem, stream>>>(p, cache);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const DecodeParams& p, const CacheArgs& c, int B, cudaStream_t stream) {
  const T* k = static_cast<const T*>(c.k);
  const T* v = static_cast<const T*>(c.v);
  if (c.bt == nullptr)
    return launch_cache<T, D>(p, ContigCache<T, D>{k, v, p.Hkv, p.S}, B, stream);
  return launch_cache<T, D>(
      p, PagedCache<T, D>{k, v, c.bt, c.valid, c.P, c.ps, c.width}, B, stream);
}

template <typename T>
int launch_d(const DecodeParams& p, const CacheArgs& c, int B, int d,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, c, B, stream);
    case 32: return launch<T, 32>(p, c, B, stream);
    case 64: return launch<T, 64>(p, c, B, stream);
    case 128: return launch<T, 128>(p, c, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(const void* q, const CacheArgs& c, const int* kv_len, void* o,
               float* acc_part, float* m_part, float* l_part, int B, int Hq,
               int Hkv, int S, int D, int dtype, float scale, int window,
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
  // o: finalised output, one split only; else the f32 partials
  if (o != nullptr ? num_splits != 1
                   : (acc_part == nullptr || m_part == nullptr || l_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, c, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, c, B, D, s);
  return (int)cudaErrorInvalidValue;
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
  const CacheArgs c{k, v, nullptr, nullptr, 0, 0, 0};
  return launch_any(q, c, kv_len, o, acc_part, m_part, l_part, B, Hq, Hkv, S,
                    D, dtype, scale, window, num_splits, stream);
}

// The paged cache: k_pages/v_pages [Hkv, P, page_size, D], block_tables
// [B, T] int32 (every entry a valid page id; entries past a row's allocation
// name the trash page). Outputs and return value as flash_decode_launch.
int flash_paged_decode_launch(const void* q, const void* k_pages,
                              const void* v_pages, const int* block_tables,
                              const int* kv_len, void* o, float* acc_part,
                              float* m_part, float* l_part, int B, int Hq,
                              int Hkv, int P, int page_size, int T, int D,
                              int dtype, float scale, int window,
                              int num_splits, void* stream) {
  if (page_size < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const CacheArgs c{k_pages, v_pages, block_tables, nullptr, P, page_size, T};
  return launch_any(q, c, kv_len, o, acc_part, m_part, l_part, B, Hq, Hkv,
                    T * page_size, D, dtype, scale, window, num_splits, stream);
}

// The gated paged cache of one shard of a page-sharded pool: as
// flash_paged_decode_launch, plus block_valid [B, T] int32 (0: an entry this
// shard does not own, remapped to its local trash page; null: all owned).
// Always writes the raw f32 partials acc_part [B, Hkv, ns, G, D] and
// m_part / l_part [B, Hkv, ns, G], whatever the number of splits.
int flash_paged_decode_partials_launch(const void* q, const void* k_pages,
                                       const void* v_pages,
                                       const int* block_tables,
                                       const int* block_valid,
                                       const int* kv_len, float* acc_part,
                                       float* m_part, float* l_part, int B,
                                       int Hq, int Hkv, int P, int page_size,
                                       int T, int D, int dtype, float scale,
                                       int window, int num_splits,
                                       void* stream) {
  if (page_size < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const CacheArgs c{k_pages, v_pages, block_tables, block_valid, P, page_size, T};
  return launch_any(q, c, kv_len, nullptr, acc_part, m_part, l_part, B, Hq,
                    Hkv, T * page_size, D, dtype, scale, window, num_splits,
                    stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
