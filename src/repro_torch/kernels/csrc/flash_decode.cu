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
// What bounds it. At the decode shape (a batch of rows, each its own
// sequence) one query row per head does 4 D operations per cached position
// on 2 D elements of K and V: bound by device-memory bytes, the K/V rows
// inside kv_len and the window. At a chunk or verify launch (many token rows
// of one sequence reading one table) those bytes are shared by every row, so
// the bound is first the bytes of the distinct K/V rows and then the FMA
// work of the rows' scores and P.V.
//
// What the design does about it:
// - Fill the card: split-KV inside a thread-block cluster. Each block owns
//   (rows, kv head, split, cluster rank). The C blocks of a cluster
//   deal the split's 64-row KV tiles among them (rank c takes tiles c, c+C,
//   ...), and rank 0 folds ranks 1..C-1 in that order through distributed
//   shared memory into its own state before it writes o or the partials: no
//   second launch, no global scratch, the same sums every launch. C (1, 2,
//   4 or 8, at most the tiles of a split) is the least that puts one block
//   on every SM: the engine's decode shape (8 rows x 8 kv heads) launches 64
//   clusters of 4. It depends on the rows, Hkv, the splits and the tile
//   count only, so the contiguous and the paged cache take the same
//   geometry.
// - Pipeline the tiles: K and V are staged in their stored dtype (bf16 stays
//   bf16) in a ring of 2 stages, filled by cp.async, 16
//   bytes a lane, each row's offset resolved through the table. The next
//   tiles' loads are in flight while this tile's scores and P.V run; one
//   block barrier a tile. Row maxima and sums are reduced inside the 16
//   lanes that hold a row (shuffles), never across warps.
// - Query tiles: the caller of a chunked-prefill or verify launch, which
//   flattens S token rows of each batch row into rows of their own, says
//   so (row_tokens = S); the launch then cuts its rows into groups of R =
//   min(S, 16, 64 / G) consecutive rows. The block compares their tables
//   (and ownership masks): consecutive rows with one table are a run, whose
//   R_run * G query rows fold every K/V tile loaded once, each row masked
//   by its own kv_len and window. A row whose table differs from its
//   neighbours' (a packed chunk's span boundary, padding) is a run of one:
//   the per-row path of the same code. A decode launch (row_tokens 1, each
//   row its own sequence) gives every row a block of its own, however many
//   rows it has. A query-tiled block is 8 warps over 64 query rows: q K^T
//   and P V run on tensor cores (mma.sync; 3xTF32 for f32, which holds the
//   2e-5 tolerance where one TF32 product cannot, one bf16 product for
//   bf16), the softmax on the mma fragments, each row's max and sum joined
//   across the two warps that hold its halves. A one-row block (decode) is
//   4 warps over 8 query rows in f32 FMA from shared memory: it is bound by
//   bytes, not operations.
// - Head dim 256 (recurrentgemma-2b: 10 query heads on one kv head). The
//   ring's tiles are 32 rows, half a split's tile (two 64-row f32 stages
//   would be 266 KB): the split and cluster layout stays in 64-row tiles,
//   and rank c of a cluster takes the 32-row tiles c, c + C, ... of its
//   split. A one-row block is 8 warps, 16 query rows, which holds a group
//   of 10 (up to 16; 8 below D 256). A query-tiled block takes
//   min(S, 16, 64 / G) token rows as at any D: 6 at a group of 10. Its P.V
//   runs in passes of 8 n-tiles, so that the 16 n-tiles of a warp's half
//   of D are not all live at once beside the accumulator.
// - Masks are selects, never products: a cache row that no query row of the
//   run may read (past kv_len, outside the window, a page the shard does
//   not own: possibly the trash page, 1e6 under the engine's poison hook) is
//   never read; cp.async zero-fills its slot. A row that one query row reads
//   and another may not gets score NEG_INF and P exactly 0 for the other. A
//   row that reads nothing keeps m == NEG_INF, l == 0, acc == 0 (the m_safe
//   guard), so kv_len 0 gives exact zeros and a shard that owns nothing of a
//   row the empty state.
//
// A row's arithmetic on either path (one row: each score a chain of fmaf
// over d, the row max and sum over the same 16 lanes, P.V a chain over the
// tile's rows; query tiles: each score and P.V element one mma chain, the
// max and sum over the same quad and warp pair; then the cluster merge)
// does not depend on the run it is folded in, and the geometry depends on
// the sizes and row_tokens only, the same for both caches: so paged ==
// contiguous on gathered pages is bit-exact at equal row_tokens. The two
// paths differ in rounding (FMA against 3xTF32), within the tolerance.
// JAX folds page-sized blocks; the results differ only in the order of f32
// sums.
//
// The cache is read through a `Cache` type that maps (b, kv head, position)
// to the offset of that K/V row: `ContigCache` ([B, Hkv, S, D]) or
// `PagedCache`, a head-major page pool [Hkv, P, page_size, D] read through
// the row's block table [B, T]. A 64-row tile spans 64 / page_size pages (or
// part of one), so every row resolves its own page. Table entries past a
// row's allocation name the trash page (0). The gated variant
// (`_paged_valid_kernel`, distributed paged serving) adds `valid [B, T]`: a
// shard reads only the entries it owns (valid != 0), the gate per row as a
// tile spans owned and foreign pages; a tile with no owned page is skipped.
// It always writes the raw f32 (acc, m, l) partials, even with one split:
// the caller merges them across shards.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BKV = 64;         // cache rows a split's tile (kernels/decode.py TILE)
constexpr int CL = 16;          // lanes of a row group (a warp holds two)
constexpr int QMAX = 64;        // query rows of a query-tiled block
constexpr int MAXR = 16;        // token rows of a query-tiled block
constexpr int MAXC = 8;         // largest cluster (the portable size)
constexpr float NEG_INF = -1e30f;
static_assert(BKV % CL == 0, "thread layout");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements of T at p (aligned to their size) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  struct alignas(sizeof(T) * N) Pack { T v[N]; };
  const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = to_f(pk.v[e]);
}

// Contiguous cache [B, Hkv, S, D]: position pos of (b, hk) is row pos of
// that head's slab; no two rows share a cache.
template <typename T, int D>
struct ContigCache {
  const T* k; const T* v; int Hkv, S;
  __device__ size_t row(int b, int hk, int pos) const {
    return (((size_t)b * Hkv + hk) * S + pos) * D;
  }
  __device__ bool owned(int, int) const { return true; }
  __device__ bool any_owned(int, int, int) const { return true; }
  __device__ bool differ(int, int, int) const { return true; }
  __device__ int entries() const { return 1; }
};

// Paged cache: a head-major pool [Hkv, P, ps, D] shared by all rows, a
// block table [B, T] naming the physical page of each logical block and,
// for a shard of a sharded pool, `valid [B, T]` (0: not this shard's entry;
// null: every entry is owned). `shift` is log2(ps) when ps is a power of
// two, else -1: the tile loader and the ownership checks of the score
// columns divide by ps every tile, and the shift is measurably quicker on
// the gated kernel at the chunk shape (PERF.md, the decode findings).
template <typename T, int D>
struct PagedCache {
  const T* k; const T* v; const int* bt; const int* valid; int P, ps, width, shift;
  __device__ int block(int pos) const { return shift >= 0 ? pos >> shift : pos / ps; }
  __device__ size_t row(int b, int hk, int pos) const {
    const int j = block(pos);
    const int page = bt[(size_t)b * width + j];
    return (((size_t)hk * P + page) * ps + (pos - j * ps)) * D;
  }
  __device__ bool owned(int b, int pos) const {
    return valid == nullptr || valid[(size_t)b * width + block(pos)] != 0;
  }
  // does row b own a page holding a position in [lo, hi)?
  __device__ bool any_owned(int b, int lo, int hi) const {
    if (valid == nullptr) return true;
    for (int j = block(lo); j <= block(hi - 1); ++j)
      if (valid[(size_t)b * width + j] != 0) return true;
    return false;
  }
  // do rows a and b differ at table entry j (or in its ownership)?
  __device__ bool differ(int a, int b, int j) const {
    const size_t ia = (size_t)a * width + j, ib = (size_t)b * width + j;
    return bt[ia] != bt[ib] || (valid != nullptr && valid[ia] != valid[ib]);
  }
  __device__ int entries() const { return width; }
};

struct DecodeParams {
  const void* q;                 // [B, Hq, D]
  const int* kv_len;             // [B]
  void* o;                       // [B, Hq, D] (num_splits == 1) or null
  float* acc_part;               // [B, Hkv, ns, G, D] (when o is null)
  float* m_part; float* l_part;  // [B, Hkv, ns, G]
  int B, Hq, Hkv, G, S, nk, ns, nj;  // S: cache rows per row (T * ps when paged)
  int R;                         // token rows a block
  int C;                         // blocks a cluster
  float scale;
  int window;                    // <= 0: none
};

// the two warps of a query-tile row block (warps w and w + 4) meet here
__device__ __forceinline__ void pair_sync(int mt) {
  asm volatile("bar.sync %0, 64;" :: "r"(1 + mt) : "memory");
}

// The layout of one instantiation. One token row a block (TILED false): 4
// warps of two 16-lane row groups, one query row a group (8 a block; at D
// 256, 8 warps and 16 rows, for recurrentgemma's group of 10), f32 FMA.
// Query tiles (TILED true): 8 warps, 64 query rows on tensor cores, warp w
// takes the 16 rows of m-tile w % 4 and half w / 4 of the tile's columns
// (scores) and of D (P.V). Shared memory: the K and V rings in T, then q
// and P (f32 for one row, T for query tiles). Rows are padded so that the
// lanes that read different rows together hit different banks. The ring's
// tiles are BK rows: the split's 64-row tiles, or halves of them at D 256,
// where two 64-row f32 stages alone would be 266 KB.
template <typename T, int D, bool TILED>
struct Smem {
  using QT = typename std::conditional<TILED, T, float>::type;
  static constexpr int NT = TILED || D > 128 ? 256 : 128;   // threads a block
  static constexpr int QROWS = TILED ? QMAX : NT / CL;      // query rows
  static constexpr int NSTAGE = 2;
  static constexpr int BK = D > 128 ? BKV / 2 : BKV;        // rows a ring tile
  // elements; V's 8-element pad serves the query tiles' transposed loads,
  // and a one-row block keeps 16 bytes so that three fit on an SM
  static constexpr int LDK = D + 16 / (int)sizeof(T), LDV = TILED ? D + 8 : LDK;
  static constexpr int LDQ = D + 16 / (int)sizeof(QT), LDP = BK + 16 / (int)sizeof(QT);
  static constexpr size_t STAGE = (size_t)BK * (LDK + LDV) * sizeof(T);
  static constexpr size_t RING = NSTAGE * STAGE;
  static constexpr size_t BYTES = RING + sizeof(QT) * QROWS * (LDQ + LDP);
  static_assert(sizeof(float) * QROWS * D <= RING, "merge buffer fits the ring");
  static_assert(BYTES <= 232448, "a block's shared memory");
  static_assert(BKV % BK == 0 && BK % CL == 0 && BK % 16 == 0, "tiles");
};

// The largest GQA group a one-row block holds at head dim d (its QROWS):
// the query-tiled block takes any group up to its 64 query rows.
__host__ __device__ constexpr int max_group(int d) { return d > 128 ? 16 : 8; }

template <typename T, int D, typename Cache, bool TILED>
__global__ void __launch_bounds__(Smem<T, D, TILED>::NT)
decode_kernel(const DecodeParams p, const Cache cache) {
  using SM = Smem<T, D, TILED>;
  using QT = typename SM::QT;
  constexpr int NSTAGE = SM::NSTAGE, LDK = SM::LDK, LDV = SM::LDV, LDQ = SM::LDQ,
                LDP = SM::LDP, NTHREADS = SM::NT, BK = SM::BK;
  constexpr int SUBT = BKV / BK;                   // ring tiles a split tile
  constexpr int VE = 16 / (int)sizeof(T);          // elements of a 16-byte chunk
  constexpr int CPR = D / VE;                      // chunks a cache row
  constexpr int NJ = BK / CL;                      // one row: score columns a lane
  constexpr int NS = BK / 16;                      // query tiles: a half's score n-tiles
  constexpr int NPV = D / 16 < 8 ? D / 16 : 8;     // ... P.V n-tiles a pass
  constexpr int VC = D / CL;                       // one row: output columns a lane
  constexpr int VW = VC < 4 ? VC : 4;              // ... loaded at once
  constexpr int NU = VC / VW;
  constexpr int NR = TILED ? 2 : 1;                // query rows a thread
  // the state's accumulator: one row [1][VC]; query tiles [D / 16][4], the
  // mma fragments of the warp's half of D
  constexpr int A0 = TILED ? D / 16 : 1, A1 = TILED ? 4 : VC;
  constexpr int ITEMS = (BK * CPR + NTHREADS - 1) / NTHREADS;   // 16-byte copies a lane
  constexpr int QITEMS = (SM::QROWS * CPR + NTHREADS - 1) / NTHREADS;  // ... of q
  static_assert(D % VE == 0 && VC % VW == 0 && VE % 4 == 0 && D % 16 == 0, "layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);                        // [NSTAGE][BK][LDK]
  T* sV = sK + NSTAGE * BK * LDK;                                // [NSTAGE][BK][LDV]
  QT* sQ = reinterpret_cast<QT*>(smem_raw + SM::RING);           // [QROWS][LDQ]
  QT* sP = sQ + SM::QROWS * LDQ;                                 // [QROWS][LDP]
  float* sAcc = reinterpret_cast<float*>(smem_raw);              // merge: [QROWS][D]
  __shared__ float sM[QMAX], sL[QMAX];                           // merge: m, l
  __shared__ float sRed[2][2][QMAX];     // query tiles: each half's row max, sum
  __shared__ int sLo[MAXR], sHi[MAXR];                           // rows' [lo, hi)
  __shared__ int sRun[MAXR];                                     // 1: starts a run

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)(blockIdx.x % p.C);
  const int r0 = (int)(blockIdx.x / p.C) * p.R;
  const int hk = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = lane % CL, rg = warp * 2 + lane / CL;  // one row: column lane, row group
  const int mt = warp & 3, nh = warp >> 2;             // query tiles: m-tile, half
  const int qg = lane >> 2, q4 = lane & 3;             // ... the fragment's row, column
  const int G = p.G;
  const int nrows = min(p.R, p.B - r0);
  // this thread's query row i, and the column of its accumulator element (a, b)
  auto qrow = [&](int i) { return TILED ? 16 * mt + qg + 8 * i : rg; };
  auto slot = [&](int a, int b) { return TILED ? b >> 1 : 0; };
  auto col = [&](int a, int b) {
    return TILED ? nh * (D / 2) + 8 * a + 2 * q4 + (b & 1)
                 : (b / VW) * CL * VW + cl * VW + b % VW;
  };
  // the thread that publishes a row's m and l
  const bool row_owner = TILED ? (nh == 0 && q4 == 0) : cl == 0;

  if (tid < nrows) {
    const int kvl = max(0, min(p.kv_len[r0 + tid], p.S));
    sHi[tid] = kvl;
    sLo[tid] = p.window > 0 ? max(0, kvl - p.window) : 0;
    sRun[tid] = tid == 0;
  }
  if (nrows > 1) {                                 // runs: rows whose tables differ
    __syncthreads();                               // from the row before start one
    const int w = cache.entries();
    for (int e = tid; e < (nrows - 1) * w; e += NTHREADS)
      if (cache.differ(r0 + e / w, r0 + e / w + 1, e % w)) sRun[e / w + 1] = 1;
  }
  __syncthreads();

  // the split's ring tiles (SUBT a split tile), dealt over the cluster
  const int t_first = split * p.nj * SUBT, t_end = min((split + 1) * p.nj, p.nk) * SUBT;
  for (int ra = 0; ra < nrows;) {
    int rb = ra + 1;
    while (rb < nrows && !sRun[rb]) ++rb;          // the run [ra, rb)
    const int nq = (rb - ra) * G;                  // its query rows
    const int b_run = r0 + ra;                     // its first row
    int lo_min = p.S, hi_max = 0;
    for (int r = ra; r < rb; ++r)
      if (sHi[r] > sLo[r]) { lo_min = min(lo_min, sLo[r]); hi_max = max(hi_max, sHi[r]); }

    // this thread's query rows: their readable positions [lo, hi)
    int lo[NR], hi[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int qr = qrow(i);
      lo[i] = qr < nq ? sLo[ra + qr / G] : 0;
      hi[i] = qr < nq ? sHi[ra + qr / G] : 0;
    }
    // the warp holds a query row (query tiles: both warps of the row block)
    const bool busy = TILED ? 16 * mt < nq : 2 * warp < nq;

    // is position kp read by some query row of the run (and owned)?
    auto loaded = [&](int kp) {
      if (kp < lo_min || kp >= hi_max || !cache.owned(b_run, kp)) return false;
      for (int r = ra; r < rb; ++r)
        if (kp >= sLo[r] && kp < sHi[r]) return true;
      return false;
    };
    // next tile of this rank at or after t that some row reads, or -1
    auto next_tile = [&](int t) {
      for (; t < t_end; t += p.C) {
        const int lo_t = max(t * BK, lo_min), hi_t = min(t * BK + BK, hi_max);
        if (lo_t < hi_t && cache.any_owned(b_run, lo_t, hi_t)) return t;
      }
      return -1;
    };
    // a tile's copies: the offsets of the next tile to load are resolved
    // (table reads in flight) one tile ahead, while this tile computes;
    // an unread row's slot is zero-filled
    long long off[ITEMS];
    auto resolve = [&](int t) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = tid + k * NTHREADS, kp = t * BK + i / CPR;
        off[k] = t >= 0 && i < BK * CPR && loaded(kp)
                     ? (long long)(cache.row(b_run, hk, kp) + (i % CPR) * VE) : -1ll;
      }
    };
    auto load_tile = [&](int stage) {
      T* dk = sK + stage * BK * LDK;
      T* dv = sV + stage * BK * LDV;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const int i = tid + k * NTHREADS, r = i / CPR, ch = i % CPR;
        if (i >= BK * CPR) continue;
        const bool ld = off[k] >= 0;
        cp_async16(dk + r * LDK + ch * VE, cache.k + (ld ? off[k] : 0), ld ? 16 : 0);
        cp_async16(dv + r * LDV + ch * VE, cache.v + (ld ? off[k] : 0), ld ? 16 : 0);
      }
    };

    float m[NR], l[NR], acc[A0][A1];
#pragma unroll
    for (int i = 0; i < NR; ++i) { m[i] = NEG_INF; l[i] = 0.f; }
#pragma unroll
    for (int a = 0; a < A0; ++a)
#pragma unroll
      for (int b = 0; b < A1; ++b) acc[a][b] = 0.f;

    int t_ld = next_tile(t_first + rank), t_cp = t_ld;
    int n_ld = 0, n_cp = 0;
    resolve(t_ld);
    auto issue = [&]() {
      if (t_ld >= 0) {
        load_tile(n_ld % NSTAGE);
        ++n_ld;
        t_ld = next_tile(t_ld + p.C);
        resolve(t_ld);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) issue();
    // q of the run's query rows (row qr = token row ra + qr / G, head qr %
    // G), while the first tile is in flight: every load first, then the
    // stores (the loop's first barrier publishes them)
    {
      float qx[QITEMS][VE];
#pragma unroll
      for (int k = 0; k < QITEMS; ++k) {
        const int i = tid + k * NTHREADS, qr = i / CPR;
#pragma unroll
        for (int e = 0; e < VE; ++e) qx[k][e] = 0.f;
        if (i < SM::QROWS * CPR && qr < nq)
          load_vec<T, VE>(static_cast<const T*>(p.q) +
                              ((size_t)(b_run + qr / G) * p.Hq + hk * G + qr % G) * D +
                              (i % CPR) * VE,
                          qx[k]);
      }
#pragma unroll
      for (int k = 0; k < QITEMS; ++k) {
        const int i = tid + k * NTHREADS;
        if (i < SM::QROWS * CPR)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            sQ[(i / CPR) * LDQ + (i % CPR) * VE + e] = from_f<QT>(qx[k][e]);
      }
    }
    while (n_cp < n_ld) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();            // tile n_cp landed; stage (n_cp - 1) % NSTAGE free
      issue();
      if (busy) {
        const int stage = n_cp % NSTAGE, kv0 = t_cp * BK;
        const T* tk = sK + stage * BK * LDK;
        const T* tv = sV + stage * BK * LDV;
        if constexpr (!TILED) {
          // ---- one row: scores of row rg, columns cl + CL*j, f32 FMA ----
          float s[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) s[j] = 0.f;
#pragma unroll 4
          for (int d = 0; d < D; d += VE) {
            float kf[NJ][VE], qv[VE];
#pragma unroll
            for (int j = 0; j < NJ; ++j) load_vec<T, VE>(tk + (cl + CL * j) * LDK + d, kf[j]);
#pragma unroll
            for (int e = 0; e < VE; e += 4) load_vec<float, 4>(sQ + rg * LDQ + d + e, qv + e);
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
              for (int e = 0; e < VE; ++e) s[j] = fmaf(qv[e], kf[j][e], s[j]);
          }
          // ---- online softmax, reduced over the row group's 16 lanes ----
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int kp = kv0 + cl + CL * j;
            s[j] = kp >= lo[0] && kp < hi[0] && cache.owned(b_run, kp) ? s[j] * p.scale
                                                                       : NEG_INF;
            mx = fmaxf(mx, s[j]);
          }
#pragma unroll
          for (int sh = CL / 2; sh > 0; sh >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
          const float m_new = fmaxf(m[0], mx);
          const float alpha = __expf(m[0] - m_new);
          const float m_safe = (m_new == NEG_INF) ? 0.f : m_new;
          m[0] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float pj = __expf(s[j] - m_safe);
            sP[rg * LDP + cl + CL * j] = to_f(from_f<T>(pj));  // P cast to v.dtype
            sum += pj;
          }
#pragma unroll
          for (int sh = CL / 2; sh > 0; sh >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, sh);
          l[0] = fmaf(l[0], alpha, sum);
#pragma unroll
          for (int c = 0; c < VC; ++c) acc[0][c] *= alpha;
          __syncwarp();             // P of each row written by its 16 lanes
          // ---- acc += P V: columns u * CL * VW + cl * VW + e ----
#pragma unroll 4
          for (int j = 0; j < BK; j += 4) {
            float pv[4];
            load_vec<float, 4>(sP + rg * LDP + j, pv);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float vf[VC];
#pragma unroll
              for (int u = 0; u < NU; ++u)
                load_vec<T, VW>(tv + (j + jj) * LDV + u * CL * VW + cl * VW, vf + u * VW);
#pragma unroll
              for (int c = 0; c < VC; ++c) acc[0][c] = fmaf(pv[jj], vf[c], acc[0][c]);
            }
          }
        } else {
          // ---- query tiles: S = q K^T on tensor cores, rows 16 mt + qg (+8),
          // columns BK / 2 nh + 8 j + 2 q4 (+1) ----
          constexpr int HC = BK / 2;              // a half's columns
          float s[NS][4];
          zero(s);
          warp_gemm<T, NS, D, false, false>(s, sQ, LDQ, 16 * mt, tk, LDK, HC * nh, 0, lane);
          bool own[NS][2];          // the thread's columns, shared by its 2 rows
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int kp = kv0 + HC * nh + 8 * j + 2 * q4 + c;
              own[j][c] = kp < hi_max && cache.owned(b_run, kp);
            }
          float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1, kp = kv0 + HC * nh + 8 * j + 2 * q4 + (e & 1);
              s[j][e] = own[j][e & 1] && kp >= lo[i] && kp < hi[i] ? s[j][e] * p.scale
                                                                     : NEG_INF;
              mx[i] = fmaxf(mx[i], s[j][e]);
            }
          // each row's max over its quad, then over the two halves
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            if (q4 == 0) sRed[0][nh][qrow(i)] = mx[i];
          }
          pair_sync(mt);
          float alpha[2], m_safe[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[i], fmaxf(sRed[0][0][qrow(i)], sRed[0][1][qrow(i)]));
            alpha[i] = __expf(m[i] - m_new);
            m_safe[i] = (m_new == NEG_INF) ? 0.f : m_new;
            m[i] = m_new;
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float p0 = __expf(s[j][2 * i] - m_safe[i]);
              const float p1 = __expf(s[j][2 * i + 1] - m_safe[i]);
              store_pair(sP + qrow(i) * LDP + HC * nh + 8 * j + 2 * q4, p0, p1);
              sum[i] += p0 + p1;
            }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
            if (q4 == 0) sRed[1][nh][qrow(i)] = sum[i];
          }
          pair_sync(mt);            // P and the sums of both halves written
#pragma unroll
          for (int i = 0; i < 2; ++i)
            l[i] = fmaf(l[i], alpha[i], sRed[1][0][qrow(i)] + sRed[1][1][qrow(i)]);
          // ---- acc = acc * alpha + P V, D columns nh * D / 2 + ..., NPV
          // n-tiles a pass (pv's registers) ----
#pragma unroll
          for (int a0 = 0; a0 < A0; a0 += NPV) {
            float pv[NPV][4];
            zero(pv);
            warp_gemm<T, NPV, BK, false, true>(pv, sP, LDP, 16 * mt, tv, LDV,
                                               nh * (D / 2) + 8 * a0, 0, lane);
#pragma unroll
            for (int a = 0; a < NPV; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                acc[a0 + a][b] = fmaf(acc[a0 + a][b], alpha[b >> 1], pv[a][b]);
          }
        }
      }
      ++n_cp;
      t_cp = next_tile(t_cp + p.C);
    }
    cp_async_wait<0>();

    // ---- cluster merge: rank 0 folds ranks 1..C-1, in order ----
    if (p.C > 1) {
      __syncthreads();              // the ring is free: it holds the states now
#pragma unroll
      for (int a = 0; a < A0; ++a)
#pragma unroll
        for (int b = 0; b < A1; ++b) sAcc[qrow(slot(a, b)) * D + col(a, b)] = acc[a][b];
#pragma unroll
      for (int i = 0; i < NR; ++i)
        if (row_owner) { sM[qrow(i)] = m[i]; sL[qrow(i)] = l[i]; }
      cluster.sync();
      if (rank == 0) {
        for (int src = 1; src < p.C; ++src) {
          const float* rAcc = cluster.map_shared_rank(sAcc, src);
          const float* rM = cluster.map_shared_rank(sM, src);
          const float* rL = cluster.map_shared_rank(sL, src);
          float a0[NR], a1[NR];
#pragma unroll
          for (int i = 0; i < NR; ++i) {
            const float mr = rM[qrow(i)], lr = rL[qrow(i)];
            const float m_new = fmaxf(m[i], mr);
            const float m_safe = (m_new == NEG_INF) ? 0.f : m_new;
            a0[i] = __expf(m[i] - m_safe);
            a1[i] = __expf(mr - m_safe);
            m[i] = m_new;
            l[i] = fmaf(l[i], a0[i], lr * a1[i]);
          }
#pragma unroll
          for (int a = 0; a < A0; ++a)
#pragma unroll
            for (int b = 0; b < A1; ++b) {
              const int i = slot(a, b);
              acc[a][b] = fmaf(acc[a][b], a0[i], rAcc[qrow(i) * D + col(a, b)] * a1[i]);
            }
        }
      }
      cluster.sync();               // rank 0 has read every state
    }

    if (rank == 0) {
#pragma unroll
      for (int a = 0; a < A0; ++a)
#pragma unroll
        for (int b = 0; b < A1; ++b) {
          const int i = slot(a, b), qr = qrow(i);
          if (qr >= nq) continue;
          const int bq = b_run + qr / G, g = qr % G;
          if (p.o != nullptr) {
            const float l_safe = (l[i] == 0.f) ? 1.f : l[i];
            static_cast<T*>(p.o)[((size_t)bq * p.Hq + hk * G + g) * D + col(a, b)] =
                from_f<T>(acc[a][b] / l_safe);
          } else {
            const size_t row = (((size_t)bq * p.Hkv + hk) * p.ns + split) * G + g;
            p.acc_part[row * D + col(a, b)] = acc[a][b];
          }
        }
      if (p.o == nullptr && row_owner)
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int qr = qrow(i);
          if (qr >= nq) continue;
          const size_t row =
              (((size_t)(b_run + qr / G) * p.Hkv + hk) * p.ns + split) * G + qr % G;
          p.m_part[row] = m[i];
          p.l_part[row] = l[i];
        }
    }
    ra = rb;
    __syncthreads();                // sQ and the ring are free for the next run
  }
}

// The cache's pointers: k/v and, for a paged cache, the block table (null for
// a contiguous one), the ownership gate (null: all owned) and the pool's page
// count, page size and table width.
struct CacheArgs {
  const void* k; const void* v; const int* bt; const int* valid; int P, ps, width;
};

int log2_or_neg(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return (1 << s) == x ? s : -1;
}

// The current device's SM count into n (queried once a device).
cudaError_t sm_count(int& n) {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  n = cached[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev].store(n, std::memory_order_relaxed);
  }
  return cudaSuccess;
}

// The launch's geometry: token rows a block (R), blocks a cluster (C).
// Query tiles only where the caller says that the rows come in groups of
// row_tokens consecutive token rows of one batch row (chunked prefill,
// verify), which mostly read one table: a block then takes R =
// min(row_tokens, 64 / G, 16) of them. A decode launch (row_tokens 1) gives
// every row its own block however many rows it has, since rows of
// different tables would fold one after another in a query-tiled block.
cudaError_t geometry(DecodeParams& p, int row_tokens) {
  const int cap = QMAX / p.G < MAXR ? QMAX / p.G : MAXR;
  p.R = row_tokens <= 1 ? 1 : (row_tokens < cap ? row_tokens : cap);
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return err;
  const int base = (p.B + p.R - 1) / p.R * p.Hkv * p.ns;   // clusters
  int c = 1;
  while (c < MAXC && 2 * c <= p.nj && base * c < sms) c *= 2;
  p.C = c;
  return cudaSuccess;
}

// The shared-memory limit is a property of the function on each device:
// set it once per instantiation and device, not at every launch.
template <typename T, int D, typename Cache, bool TILED>
cudaError_t prepare() {
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(decode_kernel<T, D, Cache, TILED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<T, D, TILED>::BYTES);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

struct LaunchConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  LaunchConfig(const DecodeParams& p, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3((unsigned)((p.B + p.R - 1) / p.R * p.C), p.Hkv, p.ns);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, int D, typename Cache, bool TILED>
int launch_cache(const DecodeParams& p, const Cache& cache, cudaStream_t stream) {
  cudaError_t err = prepare<T, D, Cache, TILED>();
  if (err != cudaSuccess) return (int)err;
  LaunchConfig lc(p, Smem<T, D, TILED>::NT, Smem<T, D, TILED>::BYTES, stream);
  err = cudaLaunchKernelEx(&lc.cfg, decode_kernel<T, D, Cache, TILED>, p, cache);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many of this launch's clusters the card holds at once.
template <typename T, int D, typename Cache, bool TILED>
int max_clusters(const DecodeParams& p, int* out) {
  cudaError_t err = prepare<T, D, Cache, TILED>();
  if (err != cudaSuccess) return (int)err;
  LaunchConfig lc(p, Smem<T, D, TILED>::NT, Smem<T, D, TILED>::BYTES, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, decode_kernel<T, D, Cache, TILED>,
                                             &lc.cfg);
}

template <typename T, int D>
int clusters_rt(const DecodeParams& p, int paged, int* out) {
  if (paged) {
    using Cache = PagedCache<T, D>;
    return p.R == 1 ? max_clusters<T, D, Cache, false>(p, out)
                    : max_clusters<T, D, Cache, true>(p, out);
  }
  using Cache = ContigCache<T, D>;
  return p.R == 1 ? max_clusters<T, D, Cache, false>(p, out)
                  : max_clusters<T, D, Cache, true>(p, out);
}

template <typename T>
int geometry_d(const DecodeParams& p, int d, int paged, int* out) {
  switch (d) {
    case 16: return clusters_rt<T, 16>(p, paged, out);
    case 32: return clusters_rt<T, 32>(p, paged, out);
    case 64: return clusters_rt<T, 64>(p, paged, out);
    case 128: return clusters_rt<T, 128>(p, paged, out);
    case 256: return clusters_rt<T, 256>(p, paged, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D, typename Cache>
int launch_rt(const DecodeParams& p, const Cache& cache, cudaStream_t stream) {
  return p.R == 1 ? launch_cache<T, D, Cache, false>(p, cache, stream)
                  : launch_cache<T, D, Cache, true>(p, cache, stream);
}

template <typename T, int D>
int launch(const DecodeParams& p, const CacheArgs& c, cudaStream_t stream) {
  const T* k = static_cast<const T*>(c.k);
  const T* v = static_cast<const T*>(c.v);
  if (c.bt == nullptr)
    return launch_rt<T, D>(p, ContigCache<T, D>{k, v, p.Hkv, p.S}, stream);
  return launch_rt<T, D>(
      p, PagedCache<T, D>{k, v, c.bt, c.valid, c.P, c.ps, c.width, log2_or_neg(c.ps)},
      stream);
}

template <typename T>
int launch_d(const DecodeParams& p, const CacheArgs& c, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, c, stream);
    case 32: return launch<T, 32>(p, c, stream);
    case 64: return launch<T, 64>(p, c, stream);
    case 128: return launch<T, 128>(p, c, stream);
    case 256: return launch<T, 256>(p, c, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fills p from the launch's sizes; cudaErrorInvalidValue if the kernel does
// not take them.
int params(DecodeParams& p, int B, int Hq, int Hkv, int S, int D, int num_splits,
           int row_tokens) {
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.S = S;
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || num_splits < 1 || S < 1 ||
      row_tokens < 1)
    return (int)cudaErrorInvalidValue;
  p.G = Hq / Hkv;
  if (p.G > max_group(D)) return (int)cudaErrorInvalidValue;
  p.nk = (S + BKV - 1) / BKV;
  p.ns = num_splits;
  p.nj = (p.nk + num_splits - 1) / num_splits;
  return (int)geometry(p, row_tokens);
}

int launch_any(const void* q, const CacheArgs& c, const int* kv_len, void* o,
               float* acc_part, float* m_part, float* l_part, int B, int Hq,
               int Hkv, int S, int D, int dtype, float scale, int window,
               int num_splits, int row_tokens, void* stream) {
  DecodeParams p;
  if (int err = params(p, B, Hq, Hkv, S, D, num_splits, row_tokens)) return err;
  p.q = q; p.kv_len = kv_len; p.o = o;
  p.acc_part = acc_part; p.m_part = m_part; p.l_part = l_part;
  p.scale = scale; p.window = window;
  // o: finalised output, one split only; else the f32 partials
  if (o != nullptr ? num_splits != 1
                   : (acc_part == nullptr || m_part == nullptr || l_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(p, c, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(p, c, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. With num_splits == 1 `o` is written and
// the partial pointers may be null; otherwise `o` is null and the partials
// are written. row_tokens (>= 1): the rows come in groups of that many
// consecutive token rows of one batch row (chunked prefill, verify; see
// geometry); 1 for decode. Returns the cudaError_t of the launch (0 =
// success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* kv_len, void* o, float* acc_part,
                        float* m_part, float* l_part, int B, int Hq, int Hkv,
                        int S, int D, int dtype, float scale, int window,
                        int num_splits, int row_tokens, void* stream) {
  const CacheArgs c{k, v, nullptr, nullptr, 0, 0, 0};
  return launch_any(q, c, kv_len, o, acc_part, m_part, l_part, B, Hq, Hkv, S,
                    D, dtype, scale, window, num_splits, row_tokens, stream);
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
                              int num_splits, int row_tokens, void* stream) {
  if (page_size < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const CacheArgs c{k_pages, v_pages, block_tables, nullptr, P, page_size, T};
  return launch_any(q, c, kv_len, o, acc_part, m_part, l_part, B, Hq, Hkv,
                    T * page_size, D, dtype, scale, window, num_splits, row_tokens,
                    stream);
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
                                       int row_tokens, void* stream) {
  if (page_size < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const CacheArgs c{k_pages, v_pages, block_tables, block_valid, P, page_size, T};
  return launch_any(q, c, kv_len, nullptr, acc_part, m_part, l_part, B, Hq,
                    Hkv, T * page_size, D, dtype, scale, window, num_splits,
                    row_tokens, stream);
}

// The geometry a launch of these sizes takes on the current device: out =
// {token rows a block, blocks a cluster, blocks, clusters of this
// instantiation (dtype, D, paged or contiguous, query tiles or not) the card
// holds at once}. S: cache rows a row (T * page_size when paged). Returns 0
// or the CUDA error.
int flash_decode_geometry(int B, int Hq, int Hkv, int S, int D, int dtype, int paged,
                          int num_splits, int row_tokens, int* out) {
  DecodeParams p;
  if (int err = params(p, B, Hq, Hkv, S, D, num_splits, row_tokens)) return err;
  out[0] = p.R;
  out[1] = p.C;
  out[2] = (p.B + p.R - 1) / p.R * p.C * p.Hkv * p.ns;
  if (dtype == 0) return geometry_d<float>(p, D, paged, out + 3);
  if (dtype == 1) return geometry_d<__nv_bfloat16>(p, D, paged, out + 3);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
