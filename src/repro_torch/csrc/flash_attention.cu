// Flash attention, forward and backward: causal grouped-query attention with
// an online softmax, an optional logit softcap and an optional sliding
// window. The (Sq, Sk) score matrix never reaches device memory.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   forward   flash_attention      (pallas_call at :182, body _kernel :49)
//   dQ        flash_attention_bwd  (pallas_call at :337, body _dq_kernel :245)
//   dK/dV     flash_attention_bwd  (pallas_call at :361, body _dkv_kernel :278)
//
// q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), Hq = rep * Hkv, all f32 or all
// bf16, with D contiguous and any batch, head and sequence strides (so the
// model's (B, S, H, D) projections go in as (B, H, S, D) views, with no
// transpose copy). Key j is visible from query i when j <= i, and, with a
// window w, when i - j < w. Masked scores take the finite value -1e30, as
// in the reference (NEG_INF), so no row ever produces a NaN. Ragged Sq and
// Sk are masked at the load: rows past the end read as 0 and are never
// written, so no caller pads to a tile multiple.
//
//   forward  O = softmax(mask(cap(scale * Q K^T))) V,  lse = rowwise log-sum-exp
//   dQ       dQ = scale * (P o (dO V^T - Delta) o chain) K
//   dK/dV    dK = scale * dS^T Q,  dV = P^T dO, summed over the rep q heads
//            of each kv head
// with P = exp(S - lse) recomputed from the forward's lse, Delta =
// rowsum(dO o O) (computed by the Python wrapper), and chain = 1 - tanh^2 the
// softcap's derivative (1 without a softcap).
//
// What bounds them on the H100, at llama3.2-1b's shape (B=8, Hq=32, Hkv=8,
// S=512, D=64, bf16): the forward and dQ are bound by bytes (42.5 MB and
// 59.8 MB against 8.6e9 and 1.29e10 causal flops: 12.7 and 17.8 us), dK/dV
// by operations (1.72e10 flops, 17.4 us). Everything the kernels move is
// read once per tile pair from L2, and the quadratic score matrix stays in
// registers. No kernel reaches either bound at this shape: a launch is a
// few waves of short blocks (the forward's and dQ's walk 2 to 8 key tiles),
// and in each step a chain of product groups and the element-wise work
// between them, not a pipe's rate, sets the time. Clock counts taken inside
// the forward on the card (chip_smoke.flash_clocks) put ~18% of a block's
// life before its first K/V tile lands, ~17% in waits for copies and ~30%
// in the softmax; a deeper ring, a producer warp, separate K and V
// barriers, a softmax overlapped with the last tile's P V products, a
// persistent grid that prefetches the next q tile and 128-key tiles each
// made the forward slower on the card (PERF.md, PR 16), so it keeps
// 64-key tiles and one barrier per tile.
//
// Design. The grid has no order on the card, so each block owns its output
// tiles and loops over the other sequence axis inside itself; each output
// tile has one writer: no atomics, no second pass, so the gradients are
// bitwise the same on every run.
//
// bf16 forward (fwd_mma): one block of two warpgroups per (q head,
//   example, 128-row q tile), the longest q tiles first (blockIdx.z counts
//   down). Q arrives once, and the 64-key K and V tiles through a ring of
//   three stages in shared memory, each filled by TMA (one thread issues
//   the copy; completion on an mbarrier), so tile j + 1 lands while tile j
//   is computed; one barrier per tile. Both warpgroups read each staged K/V
//   tile. S = Q K^T is wgmma m64n64k16 with Q and K in shared memory; P V
//   is wgmma m64nDk16 with P in registers (the accumulator layout of S is
//   the register-operand layout of P V once packed to bf16, so P never
//   leaves registers) and V read MN-major from shared memory. Tile j's P V
//   products are waited for only with tile j + 1's Q K^T, so they run
//   while the warpgroup waits for tile j + 1 and at the barrier (hence the
//   third stage: the copy into a stage waits for the products two tiles
//   back, not one). The softmax runs in base 2 with ex2.approx; off the
//   edges the raw scores enter the exponent through one fma with
//   scale * log2(e), and lse leaves in natural log. The mask is decided
//   once per warp and tile: a warpgroup skips a tile it cannot see, and only
//   tiles that cross the diagonal, the window's edge or the end of the keys
//   test each element. The softcap is a template parameter, so tanh is
//   compiled in only where one is set. O leaves through shared memory in
//   16-byte rows.
// bf16 dQ (dq_mma): the forward's block and tiles, with dO beside Q: one
//   block of two warpgroups per (q head, example, 128-row q tile), longest
//   first. Q and dO arrive once by TMA on their own barrier, the K and V
//   tiles through a four-stage ring (KvRing) with a barrier each for K and
//   V, so S = Q K^T starts before V lands. No block barrier on this route:
//   each warp releases a stage (an `empty` mbarrier) once its products on
//   it have landed, and thread 0 refills the stage of tile j - 2 at step j.
//   S and dP = dO V^T are wgmma m64n64k16 from shared memory; dS = P o
//   (dP - Delta) o chain, P = exp2(S c2 - lse log2 e), is packed to bf16
//   in registers as the operand of dQ += dS K (wgmma m64nDk16, K read
//   MN-major), which the next step's first group waits for. The masks are
//   decided per tile as in the forward. dQ, scaled, leaves through the
//   warp's rows of Q in 16-byte rows.
// bf16 dK/dV (dkv_mma): one block of two warpgroups per (pair of 64-key
//   tiles, kv head, example). Under the causal mask key tile kt meets
//   n - kt q tiles, so a block takes tile x and then tile n - 1 - x: every
//   block walks n + 1 q tiles per q head (the middle tile alone for odd n),
//   and a launch at S=512 is one wave of equal blocks. Both key tiles' K and
//   V arrive once by TMA; the rep q heads' Q and dO tiles run through a
//   three-stage TMA ring across the whole (key tile, q head, q tile) walk,
//   and the lse and Delta rows beside them by 4-byte cp.async. Each
//   warpgroup takes 32 of a q tile's 64 queries against all 64 keys:
//   S^T = K Q^T and dP^T = V dO^T in one group of wgmma m64n32k16 (operands
//   in shared memory), then dV += P^T dO and dK += dS^T Q in another (P^T
//   and dS^T from registers), which the next step's first group waits for,
//   as in the forward. At the end of each key tile the two warpgroups' dK
//   and dV are summed in a fixed order through the tile's own K and V
//   buffers, which then carry the bf16 rows out.
// Tiles lie in shared memory as TMA writes them and wgmma reads them
//   (Tile<D, ROWS>): 64-column sub-tiles swizzled within 128-byte rows for
//   D >= 64, 8-column chunks unswizzled for D = 32. Rows whose base or
//   strides are not multiples of 16 bytes (no tensor map describes them)
//   are staged by loads and stores into the same tiles instead, with a
//   block barrier per tile. The Python launcher decides the route of every
//   bf16 launch and the dK/dV blocks' key tiles and q-tile ranges, and
//   passes them in; the kernels hold no rule of their own for either.
// f32 runs on the FMA pipes: 4 threads per row, each owning D/4 of the
//   features, with the dot products summed over the 4 by warp shuffles in a
//   fixed order.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;

constexpr float kNegInf = -1.0e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, s;
};

// Everything a launch needs, passed by value (the tensor maps in the
// kernel's parameter space, where TMA reads them).
struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;  // with `tma`: see encode_rows()
  const void* q;
  const void* k;
  const void* v;
  const void* dout;      // dO (backward)
  const float* lse;      // (B, Hq, Sq) contiguous (backward)
  const float* delta;    // (B, Hq, Sq) contiguous (backward)
  void* out0;            // O, dQ or dK
  void* out1;            // dV
  float* lse_out;        // (B, Hq, Sq) contiguous (forward)
  int Hq, Sq, Sk, rep;
  float scale, cap;      // cap 0: no softcap
  int window;            // 0: no window
  Strides q_st, k_st, v_st, do_st, out0_st, out1_st;
  bool vec_out;          // 16-byte stores for every bf16 output row
  bool tma;              // bf16: tiles by TMA (else staged), as the
                         // launcher chose (see dispatch())
  const int* work;       // bf16 dK/dV: 6 ints a block (see dkv_mma)
  int n_work;            // blocks of that table
};

// Whether key j is visible from query i: the reference's mask.
__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return j <= i && i < p.Sq && j < p.Sk && (p.window <= 0 || i - j < p.window);
}

// The reference's score transform and mask (_scores / _bwd_scores): the
// scaled, softcapped score of query i against key j, kNegInf where masked;
// `chain` gets the softcap's derivative.
__device__ __forceinline__ float score(const Params& p, float raw, int i,
                                       int j, bool& valid, float& chain) {
  float x = raw * p.scale;
  chain = 1.f;
  if (p.cap > 0.f) {
    const float t = tanhf(x / p.cap);
    x = p.cap * t;
    chain = 1.f - t * t;
  }
  valid = visible(p, i, j);
  return valid ? x : kNegInf;
}

// score() before the mask, in base 2: log2(e) * cap(scale * raw), with
// scale * log2(e) folded into c2 when there is no softcap.
template <bool kCap>
__device__ __forceinline__ float score2(const Params& p, float raw, float c2,
                                        float& chain) {
  if constexpr (kCap) {
    const float t = tanhf(raw * p.scale / p.cap);
    chain = 1.f - t * t;
    return p.cap * kLog2e * t;
  } else {
    chain = 1.f;
    return raw * c2;
  }
}

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Key tiles [lo, hi) holding a key that some query of [q0, q0 + bq) sees.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bq,
                                          int bk, int& lo, int& hi) {
  const int q_last = min(q0 + bq, p.Sq) - 1;
  const int k_end = min(p.Sk, q_last + 1);
  hi = (k_end + bk - 1) / bk;
  lo = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) lo = (q0 - p.window + 1) / bk;
}

// Query tiles [lo, hi) holding a query that sees some key of [k0, k0 + bk).
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int bk,
                                            int bq, int& lo, int& hi) {
  lo = k0 / bq;
  long long q_end = p.Sq;
  if (p.window > 0) {
    const long long last = static_cast<long long>(min(k0 + bk, p.Sk)) - 1 +
                           p.window;
    if (last < q_end) q_end = last;
  }
  hi = static_cast<int>((q_end + bq - 1) / bq);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, Strides st,
                                            int b, int h, int s) {
  return static_cast<const T*>(base) + b * st.b + h * st.h + s * st.s;
}

constexpr int kTile = 64;  // rows of a key tile; of a dK/dV q tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float c[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// ---------------------------------------------------------------------------
// bf16: two warpgroups on wgmma, tiles brought by TMA
// ---------------------------------------------------------------------------

constexpr int kRows = 128;          // rows of a forward or dQ q tile: 2 x 64
constexpr int kFwdStages = 3;       // the forward's ring of K and V
constexpr int kDqStages = 4;        // dQ's ring of K and V
constexpr int kDkvStages = 3;       // the dK/dV ring of Q, dO, lse, Delta
constexpr int kWideThreads = 256;   // two consumer warpgroups
constexpr int kConsumerWarps = kWideThreads / 32;

// TMA: rows [s0, s0 + ROWS) of head h of example b into a tile at dst
// (rows past the end land as 0), completing on bar: through a 4-d map
// (D, S, H, B) in 64-column boxes for the swizzled layout, a 5-d map
// (8 columns, S, D / 8 chunks, H, B) in one box for the chunk-major one.
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* tm,
                                         uint64_t* bar, int s0, int h,
                                         int b) {
  if constexpr (Tile<D, ROWS>::kSwizzled) {
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
      tma_load_4d(dst + u * ROWS * 64, tm, bar, 64 * u, s0, h, b);
  } else {
    tma_load_5d(dst, tm, bar, 0, s0, 0, h, b);
  }
}

// dQ's ring of K and V: kDqStages stages, each a 64-key K tile and V tile,
// with a `full` barrier for each (TMA completion: the products on K need
// not wait for V) and an `empty` barrier, which each of the kConsumerWarps
// warps arrives at once its products on the stage have landed. Tile j of a
// block's walk lies in stage j % kDqStages.
template <int D>
struct KvRing {
  static constexpr int S = kDqStages;
  static constexpr int kElems = kTile * D;  // of one K or V tile
  bf16* tiles;  // S x {K, V}
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty;

  // the ring from `base`, its barriers after the tiles; end() follows them
  __device__ explicit KvRing(bf16* base)
      : tiles(base),
        full_k(reinterpret_cast<uint64_t*>(base + 2 * S * kElems)),
        full_v(full_k + S),
        empty(full_v + S) {}
  __device__ uint64_t* end() const { return empty + S; }
  static constexpr size_t bytes() {
    return 2 * S * kElems * sizeof(bf16) + 3 * S * sizeof(uint64_t);
  }
  __device__ bf16* k(int j) const { return tiles + (j % S) * 2 * kElems; }
  __device__ bf16* v(int j) const { return k(j) + kElems; }
  // the parity of tile j's phase on its stage's barriers
  __device__ static uint32_t parity(int j) { return (j / S) & 1; }
  __device__ void init() const {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full_k[i]);
      mbar_init(&full_v[i]);
      mbar_init(&empty[i], kConsumerWarps);
    }
  }
  // one thread: start bringing key tile kt of kv head hk, example b, as
  // tile j of the walk
  __device__ void load(const Params& p, int j, int kt, int hk, int b) const {
    const int st = j % S;
    mbar_expect(&full_k[st], kElems * sizeof(bf16));
    tma_rows<D, kTile>(k(j), &p.tm_k, &full_k[st], kt * kTile, hk, b);
    mbar_expect(&full_v[st], kElems * sizeof(bf16));
    tma_rows<D, kTile>(v(j), &p.tm_v, &full_v[st], kt * kTile, hk, b);
  }
  __device__ void wait_k(int j) const { mbar_wait(&full_k[j % S], parity(j)); }
  __device__ void wait_v(int j) const { mbar_wait(&full_v[j % S], parity(j)); }
  // one lane of each warp, once its products on tile j have landed: the
  // stage may take another tile
  __device__ void release(const Params& p, int j, int lane) const {
    if (p.tma && j >= 0 && lane == 0) mbar_arrive(&empty[j % S]);
  }
};

// The route for rows that TMA cannot take (a base or stride that is no
// multiple of 16 bytes): rows [s0, s0 + ROWS) of one (b, h) slice into a
// tile by loads and stores, rows at or past S as 0, spread over all
// kWideThreads threads; fence_async_smem() and a barrier follow.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const void* base,
                                           Strides st, int b, int h, int s0,
                                           int S) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kWideThreads) {
    const int r = c / kChunks, j = c % kChunks;
    bf16* d = dst + Tile<D, ROWS>::byte(r, j * 8) / 2;
    if (s0 + r < S)
      repro::stage8_bf16(row_ptr<bf16>(base, st, b, h, s0 + r), j * 8, D,
                         false, d);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The warp's 16 x D accumulator fragments times mul[half] (rows 0-7, 8-15),
// rounded to bf16, into rows row0 .. row0 + 15 of a tile.
template <int D, int ROWS>
__device__ __forceinline__ void frags_to_tile(bf16* tile,
                                              const float c[D / 8][4],
                                              const float mul[2], int row0,
                                              int lane) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
  const int t = lane & 3, r = row0 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<uint32_t*>(
          base + Tile<D, ROWS>::byte(r + 8 * half, nd * 8 + 2 * t)) =
          pack_bf16(c[nd][2 * half] * mul[half],
                    c[nd][2 * half + 1] * mul[half]);
}

// One warp writes rows row0 .. row0 + 15 of a tile to rows
// [r0, r0 + 16) of one (b, h) slice, 16 bytes a lane where the rows are
// 16-byte aligned (`vec`); rows at or past S are skipped.
template <int D, int ROWS>
__device__ __forceinline__ void store_tile16(const bf16* tile, int row0,
                                             void* base, Strides st, int b,
                                             int h, int r0, int S, bool vec,
                                             int lane) {
  constexpr int kChunks = D / 8;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(tile);
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + 32 * i;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    if (r0 + r >= S) continue;
    bf16* dst = static_cast<bf16*>(base) + b * st.b + h * st.h +
                (r0 + r) * st.s + col;
    const uint4 v =
        *reinterpret_cast<const uint4*>(src + Tile<D, ROWS>::byte(row0 + r, col));
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = e[j];
    }
  }
}

// The register operand of issue_xb: X (the warp's 16 x 16 KC) in bf16.
template <int KC>
__device__ __forceinline__ void pack_rows(uint32_t a[KC][4],
                                          const float (*x)[4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[kc][1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[kc][2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[kc][3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
  }
}

// Issue c (the warpgroup's 64 x N) = A B^T over depth D: A 64 rows from a,
// B N rows from b, each a row of a tile of RA (RB) rows read K-major.
template <int D, int N, int RA, int RB>
__device__ __forceinline__ void issue_abt(float* c, const bf16* a,
                                          const bf16* b) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss<N>(c, Tile<D, RA>::desc_k(a, kc), Tile<D, RB>::desc_k(b, kc),
                kc > 0);
}

// Issue c (the warpgroup's 64 x D) += X B: X (64 x 16 KC; the warp's rows
// packed by pack_rows) and B 16 KC rows (the depth) from b, a row of a
// tile of RB rows read MN-major.
template <int D, int KC, int RB>
__device__ __forceinline__ void issue_xb(float* c, const uint32_t a[KC][4],
                                         const bf16* b) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    wgmma_rs_t<D>(c, a[kc], Tile<D, RB>::desc_mn(b, kc));
}

// Clock counts inside the bf16 forward, compiled in only with
// -DREPRO_FLASH_CLOCKS (chip_smoke.flash_clocks builds such a copy apart
// from the package's library). Thread 0 of each consumer warpgroup records
// five counts of clock64() cycles: from its start to the end of its tiles,
// to its first tile's arrival, in waits for copies (and block barriers), in
// waits for products, and in the softmax.
#ifdef REPRO_FLASH_CLOCKS
constexpr int kClockSlots = 5;
constexpr int kClockRecords = 8192;  // (block, warpgroup) records
__device__ long long g_flash_clocks[kClockRecords * kClockSlots];
#define CLOCKS_BEGIN()                                  \
  long long clk_[kClockSlots] = {0, 0, 0, 0, 0};        \
  const long long clk_t0 = clock64();                   \
  long long clk_mark = clk_t0
#define CLOCK_MARK() (clk_mark = clock64())
#define CLOCK_ADD(slot) (clk_[slot] += clock64() - clk_mark)
#define CLOCK_FIRST() \
  if (clk_[1] == 0) clk_[1] = clock64() - clk_t0
#define CLOCKS_END()                                                      \
  do {                                                                    \
    clk_[0] = clock64() - clk_t0;                                         \
    const int rec = ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +  \
                     blockIdx.x) * 2 + (threadIdx.x >> 7);                \
    if ((threadIdx.x & 127) == 0 && rec < kClockRecords)                  \
      for (int i = 0; i < kClockSlots; ++i)                               \
        g_flash_clocks[rec * kClockSlots + i] = clk_[i];                  \
  } while (0)
#else
#define CLOCKS_BEGIN()
#define CLOCK_MARK()
#define CLOCK_ADD(slot)
#define CLOCK_FIRST()
#define CLOCKS_END()
#endif

template <int D, bool kCap>
__global__ void __launch_bounds__(kWideThreads, D <= 64 ? 2 : 1)
    fwd_mma(const __grid_constant__ Params p) {
  constexpr int kTileElems = kTile * D;
  bf16* qs = reinterpret_cast<bf16*>(smem_base());  // [kRows][D]: Q, then O
  bf16* ring = qs + kRows * D;  // kFwdStages stages x {K, V} [kTile][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + 2 * kFwdStages * kTileElems);

  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.rep;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // longest rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int w0 = q0 + (warp >> 2) * 64;  // the warpgroup's rows: w0 .. + 63
  const int r0 = q0 + warp * 16;         // the warp's: r0 .. r0 + 15
  const int row = r0 + (lane >> 2);      // this thread's: row and row + 8

  CLOCKS_BEGIN();
  int lo, hi;
  key_tiles(p, q0, kRows, kTile, lo, hi);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kFwdStages; ++i) mbar_init(&full[i]);
    mbar_init_fence();
  }
  __syncthreads();
  // Q and the first K/V tile; then tile kt + 1 while tile kt is computed
  if (!p.tma) {
    stage_rows<D, kRows>(qs, p.q, p.q_st, b, h, q0, p.Sq);
    stage_rows<D, kTile>(ring, p.k, p.k_st, b, hk, lo * kTile, p.Sk);
    stage_rows<D, kTile>(ring + kTileElems, p.v, p.v_st, b, hk, lo * kTile,
                         p.Sk);
  } else if (threadIdx.x == 0) {
    mbar_expect(&full[0], (kRows + 2 * kTile) * D * 2);
    tma_rows<D, kRows>(qs, &p.tm_q, &full[0], q0, h, b);
    tma_rows<D, kTile>(ring, &p.tm_k, &full[0], lo * kTile, hk, b);
    tma_rows<D, kTile>(ring + kTileElems, &p.tm_v, &full[0], lo * kTile, hk,
                       b);
  }

  // Without a softcap, the scores of a tile off every edge stay raw until
  // the exponent, where fma(s, c2, -m) applies scale * log2(e); on an edge,
  // and with a softcap (score2), they are scaled first.
  const float c2 = p.scale * kLog2e;
  const float k2 = kCap ? 1.f : c2;  // what makes a raw score a base-2 one
  float o[D / 8][4];
  zero<D / 8>(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // The P V products of tile kt are left to land while tile kt + 1 is
  // waited for; its Q K^T products wait for them too. With three stages the
  // copies for tile kt + 1 go to the stage of tile kt - 2.
  uint32_t pa[4][4];  // P in bf16, read by those products
  for (int kt = lo; kt < hi; ++kt) {
    const int j = kt - lo, stage = j % kFwdStages;
    const int next_stage = (j + 1) % kFwdStages;
    const bf16* ks = ring + stage * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
    CLOCK_MARK();
    if (p.tma)
      mbar_wait(&full[stage], (j / kFwdStages) & 1);
    else
      fence_async_smem();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 2
    CLOCK_ADD(2);
    CLOCK_FIRST();
    if (kt + 1 < hi) {
      bf16* next = ring + next_stage * 2 * kTileElems;
      const int k1 = (kt + 1) * kTile;
      if (!p.tma) {
        stage_rows<D, kTile>(next, p.k, p.k_st, b, hk, k1, p.Sk);
        stage_rows<D, kTile>(next + kTileElems, p.v, p.v_st, b, hk, k1, p.Sk);
      } else if (threadIdx.x == 0) {
        mbar_expect(&full[next_stage], 2 * kTileElems * 2);
        tma_rows<D, kTile>(next, &p.tm_k, &full[next_stage], k1, hk, b);
        tma_rows<D, kTile>(next + kTileElems, &p.tm_v, &full[next_stage], k1,
                           hk, b);
      }
    }
    // Keys k0 .. k0 + 63: a warpgroup that sees none of them skips the
    // tile; a warp tests each element only on an edge (the diagonal, the
    // window's first key, the end of the keys).
    const int k0 = kt * kTile;
    if (w0 >= p.Sq || k0 > w0 + 63 ||
        (p.window > 0 && w0 - (k0 + kTile - 1) >= p.window)) {
      CLOCK_MARK();
      wgmma_wait();  // tile kt - 1's products read the stage kt + 2 fills
      pin<D / 2>(&o[0][0]);
      CLOCK_ADD(3);
      continue;
    }
    const bool edge = k0 + kTile - 1 > r0 || k0 + kTile > p.Sk ||
                      (p.window > 0 && r0 + 15 - k0 >= p.window);

    float s[8][4];
    zero<8>(s);
    pin<32>(&s[0][0]);
    wgmma_fence();
    issue_abt<D, 64, kRows, kTile>(&s[0][0],
                                   qs + Tile<D, kRows>::row(w0 - q0), ks);
    wgmma_commit();
    CLOCK_MARK();
    wgmma_wait();  // and tile kt - 1's P V products
    pin<32>(&s[0][0]);
    pin<D / 2>(&o[0][0]);
    pin_u<16>(&pa[0][0]);
    CLOCK_ADD(3);
    CLOCK_MARK();
    if constexpr (kCap) {
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float chain;
          s[nj][e] = score2<kCap>(p, s[nj][e], c2, chain);
        }
    }
    float kk = k2;
    if (edge) {
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nj][e] = visible(p, row + (e >> 1) * 8,
                             k0 + nj * 8 + 2 * t + (e & 1))
                         ? s[nj][e] * k2
                         : kNegInf;
      kk = 1.f;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nj][e]);
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i] * kk);
      corr[i] = exp2_fast(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nj][e] = exp2_fast(fmaf(s[nj][e], kk, -m[e >> 1]));
        sum[e >> 1] += s[nj][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e >> 1];
    pack_rows<4>(pa, s);
    pin_u<16>(&pa[0][0]);
    pin<D / 2>(&o[0][0]);
    CLOCK_ADD(4);
    wgmma_fence();
    issue_xb<D, 4, kTile>(&o[0][0], pa, vs);
    wgmma_commit();
  }
  CLOCK_MARK();
  wgmma_wait();
  pin<D / 2>(&o[0][0]);
  CLOCK_ADD(3);
  CLOCKS_END();
  if (hi <= lo) {  // no key tile: let Q land before O overwrites it
    if (p.tma) mbar_wait(&full[0], 0);
    __syncthreads();
  }

  // l so far is this thread's share of its rows; the quad holds the rest
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
  // O leaves through the warp's own 16 rows of Q, which only its own
  // warpgroup's finished products have read
  frags_to_tile<D, kRows>(qs, o, inv, warp * 16, lane);
  __syncwarp();
  store_tile16<D, kRows>(qs, warp * 16, p.out0, p.out0_st, b, h, r0, p.Sq,
                         p.vec_out, lane);
  if (t == 0) {
    float* lse = p.lse_out + (static_cast<long long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + i * 8 < p.Sq) lse[row + i * 8] = m[i] * kLn2 + logf(l[i]);
  }
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kWideThreads, D <= 64 ? 2 : 1)
    dq_mma(const __grid_constant__ Params p) {
  bf16* qs = reinterpret_cast<bf16*>(smem_base());  // [kRows][D]: Q, then dQ
  bf16* dos = qs + kRows * D;                        // [kRows][D]: dO
  using Ring = KvRing<D>;
  const Ring ring(dos + kRows * D);
  uint64_t* bar_q = ring.end();  // Q and dO

  const int h = blockIdx.x, b = blockIdx.y, hk = h / p.rep;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // longest rows first
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int w0 = q0 + (warp >> 2) * 64;  // the warpgroup's rows: w0 .. + 63
  const int r0 = q0 + warp * 16;         // the warp's: r0 .. r0 + 15
  const int row = r0 + (lane >> 2);      // this thread's: row and row + 8

  int lo, hi;
  key_tiles(p, q0, kRows, kTile, lo, hi);
  const int n = hi - lo;  // key tiles of the walk, at least 1
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(bar_q);
    mbar_init_fence();
  }
  __syncthreads();
  if (!p.tma) {
    stage_rows<D, kRows>(qs, p.q, p.q_st, b, h, q0, p.Sq);
    stage_rows<D, kRows>(dos, p.dout, p.do_st, b, h, q0, p.Sq);
  } else if (threadIdx.x == 0) {  // Q and dO; K/V tiles to fill the ring
    mbar_expect(bar_q, 2 * kRows * D * sizeof(bf16));
    tma_rows<D, kRows>(qs, &p.tm_q, bar_q, q0, h, b);
    tma_rows<D, kRows>(dos, &p.tm_do, bar_q, q0, h, b);
    for (int j = 0; j < n && j < kDqStages; ++j) ring.load(p, j, lo + j, hk, b);
  }
  __syncwarp();
  // lse in base 2 and Delta of this thread's two rows
  const long long bh = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    lse2[i] = r < p.Sq ? __ldg(p.lse + bh + r) * kLog2e : 0.f;
    dl[i] = r < p.Sq ? __ldg(p.delta + bh + r) : 0.f;
  }
  if (p.tma) mbar_wait(bar_q, 0);

  const float c2 = p.scale * kLog2e;
  float acc[D / 8][4];
  zero<D / 8>(acc);
  // Tile j's dS K products are left to land while tile j + 1's S and dP
  // run; the wait for those releases tile j's stage. Thread 0 refills the
  // stage of tile j - 2, which every warp released in step j - 1, at step
  // j: no block barrier on the TMA route, and a lookahead of kDqStages - 2
  // tiles after the first kDqStages.
  uint32_t pa[4][4];  // dS in bf16, read by those products
  for (int j = 0; j < n; ++j) {
    const int jn = j + kDqStages - 2;
    const int k0 = (lo + j) * kTile;
    const bf16* ks = ring.k(j);
    const bf16* vs = ring.v(j);
    if (!p.tma) {  // every warp is past tile j - 2 (step j - 1)
      stage_rows<D, kTile>(ring.k(j), p.k, p.k_st, b, hk, k0, p.Sk);
      stage_rows<D, kTile>(ring.v(j), p.v, p.v_st, b, hk, k0, p.Sk);
      fence_async_smem();
      __syncthreads();
    } else if (threadIdx.x == 0 && jn >= kDqStages && jn < n) {
      mbar_wait(&ring.empty[jn % kDqStages], Ring::parity(jn - kDqStages));
      ring.load(p, jn, lo + jn, hk, b);
    }
    __syncwarp();
    if (w0 >= p.Sq || k0 > w0 + 63 ||
        (p.window > 0 && w0 - (k0 + kTile - 1) >= p.window)) {
      wgmma_wait();  // tile j - 1's dS K products
      pin<D / 2>(&acc[0][0]);
      ring.release(p, j - 1, lane);
      continue;
    }
    const bool edge = k0 + kTile - 1 > r0 || k0 + kTile > p.Sk ||
                      (p.window > 0 && r0 + 15 - k0 >= p.window);

    // S = Q K^T as soon as K is in, dP = dO V^T once V is
    float s[8][4], dp[8][4];
    zero<8>(s);
    zero<8>(dp);
    pin<32>(&s[0][0]);
    pin<32>(&dp[0][0]);
    const int qrow = Tile<D, kRows>::row(w0 - q0);
    if (p.tma) ring.wait_k(j);
    wgmma_fence();
    issue_abt<D, 64, kRows, kTile>(&s[0][0], qs + qrow, ks);
    if (p.tma) ring.wait_v(j);
    issue_abt<D, 64, kRows, kTile>(&dp[0][0], dos + qrow, vs);
    wgmma_commit();
    wgmma_wait();  // and tile j - 1's dS K products
    pin<32>(&s[0][0]);
    pin<32>(&dp[0][0]);
    pin<D / 2>(&acc[0][0]);
    pin_u<16>(&pa[0][0]);
    ring.release(p, j - 1, lane);
    // dS = P o (dP - Delta) o chain, P = exp2(S c2 - lse log2 e)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float chain;
        const float x = score2<kCap>(p, s[nj][e], c2, chain);
        const float pr = exp2_fast(x - lse2[e >> 1]);
        s[nj][e] = pr * (dp[nj][e] - dl[e >> 1]) * chain;
      }
    if (edge) {
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, row + (e >> 1) * 8, k0 + nj * 8 + 2 * t + (e & 1)))
            s[nj][e] = 0.f;
    }
    pack_rows<4>(pa, s);
    pin_u<16>(&pa[0][0]);
    pin<D / 2>(&acc[0][0]);
    wgmma_fence();
    issue_xb<D, 4, kTile>(&acc[0][0], pa, ks);  // dQ += dS K
    wgmma_commit();
  }
  wgmma_wait();
  pin<D / 2>(&acc[0][0]);

  // dQ, scaled, leaves through the warp's own 16 rows of Q, which only its
  // own warpgroup's finished products have read
  const float mul[2] = {p.scale, p.scale};
  frags_to_tile<D, kRows>(qs, acc, mul, warp * 16, lane);
  __syncwarp();
  store_tile16<D, kRows>(qs, warp * 16, p.out0, p.out0_st, b, h, r0, p.Sq,
                         p.vec_out, lane);
}

// Write one finished key tile of dkv_mma, once this warpgroup's products
// have landed: the two query halves' dK and dV summed in a fixed order
// (warp g + 4 into warp g's registers) through the tile's own K and V
// buffers (kv_s: K then V, 64 x D f32 together, which no product reads any
// more), dK scaled, both rounded to bf16 and written as 16-byte rows
// through those buffers; then the accumulators start again from 0.
template <int D>
__device__ __forceinline__ void dkv_finish(const Params& p, float dk[D / 8][4],
                                           float dv[D / 8][4], bf16* kv_s,
                                           int b, int hk, int key0, int g,
                                           int half, int lane) {
  constexpr int kSlot = 4 * 32;  // float4s per index
  float4* part = reinterpret_cast<float4*>(kv_s);
  const int me = g * 32 + lane;
  wgmma_wait();
  pin<D / 2>(&dk[0][0]);
  pin<D / 2>(&dv[0][0]);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float(*x)[4] = pass ? dv : dk;
    __syncthreads();  // every product that read the tile is done
    if (half == 1) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        part[nd * kSlot + me] = make_float4(x[nd][0], x[nd][1], x[nd][2],
                                            x[nd][3]);
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const float4 y = part[nd * kSlot + me];
        x[nd][0] += y.x; x[nd][1] += y.y; x[nd][2] += y.z; x[nd][3] += y.w;
      }
    }
  }
  __syncthreads();  // the sums are read; the buffers take the bf16 rows
  if (half == 0) {
    bf16* stage_k = kv_s;
    bf16* stage_v = kv_s + kTile * D;
    const float mul_k[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
    frags_to_tile<D, kTile>(stage_k, dk, mul_k, g * 16, lane);
    frags_to_tile<D, kTile>(stage_v, dv, one, g * 16, lane);
    __syncwarp();
    store_tile16<D, kTile>(stage_k, g * 16, p.out0, p.out0_st, b, hk,
                           key0 + g * 16, p.Sk, p.vec_out, lane);
    store_tile16<D, kTile>(stage_v, g * 16, p.out1, p.out1_st, b, hk,
                           key0 + g * 16, p.Sk, p.vec_out, lane);
  }
  zero<D / 8>(dk);
  zero<D / 8>(dv);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kWideThreads, D <= 64 ? 2 : 1)
    dkv_mma(const __grid_constant__ Params p) {
  constexpr int kTileElems = kTile * D, kStages = kDkvStages;
  bf16* kv = reinterpret_cast<bf16*>(smem_base());  // per key tile: K, V
  bf16* ring = kv + 4 * kTileElems;  // kStages x {Q, dO} [kTile][D]
  float* rows = reinterpret_cast<float*>(ring + 2 * kStages * kTileElems);
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + 2 * kStages * kTile);

  const int hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  // warpgroup `half` takes queries 32 half .. + 31 of each q tile against
  // all 64 keys, its warp g keys 16 g .. + 15
  const int g = warp & 3, half = warp >> 2;

  // The block's key tiles and, for each, the q tiles [lo, hi) it walks,
  // from the launcher's table (dkv_work in kernels/flash_attention.py):
  // tile x, then n - 1 - x, so that under the causal mask each block meets
  // n + 1 q tiles per q head; the middle tile of an odd n alone (both
  // entries the same).
  const int* w = p.work + 6 * blockIdx.x;
  const int tile0 = __ldg(w), lo0 = __ldg(w + 1), hi0 = __ldg(w + 2);
  const int tile1 = __ldg(w + 3), lo1 = __ldg(w + 4), hi1 = __ldg(w + 5);
  const int n_tiles = tile1 != tile0 ? 2 : 1;
  const int nq0 = max(hi0 - lo0, 0), nq1 = max(hi1 - lo1, 0);
  const int steps0 = p.rep * nq0;
  const int total = steps0 + (n_tiles == 2 ? p.rep * nq1 : 0);

  // step s of the walk: its key tile (slot 0 or 1), q head and first query
  auto step = [&](int s, int& slot, int& h, int& q0) {
    slot = s < steps0 ? 0 : 1;
    const int i = slot ? s - steps0 : s, nq = slot ? nq1 : nq0;
    h = hk * p.rep + i / nq;
    q0 = ((slot ? lo1 : lo0) + i % nq) * kTile;
  };
  // start bringing step s's Q, dO, lse and Delta into stage s % kStages
  auto stage_step = [&](int s) {
    int slot, h, q0;
    step(s, slot, h, q0);
    const int stg = s % kStages;
    bf16* dst = ring + stg * 2 * kTileElems;
    if (!p.tma) {
      stage_rows<D, kTile>(dst, p.q, p.q_st, b, h, q0, p.Sq);
      stage_rows<D, kTile>(dst + kTileElems, p.dout, p.do_st, b, h, q0, p.Sq);
    } else if (threadIdx.x == 0) {
      mbar_expect(&full[stg], 2 * kTileElems * 2);
      tma_rows<D, kTile>(dst, &p.tm_q, &full[stg], q0, h, b);
      tma_rows<D, kTile>(dst + kTileElems, &p.tm_do, &full[stg], q0, h, b);
    }
    if (threadIdx.x < 2 * kTile) {  // lse to rows[0, 64), Delta to [64, 128)
      const int i = threadIdx.x % kTile;
      const float* src = (threadIdx.x < kTile ? p.lse : p.delta) +
                         (static_cast<long long>(b) * p.Hq + h) * p.Sq;
      const bool in = q0 + i < p.Sq;
      cp_async4(rows + stg * 2 * kTile + threadIdx.x,
                src + (in ? q0 + i : 0), in);
    }
    cp_async_commit();
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (!p.tma) {
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = (i ? tile1 : tile0) * kTile;
      stage_rows<D, kTile>(kv + 2 * i * kTileElems, p.k, p.k_st, b, hk, k0,
                           p.Sk);
      stage_rows<D, kTile>(kv + (2 * i + 1) * kTileElems, p.v, p.v_st, b, hk,
                           k0, p.Sk);
    }
  } else if (threadIdx.x == 0) {
    mbar_expect(&full[kStages], n_tiles * 2 * kTileElems * 2);
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = (i ? tile1 : tile0) * kTile;
      tma_rows<D, kTile>(kv + 2 * i * kTileElems, &p.tm_k, &full[kStages], k0,
                         hk, b);
      tma_rows<D, kTile>(kv + (2 * i + 1) * kTileElems, &p.tm_v,
                         &full[kStages], k0, hk, b);
    }
  }
  if (total > 0) stage_step(0);
  if (p.tma) mbar_wait(&full[kStages], 0);

  const float c2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);
  // The dV and dK products of step s are left to land while step s + 1
  // waits for its tiles; its S^T and dP^T products wait for them too. With
  // three stages the copies for step s + 2 go to the stage step s - 1 used.
  uint32_t pa[2][4], sa[2][4];  // P^T and dS^T in bf16, read by those products
  int done = 0;  // key tiles written
  for (int s = 0; s < total; ++s) {
    const int stg = s % kStages;
    cp_async_wait_all();
    if (p.tma)
      mbar_wait(&full[stg], (s / kStages) & 1);
    else
      fence_async_smem();
    __syncthreads();  // step s is in; every warp is done with step s - 1
    if (s + 1 < total) stage_step(s + 1);
    int slot, h, q0;
    step(s, slot, h, q0);
    if (slot > done) {  // the first step of the second key tile
      dkv_finish<D>(p, dk, dv, kv, b, hk, tile0 * kTile, g, half, lane);
      done = 1;
    }
    const bf16* ks = kv + 2 * slot * kTileElems;
    const bf16* vs = ks + kTileElems;
    const bf16* qs = ring + stg * 2 * kTileElems;
    const bf16* dos = qs + kTileElems;
    const float* lse_s = rows + stg * 2 * kTile;
    const float* dl_s = lse_s + kTile;

    // Queries qb .. qb + 31 against keys key0 .. key0 + 63: a warpgroup
    // that sees none skips the step; a warp (keys kb .. kb + 15) tests each
    // element only on an edge.
    const int key0 = (slot ? tile1 : tile0) * kTile, kb = key0 + 16 * g;
    const int qb = q0 + 32 * half;
    if (qb >= p.Sq || qb + 31 < key0 ||
        (p.window > 0 && qb - (key0 + kTile - 1) >= p.window)) {
      wgmma_wait();  // step s - 1's products read the stage s + 1 fills
      pin<D / 2>(&dv[0][0]);
      pin<D / 2>(&dk[0][0]);
      continue;
    }
    const bool edge = qb < kb + 15 || qb + 31 >= p.Sq ||
                      (p.window > 0 && qb + 31 - kb >= p.window);

    // rows are the warpgroup's 64 keys, columns its 32 queries: S^T and
    // dP^T in one group of products, then P^T dO and dS^T Q in another
    float st[4][4], dpt[4][4];
    zero<4>(st);
    zero<4>(dpt);
    pin<16>(&st[0][0]);
    pin<16>(&dpt[0][0]);
    wgmma_fence();
    const int qrow = Tile<D, kTile>::row(32 * half);  // the warpgroup's queries
    issue_abt<D, 32, kTile, kTile>(&st[0][0], ks, qs + qrow);
    issue_abt<D, 32, kTile, kTile>(&dpt[0][0], vs, dos + qrow);
    wgmma_commit();
    wgmma_wait();  // and step s - 1's dV and dK products
    pin<16>(&st[0][0]);
    pin<16>(&dpt[0][0]);
    pin<D / 2>(&dv[0][0]);
    pin<D / 2>(&dk[0][0]);
    pin_u<8>(&pa[0][0]);
    pin_u<8>(&sa[0][0]);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 32 * half + nj * 8 + 2 * t + (e & 1);
        float chain;
        const float x = score2<kCap>(p, st[nj][e], c2, chain);
        const float pr = exp2_fast(x - lse_s[c] * kLog2e);
        st[nj][e] = pr;                                          // P^T
        dpt[nj][e] = pr * (dpt[nj][e] - dl_s[c]) * chain;        // dS^T
      }
    if (edge) {
      const int key = kb + (lane >> 2);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, q0 + 32 * half + nj * 8 + 2 * t + (e & 1),
                       key + (e >> 1) * 8))
            st[nj][e] = dpt[nj][e] = 0.f;
    }
    pack_rows<2>(pa, st);
    pack_rows<2>(sa, dpt);
    pin_u<8>(&pa[0][0]);
    pin_u<8>(&sa[0][0]);
    pin<D / 2>(&dv[0][0]);
    pin<D / 2>(&dk[0][0]);
    wgmma_fence();
    issue_xb<D, 2, kTile>(&dv[0][0], pa, dos + qrow);
    issue_xb<D, 2, kTile>(&dk[0][0], sa, qs + qrow);
    wgmma_commit();
  }
  for (; done < n_tiles; ++done)
    dkv_finish<D>(p, dk, dv, kv + 2 * done * kTileElems, b, hk,
                  (done ? tile1 : tile0) * kTile, g, half, lane);
}

// ---------------------------------------------------------------------------
// f32: FMA pipes, 4 threads per row, 64 rows per block
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;           // threads per row
constexpr int kF32Threads = 256;    // 64 rows
constexpr int kF32Tile = 32;        // rows of the staged (other-axis) tile

// Sum of x over the 4 threads of a row group; the same value in all four.
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Load this thread's D/4 features (gi, gi + 4, ...) of one row; 0 past S.
template <int D>
__device__ __forceinline__ void load_row(float x[D / kGroup], const void* base,
                                         Strides st, int b, int h, int s,
                                         int S, int gi) {
#pragma unroll
  for (int i = 0; i < D / kGroup; ++i) x[i] = 0.f;
  if (s >= S) return;
  const float* src = row_ptr<float>(base, st, b, h, s);
#pragma unroll
  for (int i = 0; i < D / kGroup; ++i) x[i] = src[gi + kGroup * i];
}

template <int D>
__device__ __forceinline__ void store_row(void* base, Strides st, int b, int h,
                                          int s, int S, int gi,
                                          const float x[D / kGroup],
                                          float mul) {
  if (s >= S) return;
  float* dst = static_cast<float*>(base) + b * st.b + h * st.h + s * st.s;
#pragma unroll
  for (int i = 0; i < D / kGroup; ++i) dst[gi + kGroup * i] = x[i] * mul;
}

// Stage rows [s0, s0 + 32) of one (b, h) slice as [32][D] f32; 0 past S.
template <int D>
__device__ __forceinline__ void stage_rows_f32(float* dst, const void* base,
                                               Strides st, int b, int h,
                                               int s0, int S) {
  for (int e = threadIdx.x; e < kF32Tile * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    dst[e] = s0 + r < S ? row_ptr<float>(base, st, b, h, s0 + r)[c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float x[D / kGroup],
                                     const float* row, int gi) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < D / kGroup; ++i) acc = fmaf(x[i], row[gi + kGroup * i], acc);
  return group_sum(acc);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) fwd_f32(Params p) {
  constexpr int kPer = D / kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kF32Tile * D;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.rep;
  const int gi = threadIdx.x % kGroup;
  const int row = q0 + threadIdx.x / kGroup;

  float q[kPer], o[kPer];
  load_row<D>(q, p.q, p.q_st, b, h, row, p.Sq, gi);
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = 0.f;
  float m = kNegInf, l = 0.f;
  int lo, hi;
  key_tiles(p, q0, kTile, kF32Tile, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    stage_rows_f32<D>(ks, p.k, p.k_st, b, hk, k0, p.Sk);
    stage_rows_f32<D>(vs, p.v, p.v_st, b, hk, k0, p.Sk);
    __syncthreads();
    float s[kF32Tile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      bool valid;
      float chain;
      s[j] = score(p, dot<D>(q, ks + j * D, gi), row, k0 + j, valid, chain);
      mx = fmaxf(mx, s[j]);
    }
    const float corr = expf(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int i = 0; i < kPer; ++i) o[i] *= corr;
#pragma unroll
    for (int j = 0; j < kF32Tile; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[i] = fmaf(pj, vs[j * D + gi + kGroup * i], o[i]);
    }
  }
  l = fmaxf(l, 1e-30f);
  store_row<D>(p.out0, p.out0_st, b, h, row, p.Sq, gi, o, 1.f / l);
  if (gi == 0 && row < p.Sq)
    p.lse_out[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) dq_f32(Params p) {
  constexpr int kPer = D / kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kF32Tile * D;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.rep;
  const int gi = threadIdx.x % kGroup;
  const int row = q0 + threadIdx.x / kGroup;

  float q[kPer], dout[kPer], acc[kPer];
  load_row<D>(q, p.q, p.q_st, b, h, row, p.Sq, gi);
  load_row<D>(dout, p.dout, p.do_st, b, h, row, p.Sq, gi);
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  const long long bh = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  const float lse = row < p.Sq ? p.lse[bh + row] : 0.f;
  const float dl = row < p.Sq ? p.delta[bh + row] : 0.f;
  int lo, hi;
  key_tiles(p, q0, kTile, kF32Tile, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    stage_rows_f32<D>(ks, p.k, p.k_st, b, hk, k0, p.Sk);
    stage_rows_f32<D>(vs, p.v, p.v_st, b, hk, k0, p.Sk);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Tile; ++j) {
      bool valid;
      float chain;
      const float x = score(p, dot<D>(q, ks + j * D, gi), row, k0 + j, valid,
                            chain);
      const float dp = dot<D>(dout, vs + j * D, gi);
      const float ds = valid ? expf(x - lse) * (dp - dl) * chain : 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(ds, ks[j * D + gi + kGroup * i], acc[i]);
    }
  }
  store_row<D>(p.out0, p.out0_st, b, h, row, p.Sq, gi, acc, p.scale);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) dkv_f32(Params p) {
  constexpr int kPer = D / kGroup;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kF32Tile * D;
  float* lse_s = dos + kF32Tile * D;
  float* dl_s = lse_s + kF32Tile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int gi = threadIdx.x % kGroup;
  const int key = k0 + threadIdx.x / kGroup;

  float kr[kPer], vr[kPer], dk[kPer], dv[kPer];
  load_row<D>(kr, p.k, p.k_st, b, hk, key, p.Sk, gi);
  load_row<D>(vr, p.v, p.v_st, b, hk, key, p.Sk, gi);
#pragma unroll
  for (int i = 0; i < kPer; ++i) dk[i] = dv[i] = 0.f;
  int lo, hi;
  query_tiles(p, k0, kTile, kF32Tile, lo, hi);
  for (int r = 0; r < p.rep; ++r) {
    const int h = hk * p.rep + r;
    const long long bh = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kF32Tile;
      __syncthreads();
      stage_rows_f32<D>(qs, p.q, p.q_st, b, h, q0, p.Sq);
      stage_rows_f32<D>(dos, p.dout, p.do_st, b, h, q0, p.Sq);
      for (int i = threadIdx.x; i < kF32Tile; i += blockDim.x) {
        lse_s[i] = q0 + i < p.Sq ? p.lse[bh + q0 + i] : 0.f;
        dl_s[i] = q0 + i < p.Sq ? p.delta[bh + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kF32Tile; ++j) {
        bool valid;
        float chain;
        const float x = score(p, dot<D>(kr, qs + j * D, gi), q0 + j, key,
                              valid, chain);
        const float dpt = dot<D>(vr, dos + j * D, gi);
        const float pr = valid ? expf(x - lse_s[j]) : 0.f;
        const float ds = valid ? pr * (dpt - dl_s[j]) * chain : 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          dv[i] = fmaf(pr, dos[j * D + gi + kGroup * i], dv[i]);
          dk[i] = fmaf(ds, qs[j * D + gi + kGroup * i], dk[i]);
        }
      }
    }
  }
  store_row<D>(p.out0, p.out0_st, b, hk, key, p.Sk, gi, dk, p.scale);
  store_row<D>(p.out1, p.out1_st, b, hk, key, p.Sk, gi, dv, 1.f);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

enum class Kind { kFwd, kDq, kDkv };

// Dynamic shared memory of each body.
template <int D>
size_t smem_bytes(Kind kind, bool bf16_inputs) {
  if (bf16_inputs) {
    // 1024 bytes of slack to align the tiles (smem_base)
    const size_t cm = static_cast<size_t>(kTile) * D * sizeof(bf16);
    if (kind == Kind::kFwd)  // Q (128 rows), kFwdStages of K and V, a
      return 1024 + (2 + 2 * kFwdStages) * cm +  // barrier each
             kFwdStages * sizeof(uint64_t);
    if (kind == Kind::kDq)  // Q and dO (128 rows each), the ring, a barrier
      return 1024 + 4 * cm + KvRing<D>::bytes() + sizeof(uint64_t);
    // K and V of two key tiles, kDkvStages stages of Q, dO, lse and Delta,
    // and kDkvStages + 1 barriers
    return 1024 + (4 + 2 * kDkvStages) * cm +
           2 * kDkvStages * kTile * sizeof(float) +
           (kDkvStages + 1) * sizeof(uint64_t);
  }
  const size_t tile = static_cast<size_t>(kF32Tile) * D * sizeof(float);
  if (kind == Kind::kDkv) return 2 * tile + 2 * kF32Tile * sizeof(float);
  return 2 * tile;
}

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
               const Params& p, cudaStream_t stream) {
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel of `kind`, its block size and grid.
template <int D, bool kCap>
void bf16_kernel(Kind kind, int B, int Hkv, const Params& p,
                 void (*&fn)(Params), int& threads, dim3& grid) {
  if (kind == Kind::kFwd) {
    fn = fwd_mma<D, kCap>;
    threads = kWideThreads;
    grid = dim3(p.Hq, B, (p.Sq + kRows - 1) / kRows);
  } else if (kind == Kind::kDq) {
    fn = dq_mma<D, kCap>;
    threads = kWideThreads;
    grid = dim3(p.Hq, B, (p.Sq + kRows - 1) / kRows);
  } else {
    fn = dkv_mma<D, kCap>;
    threads = kWideThreads;
    grid = dim3(p.n_work, Hkv, B);
  }
}

template <int D>
int launch(Kind kind, bool bf16_inputs, int B, int Hkv, const Params& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(kind, bf16_inputs);
  if (bf16_inputs) {
    void (*fn)(Params) = nullptr;
    int threads = 0;
    dim3 grid;
    if (p.cap > 0.f)
      bf16_kernel<D, true>(kind, B, Hkv, p, fn, threads, grid);
    else
      bf16_kernel<D, false>(kind, B, Hkv, p, fn, threads, grid);
    return launch_one(fn, grid, threads, smem, p, stream);
  }
  const int n_q = (p.Sq + kTile - 1) / kTile;
  const int n_k = (p.Sk + kTile - 1) / kTile;
  const dim3 q_grid(n_q, p.Hq, B), k_grid(n_k, Hkv, B);
  if (kind == Kind::kFwd)
    return launch_one(fwd_f32<D>, q_grid, kF32Threads, smem, p, stream);
  if (kind == Kind::kDq)
    return launch_one(dq_f32<D>, q_grid, kF32Threads, smem, p, stream);
  return launch_one(dkv_f32<D>, k_grid, kF32Threads, smem, p, stream);
}

// Registers, local memory bytes a thread, dynamic shared memory, threads
// and resident blocks per SM of a bf16 kernel without a softcap, as the
// runtime sees them.
template <int D>
int bf16_info(Kind kind, int* out) {
  Params p = {};
  p.Hq = p.Sq = p.Sk = 1;
  void (*fn)(Params) = nullptr;
  int threads = 0;
  dim3 grid;
  bf16_kernel<D, false>(kind, 1, 1, p, fn, threads, grid);
  const size_t smem = smem_bytes<D>(kind, true);
  const void* f = reinterpret_cast<const void*>(fn);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err == cudaSuccess) err = allow_smem(f, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

// The TMA map of one (B, H, S, D) bf16 input with D contiguous, in the
// boxes tma_rows() asks for: for D >= 64 a 4-d map (D, S, H, B) with
// boxes of 64 columns x `rows` rows, 128-byte swizzled; for D = 32 a 5-d
// map (8 columns, S rows, D / 8 chunks, H, B) with boxes of (8, rows,
// D / 8, 1, 1). Rows past S land as zeros.
cudaError_t encode_rows(CUtensorMap* tm, const void* base, Strides st, int B,
                        int H, int S, int D, int rows) {
  const cuuint64_t s_b = static_cast<cuuint64_t>(st.s) * 2;
  const cuuint64_t h_b = static_cast<cuuint64_t>(st.h) * 2;
  const cuuint64_t b_b = static_cast<cuuint64_t>(st.b) * 2;
  const cuuint64_t n_s = static_cast<cuuint64_t>(S);
  const cuuint64_t n_h = static_cast<cuuint64_t>(H);
  const cuuint64_t n_b = static_cast<cuuint64_t>(B);
  const cuuint32_t r = static_cast<cuuint32_t>(rows);
  if (D >= 64) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), n_s, n_h, n_b};
    const cuuint64_t strides[3] = {s_b, h_b, b_b};
    const cuuint32_t box[4] = {64, r, 1, 1};
    return encode_tiled(tm, 4, base, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const cuuint64_t dims[5] = {8, n_s, static_cast<cuuint64_t>(D / 8), n_h,
                              n_b};
  const cuuint64_t strides[4] = {s_b, 16, h_b, b_b};
  const cuuint32_t box[5] = {8, r, static_cast<cuuint32_t>(D / 8), 1, 1};
  return encode_tiled(tm, 5, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

bool aligned16(const void* ptr, Strides st) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.s % 8 == 0;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

int dispatch(Kind kind, int dtype, int B, int Hkv, int D, Params& p,
             cudaStream_t stream) {
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || p.Hq <= 0 || Hkv <= 0 || p.Hq % Hkv != 0 || p.Sq <= 0 ||
      p.Sk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.rep = p.Hq / Hkv;
  const bool bf = dtype == repro::kBFloat16;
  p.vec_out = aligned16(p.out0, p.out0_st) &&
              (kind != Kind::kDkv || aligned16(p.out1, p.out1_st));
  // The launcher picks the copy route (copy_route in
  // kernels/flash_attention.py) and the dK/dV schedule (dkv_work); a tensor
  // map refuses a base or stride that is no multiple of 16 bytes.
  if (p.tma && !bf) return static_cast<int>(cudaErrorInvalidValue);
  if (bf && kind == Kind::kDkv && (p.work == nullptr || p.n_work <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma) {  // q tiles of 128 rows (forward, dQ) or 64 (dK/dV)
    const int q_rows = kind == Kind::kDkv ? kTile : kRows;
    cudaError_t err =
        encode_rows(&p.tm_q, p.q, p.q_st, B, p.Hq, p.Sq, D, q_rows);
    if (err == cudaSuccess)
      err = encode_rows(&p.tm_k, p.k, p.k_st, B, Hkv, p.Sk, D, kTile);
    if (err == cudaSuccess)
      err = encode_rows(&p.tm_v, p.v, p.v_st, B, Hkv, p.Sk, D, kTile);
    if (err == cudaSuccess && kind != Kind::kFwd)
      err = encode_rows(&p.tm_do, p.dout, p.do_st, B, p.Hq, p.Sq, D, q_rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (D) {
    case 32: return launch<32>(kind, bf, B, Hkv, p, stream);
    case 64: return launch<64>(kind, bf, B, Hkv, p, stream);
    case 128: return launch<128>(kind, bf, B, Hkv, p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(const void* q, const void* k, const void* v, int Hq,
                   int Sq, int Sk, float scale, float softcap, int window,
                   const long long* strides) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.Hq = Hq;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.cap = softcap;
  p.window = window;
  p.q_st = strides_at(strides, 0);
  p.k_st = strides_at(strides, 1);
  p.v_st = strides_at(strides, 2);
  return p;
}

}  // namespace

// Every entry point takes the element strides of its tensors as one host
// array of (batch, head, sequence) triples, in the order of its tensor
// arguments; lse and delta are contiguous (B, Hq, Sq) f32. softcap 0 means
// no softcap and window 0 no window. For bf16, tma 1 brings the tiles by
// TMA and 0 stages them by loads and stores; work is the dK/dV schedule,
// n_work rows of (key tile, first q tile, end q tile) x 2 in device
// memory, one row a block. Each returns cudaGetLastError()
// after its launch (0 on success).

// strides: q, k, v, o
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
    float softcap, int window, const long long* strides, int tma,
    void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
  p.tma = tma != 0;
  p.out0 = o;
  p.out0_st = strides_at(strides, 3);
  p.lse_out = static_cast<float*>(lse);
  return dispatch(Kind::kFwd, dtype, B, Hkv, D, p,
                  static_cast<cudaStream_t>(stream));
}

// strides: q, k, v, dout, dq
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int Hq,
    int Hkv, int Sq, int Sk, int D, float scale, float softcap, int window,
    const long long* strides, int tma, void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
  p.tma = tma != 0;
  p.dout = dout;
  p.do_st = strides_at(strides, 3);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = dq;
  p.out0_st = strides_at(strides, 4);
  return dispatch(Kind::kDq, dtype, B, Hkv, D, p,
                  static_cast<cudaStream_t>(stream));
}

// strides: q, k, v, dout, dk, dv
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int Hq, int Hkv, int Sq, int Sk, int D, float scale, float softcap,
    int window, const long long* strides, int tma, const int* work,
    int n_work, void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
  p.tma = tma != 0;
  p.work = work;
  p.n_work = n_work;
  p.dout = dout;
  p.do_st = strides_at(strides, 3);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = dk;
  p.out0_st = strides_at(strides, 4);
  p.out1 = dv;
  p.out1_st = strides_at(strides, 5);
  return dispatch(Kind::kDkv, dtype, B, Hkv, D, p,
                  static_cast<cudaStream_t>(stream));
}

#ifdef REPRO_FLASH_CLOCKS
// The clock records of the last forward launch (kClockSlots counts per
// (block, warpgroup) record, see CLOCKS_BEGIN) into out, at most n values.
extern "C" int flash_attention_clocks(long long* out, int n) {
  const int all = kClockRecords * kClockSlots;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_flash_clocks, sizeof(long long) * (n < all ? n : all)));
}
#endif

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the bf16 kernel `kind`
// (0 forward, 1 dQ, 2 dK/dV) at head dim D, without a softcap.
extern "C" int flash_attention_kernel_info(int kind, int D, int* out) {
  if (kind < 0 || kind > 2) return static_cast<int>(cudaErrorInvalidValue);
  const Kind k = static_cast<Kind>(kind);
  switch (D) {
    case 32: return bf16_info<32>(k, out);
    case 64: return bf16_info<64>(k, out);
    case 128: return bf16_info<128>(k, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
