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
// registers.
//
// Design. The grid has no order on the card, so each block owns one output
// tile and loops over the other sequence axis inside itself: forward and dQ
// one block per (batch, q head, 64-row q tile), walking the key tiles only
// up to the causal diagonal and from the window's first tile on; dK/dV one
// block per (batch, kv head, 64-key tile), walking the rep q heads of its
// group and the q tiles from the diagonal on. Each block writes its output
// tile once: no atomics, no second pass, so the gradients are bitwise the
// same on every run.
//
// bf16 runs on the tensor cores: 4 warps, each owning 16 rows of the tile;
// mma.sync m16n8k16 with f32 accumulation, operands brought in from shared
// memory by ldmatrix (.trans for the operands stored [k][n]). The score
// fragment of S = Q K^T is the A fragment of P V once packed to bf16, so P
// never leaves registers (the FlashAttention-2 layout). m, l and the O, dQ,
// dK and dV accumulators live in f32 registers for the whole loop. f32 runs
// on the FMA pipes: 4 threads per row, each owning D/4 of the features, with
// the dot products summed over the 4 by warp shuffles in a fixed order.
//
// Not yet: wgmma, TMA, a cp.async ring of stages (the tiles are staged
// synchronously), and a persistent schedule; these are the work of a later
// version, as is writing the outputs through shared memory for wider stores.
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1.0e30f;  // the reference's NEG_INF

struct Strides {
  long long b, h, s;
};

// Everything a launch needs, passed by value.
struct Params {
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
  bool vec;              // 16-byte loads for every bf16 input row
};

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
  valid = j <= i && i < p.Sq && j < p.Sk && (p.window <= 0 || i - j < p.window);
  return valid ? x : kNegInf;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores, 4 warps x 16 rows of a 64-row tile
// ---------------------------------------------------------------------------

constexpr int kTile = 64;          // rows of a q tile and of a key tile
constexpr int kMmaThreads = 128;   // 4 warps

// Copy rows [s0, s0 + 64) of one (b, h) slice into shared memory as
// [64][D + 8] (rows padded by 16 bytes: ldmatrix reads are free of bank
// conflicts); rows at or past S read as 0.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const void* base,
                                           Strides st, int b, int h, int s0,
                                           int S, bool vec) {
  constexpr int kLd = D + 8, kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    bf16* d = dst + r * kLd + col;
    if (s0 + r < S)
      repro::stage8_bf16(row_ptr<bf16>(base, st, b, h, s0 + r), col, D, vec, d);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// A operand: the 16x16 block at (row0, col0) of a row-major [m][k] tile.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int row0, int col0, int lane) {
  repro::ldmatrix_x4(a, s + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// B operands of two 8-wide n blocks (n0 .. n0 + 15) at depth k0 .. k0 + 15,
// from a tile stored [n][k]: b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const bf16* s, int ld,
                                          int n0, int k0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  repro::ldmatrix_x4(b, s + (n0 + r + (j >> 1) * 8) * ld + k0 + (j & 1) * 8);
}

// The same from a tile stored [k][n], transposed on the way in.
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const bf16* s, int ld,
                                          int k0, int n0, int lane) {
  const int j = lane >> 3, r = lane & 7;
  repro::ldmatrix_x4_trans(b, s + (k0 + r + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 64) += A[row0 .. row0 + 16) . B^T for two [64][D] tiles: the
// warp's rows of A against all 64 rows of B (Q K^T, dO V^T, K Q^T, V dO^T).
template <int D>
__device__ __forceinline__ void mma_abt(float c[8][4], const bf16* a_s,
                                        const bf16* b_s, int row0, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    load_a(a, a_s, kLd, row0, kc * 16, lane);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      uint32_t b[4];
      load_b_nk(b, b_s, kLd, n2 * 16, kc * 16, lane);
      repro::mma_bf16_16816(c[2 * n2], a, b[0], b[1]);
      repro::mma_bf16_16816(c[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// c (16 x D) += X . B, X (16 x 64) the accumulator fragments of mma_abt,
// rounded to bf16 (the C fragment of m16n8 is the A fragment of m16k16),
// and B a [64][D] tile (P V, dS K, P^T dO, dS^T Q).
template <int D>
__device__ __forceinline__ void mma_xb(float c[D / 8][4], const float x[8][4],
                                       const bf16* b_s, int lane) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t a[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                           pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                           pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                           pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      load_b_kn(b, b_s, kLd, kc * 16, n2 * 16, lane);
      repro::mma_bf16_16816(c[2 * n2], a, b[0], b[1]);
      repro::mma_bf16_16816(c[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// Write the warp's 16 x D fragments, times mul[half], to rows row (half 0)
// and row + 8 (half 1) of one (b, h) slice; rows at or past S are skipped.
template <int D>
__device__ __forceinline__ void store_frags(void* base, Strides st, int b,
                                            int h, int row, int S,
                                            const float c[D / 8][4],
                                            const float mul[2], int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + half * 8;
    if (r >= S) continue;
    bf16* dst = static_cast<bf16*>(base) + b * st.b + h * st.h + r * st.s;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      dst[nd * 8 + 2 * t] = __float2bfloat16(c[nd][2 * half] * mul[half]);
      dst[nd * 8 + 2 * t + 1] = __float2bfloat16(c[nd][2 * half + 1] * mul[half]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float c[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) fwd_mma(Params p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLd;
  bf16* vs = ks + kTile * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int row = q0 + warp * 16 + (lane >> 2);  // and row + 8

  stage_tile<D>(qs, p.q, p.q_st, b, h, q0, p.Sq, p.vec);

  float o[D / 8][4];
  zero<D / 8>(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int lo, hi;
  key_tiles(p, q0, kTile, kTile, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage_tile<D>(ks, p.k, p.k_st, b, hk, k0, p.Sk, p.vec);
    stage_tile<D>(vs, p.v, p.v_st, b, hk, k0, p.Sk, p.vec);
    __syncthreads();

    float s[8][4];
    zero<8>(s);
    mma_abt<D>(s, qs, ks, warp * 16, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool valid;
        float chain;
        s[nj][e] = score(p, s[nj][e], row + (e >> 1) * 8,
                         k0 + nj * 8 + 2 * t + (e & 1), valid, chain);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nj][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nj][e] = expf(s[nj][e] - m[e >> 1]);
        sum[e >> 1] += s[nj][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= corr[e >> 1];
    mma_xb<D>(o, s, vs, lane);
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
  store_frags<D>(p.out0, p.out0_st, b, h, row, p.Sq, o, inv, lane);
  if (t == 0) {
    float* lse = p.lse_out + (static_cast<long long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row + i * 8 < p.Sq) lse[row + i * 8] = m[i] + logf(l[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) dq_mma(Params p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * kLd;
  bf16* ks = dos + kTile * kLd;
  bf16* vs = ks + kTile * kLd;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int row = q0 + warp * 16 + (lane >> 2);

  stage_tile<D>(qs, p.q, p.q_st, b, h, q0, p.Sq, p.vec);
  stage_tile<D>(dos, p.dout, p.do_st, b, h, q0, p.Sq, p.vec);
  const long long bh = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + i * 8;
    lse[i] = r < p.Sq ? p.lse[bh + r] : 0.f;
    dl[i] = r < p.Sq ? p.delta[bh + r] : 0.f;
  }

  float acc[D / 8][4];
  zero<D / 8>(acc);
  int lo, hi;
  key_tiles(p, q0, kTile, kTile, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage_tile<D>(ks, p.k, p.k_st, b, hk, k0, p.Sk, p.vec);
    stage_tile<D>(vs, p.v, p.v_st, b, hk, k0, p.Sk, p.vec);
    __syncthreads();

    float s[8][4], dp[8][4];
    zero<8>(s);
    zero<8>(dp);
    mma_abt<D>(s, qs, ks, warp * 16, lane);
    mma_abt<D>(dp, dos, vs, warp * 16, lane);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool valid;
        float chain;
        const int i = e >> 1;
        const float x = score(p, s[nj][e], row + i * 8,
                              k0 + nj * 8 + 2 * t + (e & 1), valid, chain);
        const float pr = valid ? expf(x - lse[i]) : 0.f;
        s[nj][e] = valid ? pr * (dp[nj][e] - dl[i]) * chain : 0.f;  // dS
      }
    mma_xb<D>(acc, s, ks, lane);
  }
  const float mul[2] = {p.scale, p.scale};
  store_frags<D>(p.out0, p.out0_st, b, h, row, p.Sq, acc, mul, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) dkv_mma(Params p) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kLd;
  bf16* qs = vs + kTile * kLd;
  bf16* dos = qs + kTile * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * kLd);
  float* dl_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;  // the first key tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3;
  const int key = k0 + warp * 16 + (lane >> 2);  // and key + 8

  stage_tile<D>(ks, p.k, p.k_st, b, hk, k0, p.Sk, p.vec);
  stage_tile<D>(vs, p.v, p.v_st, b, hk, k0, p.Sk, p.vec);

  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);
  int lo, hi;
  query_tiles(p, k0, kTile, kTile, lo, hi);
  for (int r = 0; r < p.rep; ++r) {
    const int h = hk * p.rep + r;
    const long long bh = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      stage_tile<D>(qs, p.q, p.q_st, b, h, q0, p.Sq, p.vec);
      stage_tile<D>(dos, p.dout, p.do_st, b, h, q0, p.Sq, p.vec);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        lse_s[i] = q0 + i < p.Sq ? p.lse[bh + q0 + i] : 0.f;
        dl_s[i] = q0 + i < p.Sq ? p.delta[bh + q0 + i] : 0.f;
      }
      __syncthreads();

      // rows are this warp's keys, columns the tile's 64 queries
      float st[8][4], dpt[8][4];
      zero<8>(st);
      zero<8>(dpt);
      mma_abt<D>(st, ks, qs, warp * 16, lane);
      mma_abt<D>(dpt, vs, dos, warp * 16, lane);
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool valid;
          float chain;
          const int c = nj * 8 + 2 * t + (e & 1);
          const float x = score(p, st[nj][e], q0 + c, key + (e >> 1) * 8,
                                valid, chain);
          const float pr = valid ? expf(x - lse_s[c]) : 0.f;
          st[nj][e] = pr;                                            // P^T
          dpt[nj][e] = valid ? pr * (dpt[nj][e] - dl_s[c]) * chain : 0.f;  // dS^T
        }
      mma_xb<D>(dv, st, dos, lane);
      mma_xb<D>(dk, dpt, qs, lane);
    }
  }
  const float mul_k[2] = {p.scale, p.scale}, one[2] = {1.f, 1.f};
  store_frags<D>(p.out0, p.out0_st, b, hk, key, p.Sk, dk, mul_k, lane);
  store_frags<D>(p.out1, p.out1_st, b, hk, key, p.Sk, dv, one, lane);
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

// Dynamic shared memory of each body (above 48 KB only after the attribute
// is raised, which launch() does for every launch).
template <int D>
size_t smem_bytes(Kind kind, bool bf16_inputs) {
  if (bf16_inputs) {
    const size_t tile = static_cast<size_t>(kTile) * (D + 8) * sizeof(bf16);
    if (kind == Kind::kFwd) return 3 * tile;
    if (kind == Kind::kDq) return 4 * tile;
    return 4 * tile + 2 * kTile * sizeof(float);
  }
  const size_t tile = static_cast<size_t>(kF32Tile) * D * sizeof(float);
  if (kind == Kind::kDkv) return 2 * tile + 2 * kF32Tile * sizeof(float);
  return 2 * tile;
}

template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
               const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(Kind kind, bool bf16_inputs, int B, int Hkv, const Params& p,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(kind, bf16_inputs);
  const int n_q = (p.Sq + kTile - 1) / kTile;
  const int n_k = (p.Sk + kTile - 1) / kTile;
  const dim3 q_grid(n_q, p.Hq, B), k_grid(n_k, Hkv, B);
  if (bf16_inputs) {
    if (kind == Kind::kFwd)
      return launch_one(fwd_mma<D>, q_grid, kMmaThreads, smem, p, stream);
    if (kind == Kind::kDq)
      return launch_one(dq_mma<D>, q_grid, kMmaThreads, smem, p, stream);
    return launch_one(dkv_mma<D>, k_grid, kMmaThreads, smem, p, stream);
  }
  if (kind == Kind::kFwd)
    return launch_one(fwd_f32<D>, q_grid, kF32Threads, smem, p, stream);
  if (kind == Kind::kDq)
    return launch_one(dq_f32<D>, q_grid, kF32Threads, smem, p, stream);
  return launch_one(dkv_f32<D>, k_grid, kF32Threads, smem, p, stream);
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
  p.vec = aligned16(p.q, p.q_st) && aligned16(p.k, p.k_st) &&
          aligned16(p.v, p.v_st) &&
          (kind == Kind::kFwd || aligned16(p.dout, p.do_st));
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
// no softcap and window 0 no window. Each returns cudaGetLastError() after
// its launch (0 on success).

// strides: q, k, v, o
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int Hq, int Hkv, int Sq, int Sk, int D, float scale,
    float softcap, int window, const long long* strides, void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
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
    const long long* strides, void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
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
    int window, const long long* strides, void* stream) {
  Params p = make_params(q, k, v, Hq, Sq, Sk, scale, softcap, window, strides);
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
