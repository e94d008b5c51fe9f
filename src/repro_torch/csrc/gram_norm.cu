// Per-example Gram-pair norm:
//   s_b = sum_{t,t'} <h_t, h_t'> <zbar_t, zbar_t'>  (= || H_b^T Zbar_b ||_F^2)
// without ever forming the S x S Grams in device memory.
//
// Replaces the TPU kernel src/repro/kernels/gram_norm.py::gram_norm: the
// triangular grid (pallas_call at :297, body _kernel_tri at :127) and the
// full grid kept as its regression oracle (pallas_call at :254, body
// _kernel_full at :166); wrapper kernels/ops.py:67.
//
// h (B, S, P_in) and zbar (B, S, P_out), both f32 or both bf16, with the
// feature axis contiguous (batch and sequence strides are arguments);
// out (B,) f32.
//
// What bounds it on the H100: operations. Per example it does
// ~S^2 (P_in + P_out) multiply-adds on the triangle against S (P_in + P_out)
// input elements, i.e. S/2 flops per element read: ~256 at S=512, so at the
// slice's shapes it sits near the card's ~295 flops/byte balance in bf16 and
// far above it on the f32 pipes.
//
// Design: one block per (example, pair of 64-row sequence tiles). With
// `triangular` the pairs are the upper triangle i <= j and an off-diagonal
// pair counts twice (both Grams are symmetric, so pair (j, i) adds the same
// term); without it the block grid is all n_s^2 pairs. The block loops over
// P_in in feature chunks to build the 64x64 H-Gram tile in f32 registers,
// then over P_out to build the Zbar-Gram tile in the same register layout,
// so the fold sum(A .* B) needs no shared memory.
// Each block writes one f32 partial; a second launch sums each example's
// partials in a fixed order (deterministic, no atomics). Ragged S and P
// edges are masked at the load, so no padded copy of an input is made.
//
// Two bodies share that grid. f32 inputs run on the f32 FMA pipes (4x4 Gram
// entries per thread, exact f32 products). bf16 inputs run on the tensor
// cores: 8 warps, each owning a 32x16 piece of both 64x64 Gram tiles as 2x2
// mma.sync m16n8k16 fragments with f32 accumulators, fed by ldmatrix from
// 64-feature chunks staged in shared memory (rows padded by 16 bytes so the
// ldmatrix reads are free of bank conflicts). The two Grams use the same
// fragment layout, so the fold stays in registers. wgmma, TMA and pipelined
// stages are work for a later version.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kTile = 64;      // sequence rows per tile
constexpr int kChunk = 32;     // features staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 Gram entries each

// The sequence tiles (ti, tj) of block `pair` and the pair's weight: with
// `triangular`, a row-major walk of the upper triangle (row i holds n_s - i
// pairs) where an off-diagonal pair stands in for its mirror twin (weight 2);
// otherwise the full n_s x n_s grid (weight 1).
__device__ __forceinline__ float pair_tiles(int pair, int n_s, int triangular,
                                            int* ti, int* tj) {
  if (!triangular) {
    *ti = pair / n_s;
    *tj = pair % n_s;
    return 1.f;
  }
  int i = 0, rem = pair;
  while (rem >= n_s - i) {
    rem -= n_s - i;
    ++i;
  }
  *ti = i;
  *tj = i + rem;
  return rem == 0 ? 1.f : 2.f;
}

// acc[r][c] += sum_p x[r0 + ty + 16 r][p] * x[c0 + tx + 16 c][p] over the
// whole feature axis. xi/xj are [kChunk][kTile + 1] staging buffers (the +1
// keeps the transposed stores free of bank conflicts).
template <typename T>
__device__ __forceinline__ void gram_tile(const T* __restrict__ x, long long ss,
                                          int S, int P, int r0, int c0,
                                          float (*xi)[kTile + 1],
                                          float (*xj)[kTile + 1],
                                          float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < P; k0 += kChunk) {
    for (int e = tid; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      const int p = k0 + k;
      const int si = r0 + r, sj = c0 + r;
      xi[k][r] = (si < S && p < P) ? to_f32(x[si * ss + p]) : 0.f;
      xj[k][r] = (sj < S && p < P) ? to_f32(x[sj * ss + p]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float a[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = xi[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = xj[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
    }
    __syncthreads();
  }
}

// The f32 body.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial(const T* __restrict__ h, const T* __restrict__ z,
             float* __restrict__ partial, int S, int P_in, int P_out,
             long long h_sb, long long h_ss, long long z_sb, long long z_ss,
             int n_s, int triangular) {
  __shared__ float xi[kChunk][kTile + 1];
  __shared__ float xj[kChunk][kTile + 1];
  __shared__ float red[kThreads / 32];

  const int pair = blockIdx.x;
  const int b = blockIdx.y;
  int ti, tj;
  const float weight = pair_tiles(pair, n_s, triangular, &ti, &tj);

  float ga[4][4], gz[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) ga[r][c] = gz[r][c] = 0.f;

  gram_tile<T>(h + b * h_sb, h_ss, S, P_in, ti * kTile, tj * kTile, xi, xj, ga);
  gram_tile<T>(z + b * z_sb, z_ss, S, P_out, ti * kTile, tj * kTile, xi, xj,
               gz);

  float v = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) v = fmaf(ga[r][c], gz[r][c], v);
  v = repro::block_sum(v, red);
  if (threadIdx.x == 0)
    partial[static_cast<long long>(b) * gridDim.x + pair] = weight * v;
}

constexpr int kChunkMma = 64;          // features staged per step (bf16)
constexpr int kLd = kChunkMma + 8;     // padded shared row, in bf16 elements

// acc[mi][ni] += fragments of x[r0 + rows] . x[c0 + rows]^T over the whole
// feature axis, for this warp's 32x16 piece (rows wm.., columns wn..) of the
// 64x64 Gram tile. xi/xj are [kTile][kLd] staging buffers.
__device__ __forceinline__ void gram_tile_mma(
    const __nv_bfloat16* __restrict__ x, long long ss, int S, int P, int r0,
    int c0, bool vec, __nv_bfloat16 (*xi)[kLd], __nv_bfloat16 (*xj)[kLd],
    float acc[2][2][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int lr = lane & 7, lj = lane >> 3;
  for (int k0 = 0; k0 < P; k0 += kChunkMma) {
    // each chunk sums into fresh fragments that are then added to acc, so
    // no tensor-core accumulation chain is longer than one chunk (the long
    // feature axes of a head-sized layer would otherwise lose digits)
    float part[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.f;
    for (int q = tid; q < kTile * (kChunkMma / 8); q += kThreads) {
      const int r = q / (kChunkMma / 8), c = (q % (kChunkMma / 8)) * 8;
      const int si = r0 + r, sj = c0 + r;
      if (si < S)
        repro::stage8_bf16(x + si * ss, k0 + c, P, vec, &xi[r][c]);
      else
        *reinterpret_cast<uint4*>(&xi[r][c]) = make_uint4(0u, 0u, 0u, 0u);
      if (sj < S)
        repro::stage8_bf16(x + sj * ss, k0 + c, P, vec, &xj[r][c]);
      else
        *reinterpret_cast<uint4*>(&xj[r][c]) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunkMma; kk += 16) {
      // A = rows of tile i (row-major, depth = features): matrix j covers
      // rows + (j & 1) * 8 and features + (j >> 1) * 8
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        repro::ldmatrix_x4(a[mi],
                           &xi[wm + mi * 16 + lr + (lj & 1) * 8][kk + (lj >> 1) * 8]);
      // B = rows of tile j, read as columns: matrix j covers columns
      // + (j >> 1) * 8 and features + (j & 1) * 8
      uint32_t t[4];
      repro::ldmatrix_x4(t, &xj[wn + lr + (lj >> 1) * 8][kk + (lj & 1) * 8]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        repro::mma_bf16_16816(part[mi][0], a[mi], t[0], t[1]);
        repro::mma_bf16_16816(part[mi][1], a[mi], t[2], t[3]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
    __syncthreads();
  }
}

// The bf16 body: the same pair term, on the tensor cores.
__global__ void __launch_bounds__(kThreads)
gram_partial_mma(const __nv_bfloat16* __restrict__ h,
                 const __nv_bfloat16* __restrict__ z,
                 float* __restrict__ partial, int S, int P_in, int P_out,
                 long long h_sb, long long h_ss, long long z_sb,
                 long long z_ss, int n_s, int triangular, bool h_vec,
                 bool z_vec) {
  __shared__ __align__(16) __nv_bfloat16 xi[kTile][kLd];
  __shared__ __align__(16) __nv_bfloat16 xj[kTile][kLd];
  __shared__ float red[kThreads / 32];

  const int pair = blockIdx.x;
  const int b = blockIdx.y;
  int ti, tj;
  const float weight = pair_tiles(pair, n_s, triangular, &ti, &tj);

  float ga[2][2][4], gz[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) ga[mi][ni][e] = gz[mi][ni][e] = 0.f;

  gram_tile_mma(h + b * h_sb, h_ss, S, P_in, ti * kTile, tj * kTile, h_vec,
                xi, xj, ga);
  gram_tile_mma(z + b * z_sb, z_ss, S, P_out, ti * kTile, tj * kTile, z_vec,
                xi, xj, gz);

  float v = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) v = fmaf(ga[mi][ni][e], gz[mi][ni][e], v);
  v = repro::block_sum(v, red);
  if (threadIdx.x == 0)
    partial[static_cast<long long>(b) * gridDim.x + pair] = weight * v;
}

// 16-byte loads need an aligned base and row strides in whole 8-element
// steps; otherwise the staging falls back to element loads.
bool vec_ok(const void* p, long long sb, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0;
}

int n_tiles(int S) { return (S + kTile - 1) / kTile; }

int n_pairs(int S, int triangular) {
  const int n = n_tiles(S);
  return triangular ? n * (n + 1) / 2 : n * n;
}

template <typename T>
int launch(const void* h, const void* z, float* partial, float* out, int B,
           int S, int P_in, int P_out, long long h_sb, long long h_ss,
           long long z_sb, long long z_ss, int triangular,
           cudaStream_t stream) {
  const int pairs = n_pairs(S, triangular);
  dim3 grid(pairs, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    gram_partial_mma<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), partial, S, P_in,
        P_out, h_sb, h_ss, z_sb, z_ss, n_tiles(S), triangular,
        vec_ok(h, h_sb, h_ss), vec_ok(z, z_sb, z_ss));
  } else {
    gram_partial<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), partial, S, P_in,
        P_out, h_sb, h_ss, z_sb, z_ss, n_tiles(S), triangular);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::reduce_partials<<<B, repro::kReduceThreads, 0, stream>>>(partial, out,
                                                                  pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of per-block partials per example (the tile pairs the grid visits):
// the wrapper allocates a (B, n) f32 scratch buffer of this width.
extern "C" int gram_norm_blocks(int S, int triangular) {
  return n_pairs(S, triangular);
}

// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int gram_norm_launch(const void* h, const void* z, void* partial,
                                void* out, int dtype, int B, int S, int P_in,
                                int P_out, long long h_sb, long long h_ss,
                                long long z_sb, long long z_ss, int triangular,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32)
    return launch<float>(h, z, part, o, B, S, P_in, P_out, h_sb, h_ss, z_sb,
                         z_ss, triangular, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(h, z, part, o, B, S, P_in, P_out, h_sb, h_ss,
                                 z_sb, z_ss, triangular, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
