// Per-segment direct norm over rows sorted by segment:
//   out[j] = || sum_{r in segment j} h_r zbar_r^T ||_F^2.
//
// Replaces the TPU kernel
// src/repro/kernels/segmented_norm.py::segmented_norm_sorted (pallas_call
// at :204, body _kernel at :123; wrapper kernels/ops.py:177).
//
// h (T, P_in) and zbar (T, P_out), both f32 or both bf16, with the feature
// axis contiguous and any row stride; rows (T,) int32, the rows in segment
// order (the wrapper's stable argsort of the segment keys); offsets
// (n_seg + 1,) int32: segment j owns sorted positions
// [offsets[j], offsets[j + 1]). Rows of the drop bucket (capacity padding)
// sort after offsets[n_seg] and are never read. out (n_seg,) f32.
//
// What bounds this kernel on the H100: operations. It computes the direct
// form, 2 * n_valid * P_in * P_out against (P_in + P_out) input elements
// per row: at the MoE gate projection (4096 -> 6400) in bf16 that is
// ~2,500 flops per input byte, far above the card's ~295 flops/byte
// balance point. The function itself needs far less: a segment of n rows
// also equals sum_{r,r'} <h_r,h_r'> <zbar_r,zbar_r'>, 2 * n^2 * (P_in +
// P_out + 1) operations, and over the MoE path's segments (~28 kept rows
// each on average) that gram form is ~57x less arithmetic than the direct
// form (chip_smoke.py's table phase), which leaves the function bound by
// the bytes of the kept rows. A gram-form body (two
// n x n Grams per segment, as gram_norm.cu does per example) is later
// work. What must never reach device memory is the per-segment gradient
// G_j (n_seg * P_in * P_out f32: 54 GB at the gate shape with 512
// segments).
//
// Design: the reference's streaming order. One block per (128-wide P_in
// tile, 128-wide P_out tile) walks the segments in order and sweeps each
// segment's rows, staging them through the permutation (no sorted copy of
// h or zbar exists) into shared memory and accumulating its 128x128 tile
// of G_j in f32 registers. At the segment's end it squares and sums the
// tile into partial[j, tile] and resets; an empty segment writes 0 without
// touching the inputs. A second launch sums each segment's partials in a
// fixed order: no atomics, so the result is bitwise reproducible. Ragged
// P_in and P_out edges and the rows past a segment's end inside the last
// staged chunk are masked at the load (read as 0), so no padded copy is
// made. The segments of the MoE path are small (~30 rows), so the bf16
// body stages 32 rows at a time and skips the second 16-row k-step of a
// chunk that holds no row there.
//
// Bodies, as in direct_norm.cu: f32 inputs on the FMA pipes (8x8 per
// thread, exact f32 products); bf16 inputs on the tensor cores (8 warps,
// each a 64x32 piece of the tile as 4x4 mma.sync m16n8k16 fragments with
// f32 accumulators, operands through ldmatrix.trans). wgmma, TMA, a
// pipelined ring and load balancing across segments are later work.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kTile = 128;     // P_in and P_out columns of G per block
constexpr int kRows = 16;      // rows staged per step (f32)
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 elements of G each

// The f32 body.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segmented_partial(const T* __restrict__ h, const T* __restrict__ z,
                  const int* __restrict__ rows,
                  const int* __restrict__ offsets,
                  float* __restrict__ partial, int n_seg, int P_in,
                  int P_out, long long h_ss, long long z_ss) {
  __shared__ float hs[kRows][kTile];
  __shared__ float zs[kRows][kTile];
  __shared__ float red[kThreads / 32];

  const int co = blockIdx.x;  // P_out tile
  const int ci = blockIdx.y;  // P_in tile
  const long long n_tiles = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long tile = static_cast<long long>(ci) * gridDim.x + co;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = ci * kTile;
  const int o0 = co * kTile;

  for (int j = 0; j < n_seg; ++j) {
    const int r0 = offsets[j];
    const int r1 = offsets[j + 1];
    if (r0 >= r1) {  // empty segment: uniform across the block
      if (tid == 0) partial[j * n_tiles + tile] = 0.f;
      continue;
    }
    // acc[r][c] = G_j[i0 + ty + 16 r][o0 + tx + 16 c]
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int s0 = r0; s0 < r1; s0 += kRows) {
      for (int e = tid; e < kRows * kTile; e += kThreads) {
        const int t = e / kTile, c = e % kTile;
        const int s = s0 + t;
        float hv = 0.f, zv = 0.f;
        if (s < r1) {
          const long long row = rows[s];
          if (i0 + c < P_in) hv = to_f32(h[row * h_ss + i0 + c]);
          if (o0 + c < P_out) zv = to_f32(z[row * z_ss + o0 + c]);
        }
        hs[t][c] = hv;
        zs[t][c] = zv;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        float a[8], v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = hs[t][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = zs[t][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], v[c], acc[r][c]);
      }
      __syncthreads();
    }

    float sq = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) sq = fmaf(acc[r][c], acc[r][c], sq);
    // the staging loop's closing __syncthreads separates this block_sum's
    // use of `red` from the previous segment's
    sq = repro::block_sum(sq, red);
    if (tid == 0) partial[j * n_tiles + tile] = sq;
  }
}

constexpr int kStage = 32;       // rows staged per step (bf16)
constexpr int kLd = kTile + 8;   // padded shared row, in bf16 elements

// The bf16 body: the same tile of G_j, on the tensor cores.
__global__ void __launch_bounds__(kThreads)
segmented_partial_mma(const __nv_bfloat16* __restrict__ h,
                      const __nv_bfloat16* __restrict__ z,
                      const int* __restrict__ rows,
                      const int* __restrict__ offsets,
                      float* __restrict__ partial, int n_seg, int P_in,
                      int P_out, long long h_ss, long long z_ss, bool h_vec,
                      bool z_vec) {
  __shared__ __align__(16) __nv_bfloat16 hs[kStage][kLd];
  __shared__ __align__(16) __nv_bfloat16 zs[kStage][kLd];
  __shared__ float red[kThreads / 32];

  const int co = blockIdx.x, ci = blockIdx.y;
  const long long n_tiles = static_cast<long long>(gridDim.x) * gridDim.y;
  const long long tile = static_cast<long long>(ci) * gridDim.x + co;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // this warp's rows of the tile (P_in)
  const int wn = (warp & 3) * 32;   // and columns (P_out)
  const int i0 = ci * kTile, o0 = co * kTile;
  // ldmatrix addressing: lane l feeds row (l & 7) of matrix (l >> 3)
  const int lr = lane & 7, lj = lane >> 3;

  for (int j = 0; j < n_seg; ++j) {
    const int r0 = offsets[j];
    const int r1 = offsets[j + 1];
    if (r0 >= r1) {  // empty segment: uniform across the block
      if (tid == 0) partial[j * n_tiles + tile] = 0.f;
      continue;
    }
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int s0 = r0; s0 < r1; s0 += kStage) {
      for (int q = tid; q < kStage * (kTile / 8); q += kThreads) {
        const int r = q / (kTile / 8), c = (q % (kTile / 8)) * 8;
        const int s = s0 + r;
        if (s < r1) {
          const long long row = rows[s];
          repro::stage8_bf16(h + row * h_ss, i0 + c, P_in, h_vec, &hs[r][c]);
          repro::stage8_bf16(z + row * z_ss, o0 + c, P_out, z_vec, &zs[r][c]);
        } else {
          *reinterpret_cast<uint4*>(&hs[r][c]) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(&zs[r][c]) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __syncthreads();
      const int n_k = min(kStage, r1 - s0);  // staged rows that hold data
      for (int kk = 0; kk < n_k; kk += 16) {
        // A = H^T (rows i, depth s): matrix j covers i + (j & 1) * 8 and
        // s + (j >> 1) * 8; stored as hs[s][i], hence the transpose
        uint32_t a[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          repro::ldmatrix_x4_trans(
              a[mi],
              &hs[kk + lr + (lj >> 1) * 8][wm + mi * 16 + (lj & 1) * 8]);
        // B = Zbar (depth s, columns o): matrix j covers s + (j & 1) * 8
        // and o + (j >> 1) * 8, i.e. both halves of two 8-wide column blocks
        uint32_t bf[4][2];
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          uint32_t t[4];
          repro::ldmatrix_x4_trans(
              t, &zs[kk + lr + (lj & 1) * 8][wn + nj * 16 + (lj >> 1) * 8]);
          bf[2 * nj][0] = t[0];
          bf[2 * nj][1] = t[1];
          bf[2 * nj + 1][0] = t[2];
          bf[2 * nj + 1][1] = t[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            repro::mma_bf16_16816(acc[mi][ni], a[mi], bf[ni][0], bf[ni][1]);
      }
      __syncthreads();
    }

    float sq = 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sq = fmaf(acc[mi][ni][e], acc[mi][ni][e], sq);
    // the staging loop's closing __syncthreads separates this block_sum's
    // use of `red` from the previous segment's
    sq = repro::block_sum(sq, red);
    if (tid == 0) partial[j * n_tiles + tile] = sq;
  }
}

// 16-byte loads need an aligned base and a row stride in whole 8-element
// steps; otherwise the staging falls back to element loads.
bool vec_ok(const void* p, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ss % 8 == 0;
}

int tiles(int P_in, int P_out) {
  return ((P_in + kTile - 1) / kTile) * ((P_out + kTile - 1) / kTile);
}

template <typename T>
int launch(const void* h, const void* z, const int* rows, const int* offsets,
           float* partial, float* out, int n_seg, int P_in, int P_out,
           long long h_ss, long long z_ss, cudaStream_t stream) {
  const int n_ci = (P_in + kTile - 1) / kTile;
  const int n_co = (P_out + kTile - 1) / kTile;
  dim3 grid(n_co, n_ci);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    segmented_partial_mma<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), rows, offsets,
        partial, n_seg, P_in, P_out, h_ss, z_ss, vec_ok(h, h_ss),
        vec_ok(z, z_ss));
  } else {
    segmented_partial<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), rows, offsets,
        partial, n_seg, P_in, P_out, h_ss, z_ss);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // partial is (n_seg, tiles): one row of partials per segment
  repro::reduce_partials<<<n_seg, repro::kReduceThreads, 0, stream>>>(
      partial, out, tiles(P_in, P_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of per-block partials per segment: the wrapper allocates an
// (n_seg, n) f32 scratch buffer of this width.
extern "C" int segmented_norm_tiles(int P_in, int P_out) {
  return tiles(P_in, P_out);
}

// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int segmented_norm_launch(const void* h, const void* z,
                                     const void* rows, const void* offsets,
                                     void* partial, void* out, int dtype,
                                     int n_seg, int P_in, int P_out,
                                     long long h_ss, long long z_ss,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int* off = static_cast<const int*>(offsets);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32)
    return launch<float>(h, z, r, off, part, o, n_seg, P_in, P_out, h_ss,
                         z_ss, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(h, z, r, off, part, o, n_seg, P_in, P_out,
                                 h_ss, z_ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
