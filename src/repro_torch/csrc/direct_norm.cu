// Per-example direct norm: s_b = || H_b^T Zbar_b ||_F^2.
//
// Replaces the TPU kernel src/repro/kernels/direct_norm.py::direct_norm
// (pallas_call at :141, body _kernel at :86; wrapper kernels/ops.py:100).
//
// h (B, S, P_in) and zbar (B, S, P_out), both f32 or both bf16, with the
// feature axis contiguous (strides of the batch and sequence axes are
// arguments); out (B,) f32.
//
// What bounds it on the H100: operations. The work is the per-example
// contraction 2*S*P_in*P_out, against only S*(P_in + P_out) input elements:
// at the LM head (P_out = 128256) that is 2.15e12 flops for 1.1 GB of bf16
// input at B=8, S=512, far above the card's ~295 flops/byte balance point.
// The per-example gradient G_b = H_b^T Zbar_b (8.4 GB in f32 at the head) is
// what must never reach device memory.
//
// Design: one block per (example, 128-wide P_in tile, 128-wide P_out tile).
// The block sweeps the sequence, stages the two row panels in shared memory,
// and accumulates its 128x128 tile of G_b in f32 registers. At the end of the sweep it squares and
// sums the tile into one f32 partial; no G_b element leaves the SM. A second
// launch sums the partials of each example in a fixed order, so the result
// is deterministic. Ragged S, P_in and P_out edges are masked at the load
// (out-of-range elements read as 0, which adds nothing to G_b), so no padded
// copy of an input is ever made.
//
// Two bodies share that grid and partial layout. f32 inputs run on the f32
// FMA pipes (8x8 per thread, exact f32 products). bf16 inputs run on the
// tensor cores: 8 warps, each owning a 64x32 piece of the tile as 4x4
// mma.sync m16n8k16 fragments with f32 accumulators; the sequence is staged
// 64 rows at a time in shared memory (rows padded by 16 bytes so ldmatrix
// reads are free of bank conflicts) and ldmatrix.trans turns the row panels
// into the H^T and Zbar operands. wgmma, TMA and a pipelined ring of stages
// are work for a later version.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kTileIn = 128;   // P_in columns of G per block
constexpr int kTileOut = 128;  // P_out columns of G per block
constexpr int kRows = 16;      // sequence rows staged per step
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 elements of G each

// The f32 body.
template <typename T>
__global__ void __launch_bounds__(kThreads)
direct_partial(const T* __restrict__ h, const T* __restrict__ z,
               float* __restrict__ partial, int S, int P_in, int P_out,
               long long h_sb, long long h_ss, long long z_sb, long long z_ss) {
  __shared__ float hs[kRows][kTileIn];
  __shared__ float zs[kRows][kTileOut];
  __shared__ float red[kThreads / 32];

  const int co = blockIdx.x;  // P_out tile
  const int ci = blockIdx.y;  // P_in tile
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int i0 = ci * kTileIn;
  const int o0 = co * kTileOut;
  const T* hb = h + b * h_sb;
  const T* zb = z + b * z_sb;

  // acc[r][c] = G_b[i0 + ty + 16 r][o0 + tx + 16 c]
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kRows) {
    for (int e = tid; e < kRows * kTileIn; e += kThreads) {
      const int t = e / kTileIn, c = e % kTileIn;
      const int s = s0 + t, i = i0 + c;
      hs[t][c] = (s < S && i < P_in) ? to_f32(hb[s * h_ss + i]) : 0.f;
    }
    for (int e = tid; e < kRows * kTileOut; e += kThreads) {
      const int t = e / kTileOut, c = e % kTileOut;
      const int s = s0 + t, o = o0 + c;
      zs[t][c] = (s < S && o < P_out) ? to_f32(zb[s * z_ss + o]) : 0.f;
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
  sq = repro::block_sum(sq, red);
  if (tid == 0) {
    const long long n_blocks = static_cast<long long>(gridDim.x) * gridDim.y;
    partial[b * n_blocks + static_cast<long long>(ci) * gridDim.x + co] = sq;
  }
}

constexpr int kStage = 64;          // sequence rows staged per step (bf16)
constexpr int kLd = kTileIn + 8;    // padded shared row, in bf16 elements

// The bf16 body: the same tile of G_b, on the tensor cores.
__global__ void __launch_bounds__(kThreads)
direct_partial_mma(const __nv_bfloat16* __restrict__ h,
                   const __nv_bfloat16* __restrict__ z,
                   float* __restrict__ partial, int S, int P_in, int P_out,
                   long long h_sb, long long h_ss, long long z_sb,
                   long long z_ss, bool h_vec, bool z_vec) {
  __shared__ __align__(16) __nv_bfloat16 hs[kStage][kLd];
  __shared__ __align__(16) __nv_bfloat16 zs[kStage][kLd];
  __shared__ float red[kThreads / 32];

  const int co = blockIdx.x, ci = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64;  // this warp's rows of the tile (P_in)
  const int wn = (warp & 3) * 32;   // and columns (P_out)
  const int i0 = ci * kTileIn, o0 = co * kTileOut;
  const __nv_bfloat16* hb = h + b * h_sb;
  const __nv_bfloat16* zb = z + b * z_sb;
  // ldmatrix addressing: lane l feeds row (l & 7) of matrix (l >> 3)
  const int lr = lane & 7, lj = lane >> 3;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kStage) {
    for (int q = tid; q < kStage * (kTileIn / 8); q += kThreads) {
      const int r = q / (kTileIn / 8), c = (q % (kTileIn / 8)) * 8;
      const int s = s0 + r;
      if (s < S) {
        repro::stage8_bf16(hb + s * h_ss, i0 + c, P_in, h_vec, &hs[r][c]);
        repro::stage8_bf16(zb + s * z_ss, o0 + c, P_out, z_vec, &zs[r][c]);
      } else {
        *reinterpret_cast<uint4*>(&hs[r][c]) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(&zs[r][c]) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStage; kk += 16) {
      // A = H^T (rows i, depth s): matrix j covers i + (j & 1) * 8 and
      // s + (j >> 1) * 8; stored as hs[s][i], hence the transpose
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        repro::ldmatrix_x4_trans(
            a[mi], &hs[kk + lr + (lj >> 1) * 8][wm + mi * 16 + (lj & 1) * 8]);
      // B = Zbar (depth s, columns o): matrix j covers s + (j & 1) * 8 and
      // o + (j >> 1) * 8, i.e. both halves of two 8-wide column blocks
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
      for (int e = 0; e < 4; ++e) sq = fmaf(acc[mi][ni][e], acc[mi][ni][e], sq);
  sq = repro::block_sum(sq, red);
  if (tid == 0) {
    const long long n_blocks = static_cast<long long>(gridDim.x) * gridDim.y;
    partial[b * n_blocks + static_cast<long long>(ci) * gridDim.x + co] = sq;
  }
}

// 16-byte loads need an aligned base and row strides in whole 8-element
// steps; otherwise the staging falls back to element loads.
bool vec_ok(const void* p, long long sb, long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0;
}

template <typename T>
int launch(const void* h, const void* z, float* partial, float* out, int B,
           int S, int P_in, int P_out, long long h_sb, long long h_ss,
           long long z_sb, long long z_ss, cudaStream_t stream) {
  const int n_ci = (P_in + kTileIn - 1) / kTileIn;
  const int n_co = (P_out + kTileOut - 1) / kTileOut;
  dim3 grid(n_co, n_ci, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    direct_partial_mma<<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), partial, S, P_in,
        P_out, h_sb, h_ss, z_sb, z_ss, vec_ok(h, h_sb, h_ss),
        vec_ok(z, z_sb, z_ss));
  } else {
    direct_partial<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(h), static_cast<const T*>(z), partial, S, P_in,
        P_out, h_sb, h_ss, z_sb, z_ss);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::reduce_partials<<<B, repro::kReduceThreads, 0, stream>>>(
      partial, out, n_ci * n_co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of per-block partials per example: the wrapper allocates a
// (B, n) f32 scratch buffer of this width.
extern "C" int direct_norm_blocks(int P_in, int P_out) {
  return ((P_in + kTileIn - 1) / kTileIn) * ((P_out + kTileOut - 1) / kTileOut);
}

// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int direct_norm_launch(const void* h, const void* z, void* partial,
                                  void* out, int dtype, int B, int S, int P_in,
                                  int P_out, long long h_sb, long long h_ss,
                                  long long z_sb, long long z_ss,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32)
    return launch<float>(h, z, part, o, B, S, P_in, P_out, h_sb, h_ss, z_sb,
                         z_ss, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(h, z, part, o, B, S, P_in, P_out, h_sb, h_ss,
                                 z_sb, z_ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
