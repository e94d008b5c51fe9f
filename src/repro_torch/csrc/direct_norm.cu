// Per-example direct norm: s_b = || H_b^T Zbar_b ||_F^2.
//
// Replaces the TPU kernel src/repro/kernels/direct_norm.py::direct_norm
// (pallas_call at :141, body _kernel at :86; wrapper kernels/ops.py:100).
//
// h (B, S, P_in) and zbar (B, S, P_out), both f32 or both bf16, with the
// feature axis contiguous (strides of the batch and sequence axes are
// arguments); out (B,) f32.
//
// What bounds it on the H100: the function is bound by bytes wherever the
// gram form is the cheaper one (the LM head: 1.07 GB of bf16 input, 0.319
// ms at 3.35 TB/s), but the direct form itself does 2 S P_in P_out flops per
// example: 2.15e12 at the head at B=8, S=512, 2.18 ms at 989 TFLOP/s. So this
// kernel is a GEMM with a square-and-sum epilogue, bound by the tensor cores
// if it is fed, and by L2 if its tiles are small. The per-example gradient
// G_b = H_b^T Zbar_b (8.4 GB in f32 at the head) must never reach device
// memory.
//
// bf16 design (direct_partial_wgmma): one block per (128 columns of P_in,
// 256 of P_out, example), launched P_in tile fastest, so the 16 blocks that
// read one zbar panel at P_in = 2048 run back to back and zbar crosses
// device memory about once (at the head it is 21x the L2). Two consumer
// warpgroups take 64 rows of the 128 x 256 tile of G_b each (wgmma
// m64n256k16, 128 f32 accumulators a thread, both operands MN-major from
// shared memory: A = H^T is h's rows read transposed, B = zbar's rows) and a
// producer warp walks the sequence in 64-row stages through a ring of
// kStages 128-byte-swizzled stages filled by TMA with mbarrier completion;
// a consumer releases a stage through its `empty` mbarrier once the products
// that read it have landed. That is 85 flops per byte moved from L2, against
// 64 for a 128 x 128 tile. At the end of the sweep each thread squares and
// sums its accumulators; the block's sum is one f32 partial, and a second
// launch sums each example's partials in a fixed order: no atomics, the same
// result bit for bit on every run. Ragged S, P_in and P_out edges read as
// zero (TMA's out-of-bounds fill, or the masks of the staged route: the
// producer warp stages rows whose base or strides are no multiple of 16
// bytes by loads and stores into the same layout). The launcher decides the
// route (kernels/_build.copy_route) and the tile counts, and passes them in.
//
// f32 inputs run on the FMA pipes: one block per (example, 128 P_in
// columns, 128 P_out columns) sweeps the sequence in 16-row steps staged in
// shared memory, 8 x 8 elements of G per thread (exact f32 products).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;

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


// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma m64n256k16, square-and-sum epilogue
// ---------------------------------------------------------------------------

constexpr int kInB = 128;         // P_in columns of G per block (M)
constexpr int kOutB = 256;        // P_out columns of G per block (N)
constexpr int kRowsB = 64;        // sequence rows of a stage (the depth)
constexpr int kStages = 4;
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreadsB = kConsumers + 32;  // and the producer warp
constexpr int kHElems = kRowsB * kInB;      // bf16 of a stage's h rows
constexpr int kZElems = kRowsB * kOutB;     // and of its zbar rows

using HTile = Tile<kInB, kRowsB>;
using ZTile = Tile<kOutB, kRowsB>;

struct DirectParams {
  CUtensorMap tm_h, tm_z;  // with `tma`: (P, S, B), boxes of 64 x 64 x 1
  const bf16* h;
  const bf16* z;
  long long h_sb, h_ss, z_sb, z_ss;
  int S, P_in, P_out;
  float* partial;    // (B, gridDim.y * gridDim.x) f32
  bool tma;          // the copy route the launcher chose
};

constexpr size_t direct_smem_bytes() {
  // 1024 bytes of slack to align the tiles (smem_base), the ring, and a
  // `full` and an `empty` barrier per stage
  return 1024 + kStages * (kHElems + kZElems) * sizeof(bf16) +
         2 * kStages * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreadsB, 1)
    direct_partial_wgmma(const __grid_constant__ DirectParams p) {
  __shared__ float red[kThreadsB / 32];
  bf16* ring = reinterpret_cast<bf16*>(smem_base());  // stages x {h, zbar}
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kStages * (kHElems + kZElems));
  uint64_t* empty = full + kStages;

  const int ci = blockIdx.x, co = blockIdx.y, b = blockIdx.z;
  const int i0 = ci * kInB, o0 = co * kOutB;
  const int n = (p.S + kRowsB - 1) / kRowsB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float sq = 0.f;
  if (warp == kConsumers / 32) {
    // the producer warp: rows [64 k, 64 k + 64) into stage k % kStages once
    // the products on stage k - kStages have landed
    const bf16* hb = p.h + b * p.h_sb;
    const bf16* zb = p.z + b * p.z_sb;
    for (int k = 0; k < n; ++k) {
      const int st = k % kStages;
      if (k >= kStages) mbar_wait(&empty[st], (k / kStages - 1) & 1);
      bf16* hs = ring + st * (kHElems + kZElems);
      bf16* zs = hs + kHElems;
      if (p.tma) {
        if (lane == 0) {
          mbar_expect(&full[st], (kHElems + kZElems) * sizeof(bf16));
#pragma unroll
          for (int u = 0; u < kInB / 64; ++u)
            tma_load_3d(hs + u * kRowsB * 64, &p.tm_h, &full[st], i0 + 64 * u,
                        k * kRowsB, b);
#pragma unroll
          for (int u = 0; u < kOutB / 64; ++u)
            tma_load_3d(zs + u * kRowsB * 64, &p.tm_z, &full[st], o0 + 64 * u,
                        k * kRowsB, b);
        }
      } else {
        stage_tile<kInB, kRowsB>(hs, hb, p.h_ss, p.S, p.P_in, k * kRowsB, i0,
                                 lane);
        stage_tile<kOutB, kRowsB>(zs, zb, p.z_ss, p.S, p.P_out, k * kRowsB,
                                  o0, lane);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
  } else {
    // consumer warpgroup wg: columns 64 wg .. 64 wg + 63 of the h tile (rows
    // of G) against all 256 zbar columns
    const int wg = warp >> 2;
    float acc[kOutB / 2];
#pragma unroll
    for (int i = 0; i < kOutB / 2; ++i) acc[i] = 0.f;
    for (int k = 0; k < n; ++k) {
      const int st = k % kStages;
      mbar_wait(&full[st], (k / kStages) & 1);
      const bf16* hs = ring + st * (kHElems + kZElems);
      const bf16* zs = hs + kHElems;
      const bf16* hw = hs + wg * kRowsB * 64;  // the warpgroup's sub-tile
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kRowsB / 16; ++kc)
        wgmma_ss_tt<kOutB>(acc, HTile::desc_mn(hw, kc),
                           ZTile::desc_mn(zs, kc), k > 0 || kc > 0);
      wgmma_commit();
      // stage k - 1's products have landed: it may be refilled
      wgmma_wait_n<1>();
      if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % kStages]);
    }
    wgmma_wait();
    pin<kOutB / 2>(acc);
#pragma unroll
    for (int i = 0; i < kOutB / 2; ++i) sq = fmaf(acc[i], acc[i], sq);
  }
  sq = repro::block_sum(sq, red);
  if (threadIdx.x == 0) {
    const long long n_blocks = static_cast<long long>(gridDim.x) * gridDim.y;
    p.partial[b * n_blocks + static_cast<long long>(co) * gridDim.x + ci] = sq;
  }
}

// The TMA map of one (B, S, P) bf16 input with P contiguous: dims (P, S, B),
// boxes of 64 columns x one stage of rows, 128-byte swizzled.
cudaError_t encode_stages(CUtensorMap* tm, const void* base, int B, int S,
                          int P, long long sb, long long ss) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {64, kRowsB, 1};
  return encode_tiled(tm, 3, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

int n_in(int P_in, bool bf) {
  const int t = bf ? kInB : kTileIn;
  return (P_in + t - 1) / t;
}

int n_out(int P_out, bool bf) {
  const int t = bf ? kOutB : kTileOut;
  return (P_out + t - 1) / t;
}

}  // namespace

// Number of per-block partials per example for dtype (0 f32, 1 bf16): the
// wrapper allocates a (B, n) f32 scratch buffer of this width.
extern "C" int direct_norm_blocks(int P_in, int P_out, int dtype) {
  const bool bf = dtype == repro::kBFloat16;
  return n_in(P_in, bf) * n_out(P_out, bf);
}

// partial (B, n_blocks) f32 scratch, n_blocks = direct_norm_blocks(P_in,
// P_out, dtype); for bf16, tma 1 brings the stages by TMA and 0 stages them
// (f32 has no route: tma 0). Returns cudaGetLastError() after the launches
// (0 on success).
extern "C" int direct_norm_launch(const void* h, const void* z, void* partial,
                                  void* out, int dtype, int B, int S, int P_in,
                                  int P_out, long long h_sb, long long h_ss,
                                  long long z_sb, long long z_ss, int tma,
                                  int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype != repro::kFloat32 && dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == repro::kBFloat16;
  if (n_blocks != direct_norm_blocks(P_in, P_out, dtype) || (tma && !bf))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_in(P_in, bf), n_out(P_out, bf), B);  // P_in tile fastest
  cudaError_t err;
  if (bf) {
    DirectParams p = {};
    p.h = static_cast<const bf16*>(h);
    p.z = static_cast<const bf16*>(z);
    p.h_sb = h_sb;
    p.h_ss = h_ss;
    p.z_sb = z_sb;
    p.z_ss = z_ss;
    p.S = S;
    p.P_in = P_in;
    p.P_out = P_out;
    p.partial = part;
    p.tma = tma != 0;
    err = cudaSuccess;
    if (p.tma) {
      err = encode_stages(&p.tm_h, h, B, S, P_in, h_sb, h_ss);
      if (err == cudaSuccess)
        err = encode_stages(&p.tm_z, z, B, S, P_out, z_sb, z_ss);
    }
    const void* fn = reinterpret_cast<const void*>(direct_partial_wgmma);
    if (err == cudaSuccess) err = allow_smem(fn, direct_smem_bytes());
    if (err != cudaSuccess) return static_cast<int>(err);
    direct_partial_wgmma<<<grid, kThreadsB, direct_smem_bytes(), st>>>(p);
  } else {
    direct_partial<float><<<dim3(grid.y, grid.x, B), kThreads, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(z), part, S,
        P_in, P_out, h_sb, h_ss, z_sb, z_ss);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::reduce_partials<<<B, repro::kReduceThreads, 0, st>>>(part, o,
                                                              n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the bf16 body.
extern "C" int direct_norm_kernel_info(int* out) {
  const void* f = reinterpret_cast<const void*>(direct_partial_wgmma);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err == cudaSuccess) err = allow_smem(f, direct_smem_bytes());
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, f, kThreadsB, direct_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(direct_smem_bytes());
  out[3] = kThreadsB;
  out[4] = blocks;
  return 0;
}
