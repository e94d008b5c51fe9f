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
// What bounds it on the H100: at llama3.2-1b's shapes (B=8, S=512) bytes,
// barely: per example the triangle is ~S^2 (P_in + P_out) / 2
// multiply-adds against S (P_in + P_out) input elements, S flops per bf16
// element or S/2 per byte: 256 at S=512 against the card's ~295 flops/byte
// balance. So the kernel has to keep the tensor cores fed from L2 as well
// as move every input byte from device memory about once.
//
// bf16 design (gram_partial_wgmma, gram_fold). A pair of 128-row sequence
// tiles (ti, tj) is the unit: its Gram tile X_ti X_tj^T (128 x 128) is the
// sum over the feature axis of 64-feature chunks. The Python launcher
// (kernels/gram_norm.py: plan) cuts each tensor's feature axis into ranges of
// chunks and passes a table with one row per block: (example, pair, segment,
// tensor, first chunk, end chunk); segments 0 .. n_h - 1 are ranges of h,
// n_h .. n_h + n_z - 1 ranges of zbar. The rows run the pairs of one
// (example, tensor, range) back to back, so the n_s tiles of rows they share
// are read from device memory once and from L2 after that, and the split
// fills the card where B x pairs alone would not (80 pairs at B=8, S=512
// against 132 SMs; at the LM head one pair's zbar range is 128k features).
// A block is two consumer warpgroups and a producer warp. The producer
// brings each chunk of the two row tiles (one, on the diagonal) into a ring
// of kStages stages of 128-byte-swizzled shared memory by TMA, completing on
// the stage's `full` mbarrier; each consumer warpgroup takes 64 of tile ti's
// rows against all 128 of tile tj's with wgmma m64n128k16 (both operands
// K-major from shared memory), accumulating the chunk range in f32
// registers, and releases a stage through its `empty` mbarrier once the
// products that read it have landed. The block then writes its partial Gram
// tile (64 KB f32, in the accumulator's register order) to a scratch buffer
// the wrapper allocates. gram_fold sums each pair's n_h partials of the
// H-Gram and its n_z of the Z-Gram in segment order (the fold is not linear
// in them), folds sum(G_H .* G_Z) in slabs of the tile, and weights the pair
// (2 off the diagonal of the triangle, 1 on it and on the full grid); a
// third launch sums each example's slab partials in a fixed order. No
// atomics: the result is the same bit for bit on every run. The tensor-core
// accumulation chain of a block is one chunk range (at most 128 chunks,
// 8,192 features), and the ranges are summed in f32 by gram_fold: the two
// levels that keep digits over the LM head's 130k features.
// Ragged S and feature edges read as zero: TMA's out-of-bounds fill, or the
// masks of the staged route, which takes rows whose base or strides are no
// multiple of 16 bytes (no tensor map describes them): the producer warp
// stages each chunk by loads and stores into the same layout. The launcher
// decides the route (kernels/_build.copy_route) and passes it in.
//
// f32 inputs run on the FMA pipes: one block per (example, pair of 64-row
// tiles) builds both 64 x 64 Gram tiles in registers (4 x 4 entries per
// thread, exact f32 products), chunked over each feature axis, and folds
// them in place; a second launch sums each example's partials.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;

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


// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma, split feature ranges, fold
// ---------------------------------------------------------------------------

constexpr int kRowsB = 128;       // sequence rows of a tile
constexpr int kChunkB = 64;       // features of a chunk: one swizzled row
constexpr int kStages = 3;        // the ring of chunks
constexpr int kConsumers = 256;   // two consumer warpgroups
constexpr int kThreadsB = kConsumers + 32;  // and the producer warp
constexpr int kTileElems = kRowsB * kChunkB;         // bf16 of a tile chunk
constexpr int kGramElems = kRowsB * kRowsB;          // f32 of a Gram tile
constexpr int kWorkCols = 6;      // (b, pair, segment, tensor, c0, c1)
constexpr int kPairCols = 3;      // (ti, tj, weight)
constexpr int kFoldThreads = 256;

using ChunkTile = Tile<kChunkB, kRowsB>;

struct GramParams {
  CUtensorMap tm_h, tm_z;  // with `tma`: (P, S, B), boxes of 64 x 128 x 1
  const bf16* h;
  const bf16* z;
  long long h_sb, h_ss, z_sb, z_ss;
  int S, P_in, P_out;
  const int* work;   // one row of kWorkCols per block
  const int* pairs;  // n_pairs rows of kPairCols
  int n_pairs, n_seg;
  float* grams;      // (B, n_pairs, n_seg, kGramElems) f32
  bool tma;          // the copy route the launcher chose
};

constexpr size_t gram_smem_bytes() {
  // 1024 bytes of slack to align the tiles (smem_base), the ring, and a
  // `full` and an `empty` barrier per stage
  return 1024 + kStages * 2 * kTileElems * sizeof(bf16) +
         2 * kStages * sizeof(uint64_t);
}

__global__ void __launch_bounds__(kThreadsB, 2)
    gram_partial_wgmma(const __grid_constant__ GramParams p) {
  bf16* ring = reinterpret_cast<bf16*>(smem_base());  // stages x {ti, tj}
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * kTileElems);
  uint64_t* empty = full + kStages;

  const int* w = p.work + static_cast<long long>(blockIdx.x) * kWorkCols;
  const int b = w[0], pair = w[1], seg = w[2], tensor = w[3], c0 = w[4];
  const int n = w[5] - c0;  // chunks of this block's range
  const int ti = p.pairs[pair * kPairCols], tj = p.pairs[pair * kPairCols + 1];
  const bool diag = ti == tj;  // one row tile read as both operands
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i]);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer warp: chunk k into stage k % kStages once the products
    // on chunk k - kStages have landed
    const CUtensorMap* tm = tensor ? &p.tm_z : &p.tm_h;
    const bf16* x = tensor ? p.z + b * p.z_sb : p.h + b * p.h_sb;
    const long long ss = tensor ? p.z_ss : p.h_ss;
    const int P = tensor ? p.P_out : p.P_in;
    const uint32_t bytes = (diag ? 1 : 2) * kTileElems * sizeof(bf16);
    for (int k = 0; k < n; ++k) {
      const int st = k % kStages;
      if (k >= kStages) mbar_wait(&empty[st], (k / kStages - 1) & 1);
      bf16* ti_tile = ring + st * 2 * kTileElems;
      bf16* tj_tile = ti_tile + kTileElems;
      const int f0 = (c0 + k) * kChunkB;
      if (p.tma) {
        if (lane == 0) {
          mbar_expect(&full[st], bytes);
          tma_load_3d(ti_tile, tm, &full[st], f0, ti * kRowsB, b);
          if (!diag) tma_load_3d(tj_tile, tm, &full[st], f0, tj * kRowsB, b);
        }
      } else {
        stage_tile<kChunkB, kRowsB>(ti_tile, x, ss, p.S, P, ti * kRowsB, f0,
                                    lane);
        if (!diag)
          stage_tile<kChunkB, kRowsB>(tj_tile, x, ss, p.S, P, tj * kRowsB,
                                      f0, lane);
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of tile ti against all
  // of tile tj
  const int wg = warp >> 2;
  float acc[kRowsB / 2];
#pragma unroll
  for (int i = 0; i < kRowsB / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < n; ++k) {
    const int st = k % kStages;
    mbar_wait(&full[st], (k / kStages) & 1);
    const bf16* a = ring + st * 2 * kTileElems;
    const bf16* bt = diag ? a : a + kTileElems;
    const bf16* aw = a + ChunkTile::row(64 * wg);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kChunkB / 16; ++kc)
      wgmma_ss<kRowsB>(acc, ChunkTile::desc_k(aw, kc),
                       ChunkTile::desc_k(bt, kc), k > 0 || kc > 0);
    wgmma_commit();
    // chunk k - 1's products have landed: its stage may be refilled
    wgmma_wait_n<1>();
    if (k > 0 && lane == 0) mbar_arrive(&empty[(k - 1) % kStages]);
  }
  wgmma_wait();
  pin<kRowsB / 2>(acc);

  // the partial Gram tile in register order: 16 float4 per thread, each
  // store 16 bytes a thread over consecutive threads
  float4* g = reinterpret_cast<float4*>(
      p.grams +
      ((static_cast<long long>(b) * p.n_pairs + pair) * p.n_seg + seg) *
          kGramElems);
#pragma unroll
  for (int q = 0; q < kRowsB / 8; ++q)
    g[q * kConsumers + threadIdx.x] =
        make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// One block per (slab, pair, example): G_H = the pair's n_h partial H-Grams
// summed in segment order, G_Z its n_z partial Z-Grams, and the slab's share
// of weight * sum(G_H .* G_Z) into partial[b][pair * slabs + slab]. All
// partial tiles share one register order, so the fold is elementwise.
__global__ void __launch_bounds__(kFoldThreads)
    gram_fold(const float* __restrict__ grams, const int* __restrict__ pairs,
              float* __restrict__ partial, int n_pairs, int n_h, int n_seg,
              int slabs) {
  __shared__ float red[kFoldThreads / 32];
  const int slab = blockIdx.x, pair = blockIdx.y, b = blockIdx.z;
  const float4* base = reinterpret_cast<const float4*>(
      grams + (static_cast<long long>(b) * n_pairs + pair) * n_seg *
                  kGramElems);
  constexpr int kVecs = kGramElems / 4;  // float4 of a Gram tile
  const int per = kVecs / slabs;
  float v = 0.f;
  for (int e = slab * per + threadIdx.x; e < (slab + 1) * per;
       e += kFoldThreads) {
    float4 gh = base[e], gz = base[n_h * kVecs + e];
    for (int s = 1; s < n_h; ++s) {
      const float4 t = base[s * kVecs + e];
      gh.x += t.x; gh.y += t.y; gh.z += t.z; gh.w += t.w;
    }
    for (int s = n_h + 1; s < n_seg; ++s) {
      const float4 t = base[s * kVecs + e];
      gz.x += t.x; gz.y += t.y; gz.z += t.z; gz.w += t.w;
    }
    v = fmaf(gh.x, gz.x, v);
    v = fmaf(gh.y, gz.y, v);
    v = fmaf(gh.z, gz.z, v);
    v = fmaf(gh.w, gz.w, v);
  }
  v = repro::block_sum(v, red);
  if (threadIdx.x == 0)
    partial[(static_cast<long long>(b) * n_pairs + pair) * slabs + slab] =
        static_cast<float>(pairs[pair * kPairCols + 2]) * v;
}

// The TMA map of one (B, S, P) bf16 input with P contiguous: dims (P, S, B),
// boxes of one chunk x one tile of rows, 128-byte swizzled.
cudaError_t encode_chunks(CUtensorMap* tm, const void* base, int B, int S,
                          int P, long long sb, long long ss) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[3] = {kChunkB, kRowsB, 1};
  return encode_tiled(tm, 3, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

int launch_bf16(GramParams& p, float* partial, float* out, int B, int n_work,
                int n_h, int slabs, cudaStream_t stream) {
  if (p.work == nullptr || n_work <= 0 || p.n_pairs <= 0 || n_h <= 0 ||
      n_h >= p.n_seg || p.grams == nullptr || slabs <= 0 ||
      (kGramElems / 4) % slabs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.tma) {
    cudaError_t err =
        encode_chunks(&p.tm_h, p.h, B, p.S, p.P_in, p.h_sb, p.h_ss);
    if (err == cudaSuccess)
      err = encode_chunks(&p.tm_z, p.z, B, p.S, p.P_out, p.z_sb, p.z_ss);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const void* fn = reinterpret_cast<const void*>(gram_partial_wgmma);
  cudaError_t err = allow_smem(fn, gram_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_partial_wgmma<<<n_work, kThreadsB, gram_smem_bytes(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_fold<<<dim3(slabs, p.n_pairs, B), kFoldThreads, 0, stream>>>(
      p.grams, p.pairs, partial, p.n_pairs, n_h, p.n_seg, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::reduce_partials<<<B, repro::kReduceThreads, 0, stream>>>(
      partial, out, p.n_pairs * slabs);
  return static_cast<int>(cudaGetLastError());
}

int n_tiles(int S) { return (S + kTile - 1) / kTile; }

int n_pairs(int S, int triangular) {
  const int n = n_tiles(S);
  return triangular ? n * (n + 1) / 2 : n * n;
}

int launch_f32(const void* h, const void* z, float* partial, float* out, int B,
               int S, int P_in, int P_out, long long h_sb, long long h_ss,
               long long z_sb, long long z_ss, int triangular,
               cudaStream_t stream) {
  const int pairs = n_pairs(S, triangular);
  gram_partial<float><<<dim3(pairs, B), kThreads, 0, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(z), partial, S,
      P_in, P_out, h_sb, h_ss, z_sb, z_ss, n_tiles(S), triangular);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  repro::reduce_partials<<<B, repro::kReduceThreads, 0, stream>>>(partial, out,
                                                                  pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32: the number of per-block partials per example (the 64-row tile pairs
// the grid visits); the wrapper allocates a (B, n) f32 scratch buffer of
// this width.
extern "C" int gram_norm_blocks(int S, int triangular) {
  return n_pairs(S, triangular);
}

// f32 (dtype 0): grams, plan and tma unused (null, 0), n_pairs =
// gram_norm_blocks(S, triangular), partial (B, n_pairs).
// bf16 (dtype 1): the launcher's plan (kernels/gram_norm.py), in device
// memory: n_work rows of (b, pair, segment, tensor, first chunk, end chunk),
// one a block, then n_pairs rows of (ti, tj, weight); segments 0 .. n_h - 1
// of each pair hold h's ranges and n_h .. n_h + n_z - 1 zbar's; grams
// (B, n_pairs, n_h + n_z, 128 x 128) f32 and partial (B, n_pairs * slabs) f32
// scratch; tma 1 brings the chunks by TMA, 0 stages them; triangular is
// already in the pair table.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int gram_norm_launch(const void* h, const void* z, void* grams,
                                void* partial, void* out, int dtype, int B,
                                int S, int P_in, int P_out, long long h_sb,
                                long long h_ss, long long z_sb, long long z_ss,
                                int triangular, int tma, const int* plan,
                                int n_work, int n_pairs_arg, int n_h, int n_z,
                                int slabs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32) {
    if (tma || plan != nullptr || n_pairs_arg != n_pairs(S, triangular))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_f32(h, z, part, o, B, S, P_in, P_out, h_sb, h_ss, z_sb,
                      z_ss, triangular, st);
  }
  if (dtype != repro::kBFloat16)
    return static_cast<int>(cudaErrorInvalidValue);
  GramParams p = {};
  p.h = static_cast<const bf16*>(h);
  p.z = static_cast<const bf16*>(z);
  p.h_sb = h_sb;
  p.h_ss = h_ss;
  p.z_sb = z_sb;
  p.z_ss = z_ss;
  p.S = S;
  p.P_in = P_in;
  p.P_out = P_out;
  p.work = plan;
  p.pairs = plan == nullptr ? nullptr : plan + n_work * kWorkCols;
  p.n_pairs = n_pairs_arg;
  p.n_seg = n_h + n_z;
  p.grams = static_cast<float*>(grams);
  p.tma = tma != 0;
  return launch_bf16(p, part, o, B, n_work, n_h, slabs, st);
}

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the bf16 body.
extern "C" int gram_norm_kernel_info(int* out) {
  const void* f = reinterpret_cast<const void*>(gram_partial_wgmma);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err == cudaSuccess) err = allow_smem(f, gram_smem_bytes());
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, f, kThreadsB, gram_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(gram_smem_bytes());
  out[3] = kThreadsB;
  out[4] = blocks;
  return 0;
}
