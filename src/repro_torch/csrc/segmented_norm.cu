// Per-segment norm over rows grouped by segment:
//   out[j] = || sum_{r in segment j} h_r zbar_r^T ||_F^2
//          = sum_{r, r' in segment j} <h_r, h_r'> <zbar_r, zbar_r'>.
//
// Replaces the TPU kernel
// src/repro/kernels/segmented_norm.py::segmented_norm_sorted (pallas_call
// at :204, body _kernel at :123; wrapper kernels/ops.py:177).
//
// h (T, P_in) and zbar (T, P_out), both f32 or both bf16, with the feature
// axis contiguous and any row stride; rows (T,) int32, the rows in segment
// order (the launcher's stable argsort of the segment keys); offsets
// (n_seg + 1,) int32: segment j owns sorted positions
// [offsets[j], offsets[j + 1]). Rows of the drop bucket (capacity padding)
// sort after offsets[n_seg] and are never read. out (n_seg,) f32.
//
// What bounds the function on the H100: bytes. A segment of n rows costs
// 2 n P_in P_out operations in the direct form (G_j = H_j^T Zbar_j, then
// its square-and-sum) and 2 n^2 (P_in + P_out + 1) in the gram form (the
// two n x n Grams, then their elementwise product). The MoE path's segments
// (group, expert, example) hold ~28 kept rows each, at most a capacity
// slice of 88, so the gram form is ~57x less arithmetic there and the
// function needs little more than one read of the kept rows (0.088 ms a
// launch at 4096 -> 6400). The direct form does ~2,500 flops per input
// byte there, far above the card's ~295 flops/byte balance point: no
// tuning of it comes near the bytes' time. What must never reach device
// memory is a segment's gradient G_j (n_seg * P_in * P_out f32).
//
// The plan (kernels/segmented_norm.py: plan) is the launcher's, built on
// the device from the sort's offsets without a host sync. It routes each
// non-empty segment to the form with the fewer operations (the gram form
// counted over 64-row tile pairs, kernels.ops.flop_estimate's rule), cuts
// each gram-route segment's sorted rows into 64-row tiles and lists one
// work item per (segment, tile pair ti <= tj) with its weight (2 off the
// diagonal, 1 on it), and lists the direct-route segments. The kernels
// read the lengths of both lists from device memory, so the host never
// learns them: the gram kernel runs a persistent grid (a few blocks per
// SM, sized by the launcher) that walks the items with a stride of the
// grid, and the direct kernel's blocks walk the direct list. The launcher
// sizes its scratch from static bounds (T, n_seg and the widths give the
// most items and the most direct segments a launch can have) and skips a
// route that no segment of T rows can take.
//
// bf16 gram body (segmented_gram_wgmma): one warpgroup a block. A work
// item computes G_H = X_ti X_tj^T over P_in and G_Z = Zbar_ti Zbar_tj^T
// over P_out, each 64 x 64 f32 on wgmma m64n64k16 with both operands
// K-major from 128-byte-swizzled shared memory, over 64-feature chunks; a
// diagonal pair loads its tile once. G_H and G_Z of one warpgroup have the
// same fragment layout, so the fold sum(G_H .* G_Z) is an elementwise
// product of the two accumulators (32 f32 a thread each), then a block
// sum: no partial Gram leaves the registers. Each Gram is summed in chains
// of kChain chunks, each chain's sum added in f32: the tensor cores'
// accumulator loses precision with a chain's length, so one chain over the
// whole of P_in or P_out would have an error that grows with the width.
// G_H is the sum of its chains; each chain of G_Z is folded against G_H as
// it completes (the fold is linear in G_Z), so the chains cost no
// registers beyond the two accumulators. Rows come through the sort's
// permutation, which no tensor map describes (and TMA has no gather): each
// thread copies its 16-byte pieces of 4 rows of each tile with cp.async,
// straight to their swizzled addresses, zero-filled past a segment's end
// or past P (the src-size operand). A ring of kSlots tile slots keeps the
// copies kSlots - 1 chunks ahead of the products on a diagonal pair (one
// tile a chunk) and kSlots / 2 - 1 on another pair (two): each block runs
// one item's chunks in order, so how far its copies run ahead sets its
// rate. The chunk loop waits for each chunk's products before the barrier
// of the next, so a stage is refilled only when every warp is done with
// it. Rows whose base or
// stride is no multiple of 16 bytes take the synchronous route: the same
// pieces by loads and stores. The launcher picks the route. No sorted copy
// of h or zbar is made. Why 64-row tiles of one segment and not 128-row
// tiles packed across segments: a 128-row tile would span ~4-5 of the
// path's segments, doing ~4x the useful products and needing a segment mask
// in the fold; 64 rows is wgmma's least M, and at ~28 rows a segment the
// padding costs ~45 GFLOP a launch, ~0.05 ms at the card's peak, against a
// bound of bytes.
//
// f32 gram body (segmented_gram): the same items on the FMA pipes, 4 x 4
// entries of both 64 x 64 Grams per thread (exact f32 products), features
// staged 32 at a time through the row ids of the item's two tiles.
//
// Direct route (segmented_partial_mma for bf16, segmented_partial for f32):
// the direct form G_j = H_j^T Zbar_j for the segments of the direct list.
// The grid is (P_out tiles, P_in tiles, depth): the depth's blocks of one
// 128 x 128 tile of G stride the list (block z takes entries z, z + depth,
// ...), each staging a segment's rows through the permutation into shared
// memory and accumulating its tile of G_j in f32 registers (bf16: 8 warps,
// each a 64 x 32 piece as 4 x 4 mma.sync m16n8k16 fragments; f32: 8 x 8
// entries a thread on the FMA pipes), then squaring and summing the tile
// into the (entry, tile) partial. The launcher sizes the depth from the
// list's static bound and the SM count, so rank-thin widths, whose G has
// one or a few tiles (the LoRA tenants' 256 -> 8: 2 tiles), still fill the
// card. Each partial has one writer whatever the depth: the same bits.
//
// Output. Each gram item writes one f32 partial (weight * its fold) and
// each direct block one partial per listed segment; segment_sums sums each
// segment's item partials in item order, or its direct partials in tile
// order: no atomics, so the result is the same bit for bit on every run.
// An empty segment reads 0.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;

using repro::to_f32;

// ---------------------------------------------------------------------------
// the plan, as the launcher lays it out
// ---------------------------------------------------------------------------

constexpr int kItemCols = 4;  // one gram item: (segment, ti, tj, weight)
constexpr int kEndRows = 3;   // ends (3, n_seg): inclusive running counts of
                              // gram items, gram segments, direct segments
constexpr int kSegRows = 64;  // rows of a gram tile: wgmma's m64

// Items of segment j: [ends[0][j - 1], ends[0][j]); its direct slot, if it
// takes the direct route: ends[2][j] - 1 (then ends[2][j] > ends[2][j - 1]).
__device__ __forceinline__ int end_before(const int* row, int j) {
  return j > 0 ? row[j - 1] : 0;
}

// ---------------------------------------------------------------------------
// direct route
// ---------------------------------------------------------------------------

constexpr int kTile = 128;     // P_in and P_out columns of G per block
constexpr int kRows = 16;      // rows staged per step (f32)
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 elements of G each

// The f32 body: each listed segment's tile of G_j, squared and summed into
// partial[slot, tile].
template <typename T>
__global__ void __launch_bounds__(kThreads)
segmented_partial(const T* __restrict__ h, const T* __restrict__ z,
                  const int* __restrict__ rows,
                  const int* __restrict__ offsets,
                  const int* __restrict__ dlist,
                  const int* __restrict__ ends, float* __restrict__ partial,
                  int n_seg, int P_in, int P_out, long long h_ss,
                  long long z_ss) {
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
  const int n_direct = ends[kEndRows * n_seg - 1];

  for (int q = blockIdx.z; q < n_direct; q += gridDim.z) {
    const int j = dlist[q];
    const int r0 = offsets[j];
    const int r1 = offsets[j + 1];
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
    if (tid == 0) partial[q * n_tiles + tile] = sq;
  }
}

constexpr int kStage = 32;       // rows staged per step (bf16)
constexpr int kLd = kTile + 8;   // padded shared row, in bf16 elements

// The bf16 body: the same tile of G_j, on the tensor cores. `vec`: the
// launcher's copy route (16-byte loads where the rows allow them).
__global__ void __launch_bounds__(kThreads)
segmented_partial_mma(const bf16* __restrict__ h, const bf16* __restrict__ z,
                      const int* __restrict__ rows,
                      const int* __restrict__ offsets,
                      const int* __restrict__ dlist,
                      const int* __restrict__ ends,
                      float* __restrict__ partial, int n_seg, int P_in,
                      int P_out, long long h_ss, long long z_ss, bool vec) {
  __shared__ __align__(16) bf16 hs[kStage][kLd];
  __shared__ __align__(16) bf16 zs[kStage][kLd];
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
  const int n_direct = ends[kEndRows * n_seg - 1];

  for (int q = blockIdx.z; q < n_direct; q += gridDim.z) {
    const int j = dlist[q];
    const int r0 = offsets[j];
    const int r1 = offsets[j + 1];
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    for (int s0 = r0; s0 < r1; s0 += kStage) {
      for (int c8 = tid; c8 < kStage * (kTile / 8); c8 += kThreads) {
        const int r = c8 / (kTile / 8), c = (c8 % (kTile / 8)) * 8;
        const int s = s0 + r;
        if (s < r1) {
          const long long row = rows[s];
          repro::stage8_bf16(h + row * h_ss, i0 + c, P_in, vec, &hs[r][c]);
          repro::stage8_bf16(z + row * z_ss, o0 + c, P_out, vec, &zs[r][c]);
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
    if (tid == 0) partial[q * n_tiles + tile] = sq;
  }
}

int direct_tiles(int P_in, int P_out) {
  return ((P_in + kTile - 1) / kTile) * ((P_out + kTile - 1) / kTile);
}

// ---------------------------------------------------------------------------
// gram route, bf16: cp.async ring, wgmma, fold in registers
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;         // features of a chunk: one swizzled row
constexpr int kSlots = 6;          // the ring, in tile slots: kSlots chunks
                                   // of a diagonal pair's one tile ahead,
                                   // kSlots / 2 of another pair's two
constexpr int kChain = 4;          // chunks a tensor-core chain sums
                                   // before its sum is added in f32
constexpr int kGramThreads = 128;  // one warpgroup
constexpr int kGramBlocks = 4;     // resident blocks per SM
constexpr int kTileElems = kSegRows * kChunk;  // bf16 of a tile's chunk
constexpr int kPieces = kSegRows * kChunk / 8 / kGramThreads;  // a thread's
                                   // 16-byte pieces of a tile's chunk: 4

using SegTile = Tile<kChunk, kSegRows>;

struct GramParams {
  const bf16* h;
  const bf16* z;
  long long h_ss, z_ss;
  int P_in, P_out;
  const int* rows;     // the sort's order
  const int* offsets;  // (n_seg + 1,)
  const int* items;    // (segment, ti, tj, weight) rows
  const int* ends;     // (kEndRows, n_seg)
  int n_seg;
  float* partial;      // one f32 per item
};

constexpr size_t gram_smem_bytes() {
  // 1024 bytes of slack to align the tiles (smem_base), and the ring
  return 1024 + kSlots * kTileElems * sizeof(bf16);
}

// 16 bytes from global to shared memory; bytes past `src_bytes` are
// written as zeros and not read (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Wait until at most N of this thread's committed cp.async groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's pieces of chunk g of one tile: its rows (row ids, -1 past
// the segment's end) at 16-byte piece `piece` of the chunk's 64 features;
// chunks 0 .. c_h - 1 are h's, the rest zbar's. Zeros past P and past the
// segment. kVec: cp.async (rows 16-byte aligned); else loads and stores.
template <bool kVec>
__device__ __forceinline__ void load_tile(bf16* tile, const GramParams& p,
                                          const int (&row)[kPieces], int g,
                                          int c_h, int piece) {
  const bool in_h = g < c_h;
  const bf16* x = in_h ? p.h : p.z;
  const long long ss = in_h ? p.h_ss : p.z_ss;
  const int P = in_h ? p.P_in : p.P_out;
  const int col = (in_h ? g : g - c_h) * kChunk + piece * 8;
  const int bytes = max(0, min(16, (P - col) * 2));
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int r = (threadIdx.x >> 3) + 16 * i;
    bf16* dst = tile + SegTile::byte(r, piece * 8) / 2;
    const bool valid = row[i] >= 0 && bytes > 0;
    if constexpr (kVec) {
      cp_async16(dst, valid ? x + row[i] * ss + col : x, valid ? bytes : 0);
    } else if (valid) {
      repro::stage8_bf16(x + row[i] * ss, col, P, false, dst);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One work item's chunks, kW tiles each (1: a diagonal pair, whose tile is
// both operands; 2: tiles ti and tj), through a ring of kSlots / kW stages.
template <bool kVec, int kW>
struct GramItem {
  static constexpr int kDepth = kSlots / kW;

  const GramParams& p;
  bf16* ring;
  const int (&ra)[kPieces];
  const int (&rb)[kPieces];
  int n_chunks, c_h, piece;

  __device__ __forceinline__ bf16* stage(int g) const {
    return ring + (g % kDepth) * kW * kTileElems;
  }

  // chunk g into its stage (nothing past the last chunk), then a commit:
  // an empty group keeps the count of groups per chunk
  __device__ __forceinline__ void load(int g) const {
    if (g < n_chunks) {
      load_tile<kVec>(stage(g), p, ra, g, c_h, piece);
      if (kW == 2) load_tile<kVec>(stage(g) + kTileElems, p, rb, g, c_h, piece);
    }
    cp_async_commit();
  }

  // acc = the products of chunks [g0, g1) (64 x 64, this warpgroup's
  // fragment; one chain): each waits for its chunk, refills the stage of
  // the chunk before it, and runs its four k16 products to completion.
  __device__ __forceinline__ void chunks(float (&acc)[32], int g0,
                                         int g1) const {
    for (int g = g0; g < g1; ++g) {
      cp_async_wait_n<kDepth - 2>();  // chunk g's copies (this thread's)
      fence_async_smem();             // ... visible to wgmma
      __syncthreads();  // every thread's copies of chunk g have landed, and
                        // every warp's products on chunk g - 1 are done
      load(g + kDepth - 1);
      const bf16* a = stage(g);
      const bf16* b = kW == 2 ? a + kTileElems : a;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc)
        wgmma_ss<kSegRows>(acc, SegTile::desc_k(a, kc),
                           SegTile::desc_k(b, kc), g > g0 || kc > 0);
      wgmma_commit();
      wgmma_wait();
    }
    pin<32>(acc);
  }

  // This thread's share of sum(G_H .* G_Z): G_H as the f32 sum of its
  // chains, then each chain of G_Z folded against it as it completes
  // (the fold is linear in G_Z, so no third accumulator is needed).
  __device__ __forceinline__ float fold() const {
#pragma unroll
    for (int s = 0; s < kDepth - 1; ++s) load(s);
    float gh[32], acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) gh[i] = 0.f;
    for (int g = 0; g < c_h; g += kChain) {
      chunks(acc, g, min(g + kChain, c_h));
#pragma unroll
      for (int i = 0; i < 32; ++i) gh[i] += acc[i];
    }
    float v = 0.f;
    for (int g = c_h; g < n_chunks; g += kChain) {
      chunks(acc, g, min(g + kChain, n_chunks));
#pragma unroll
      for (int i = 0; i < 32; ++i) v = fmaf(gh[i], acc[i], v);
    }
    return v;
  }
};

// A persistent grid: block b takes items b, b + gridDim.x, ... up to the
// item count the plan left in device memory.
template <bool kVec>
__global__ void __launch_bounds__(kGramThreads, kGramBlocks)
    segmented_gram_wgmma(const __grid_constant__ GramParams p) {
  __shared__ float red[kGramThreads / 32];
  bf16* ring = reinterpret_cast<bf16*>(smem_base());
  const int n_items = p.ends[p.n_seg - 1];
  const int c_h = (p.P_in + kChunk - 1) / kChunk;
  const int n_chunks = c_h + (p.P_out + kChunk - 1) / kChunk;
  const int piece = threadIdx.x & 7;

  for (int k = blockIdx.x; k < n_items; k += gridDim.x) {
    const int* it = p.items + static_cast<long long>(k) * kItemCols;
    const int seg = it[0], ti = it[1], tj = it[2];
    const float weight = static_cast<float>(it[3]);
    const int r0 = p.offsets[seg];
    const int n = p.offsets[seg + 1] - r0;
    int ra[kPieces], rb[kPieces];  // this thread's rows of tiles ti and tj
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int r = (threadIdx.x >> 3) + 16 * i;
      const int sa = ti * kSegRows + r, sb = tj * kSegRows + r;
      ra[i] = sa < n ? p.rows[r0 + sa] : -1;
      rb[i] = sb < n ? p.rows[r0 + sb] : -1;
    }
    // the chunk loop's barriers separate this use of `red` from the
    // previous item's, and every warp's last products from the next item's
    // first copies
    const float v =
        ti == tj
            ? GramItem<kVec, 1>{p, ring, ra, rb, n_chunks, c_h, piece}.fold()
            : GramItem<kVec, 2>{p, ring, ra, rb, n_chunks, c_h, piece}.fold();
    const float sum = repro::block_sum(v, red);
    if (threadIdx.x == 0) p.partial[k] = weight * sum;
  }
}

// ---------------------------------------------------------------------------
// gram route, f32: the same items on the FMA pipes
// ---------------------------------------------------------------------------

constexpr int kChunkF = 32;  // features staged per step

// acc[r][c] += sum_p x[ri[ty + 16 r]][p] * x[rj[tx + 16 c]][p] over the
// whole feature axis; a row id of -1 reads as a row of zeros.
__device__ __forceinline__ void gram_rows_f32(const float* __restrict__ x,
                                              long long ss, int P,
                                              const int* ri, const int* rj,
                                              float (*xi)[kSegRows + 1],
                                              float (*xj)[kSegRows + 1],
                                              float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < P; k0 += kChunkF) {
    for (int e = tid; e < kSegRows * kChunkF; e += kThreads) {
      const int r = e / kChunkF, k = e % kChunkF;
      const int c = k0 + k;
      xi[k][r] = (ri[r] >= 0 && c < P) ? x[ri[r] * ss + c] : 0.f;
      xj[k][r] = (rj[r] >= 0 && c < P) ? x[rj[r] * ss + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunkF; ++k) {
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

__global__ void __launch_bounds__(kThreads)
segmented_gram(const float* __restrict__ h, const float* __restrict__ z,
               const int* __restrict__ rows, const int* __restrict__ offsets,
               const int* __restrict__ items, const int* __restrict__ ends,
               float* __restrict__ partial, int n_seg, int P_in, int P_out,
               long long h_ss, long long z_ss) {
  __shared__ float xi[kChunkF][kSegRows + 1];
  __shared__ float xj[kChunkF][kSegRows + 1];
  __shared__ int ri[kSegRows], rj[kSegRows];
  __shared__ float red[kThreads / 32];
  const int n_items = ends[n_seg - 1];

  for (int k = blockIdx.x; k < n_items; k += gridDim.x) {
    const int* it = items + static_cast<long long>(k) * kItemCols;
    const int seg = it[0], ti = it[1], tj = it[2];
    const float weight = static_cast<float>(it[3]);
    const int r0 = offsets[seg];
    const int n = offsets[seg + 1] - r0;
    // the previous item's last staging barrier is behind every thread's
    // last read of ri and rj
    if (threadIdx.x < kSegRows) {
      const int sa = ti * kSegRows + threadIdx.x;
      const int sb = tj * kSegRows + threadIdx.x;
      ri[threadIdx.x] = sa < n ? rows[r0 + sa] : -1;
      rj[threadIdx.x] = sb < n ? rows[r0 + sb] : -1;
    }
    __syncthreads();
    float gh[4][4], gz[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) gh[r][c] = gz[r][c] = 0.f;
    gram_rows_f32(h, h_ss, P_in, ri, rj, xi, xj, gh);
    gram_rows_f32(z, z_ss, P_out, ri, rj, xi, xj, gz);
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) v = fmaf(gh[r][c], gz[r][c], v);
    // the staging loop's barriers separate this use of `red` from the
    // previous item's
    v = repro::block_sum(v, red);
    if (threadIdx.x == 0) partial[k] = weight * v;
  }
}

// ---------------------------------------------------------------------------
// the sums
// ---------------------------------------------------------------------------

// One block per segment: its item partials in item order, or its direct
// partials in tile order; 0 for an empty segment.
__global__ void __launch_bounds__(repro::kReduceThreads)
    segment_sums(const float* __restrict__ gram_partial,
                 const float* __restrict__ direct_partial,
                 const int* __restrict__ ends, float* __restrict__ out,
                 int n_seg, int n_tiles) {
  __shared__ float red[repro::kReduceThreads / 32];
  const int j = blockIdx.x;
  const int* pair_end = ends;
  const int* direct_end = ends + 2 * n_seg;
  float v = 0.f;
  for (int k = end_before(pair_end, j) + threadIdx.x; k < pair_end[j];
       k += repro::kReduceThreads)
    v += gram_partial[k];
  const int slot = end_before(direct_end, j);
  if (direct_end[j] > slot) {
    const float* row = direct_partial + static_cast<long long>(slot) * n_tiles;
    for (int t = threadIdx.x; t < n_tiles; t += repro::kReduceThreads)
      v += row[t];
  }
  v = repro::block_sum(v, red);
  if (threadIdx.x == 0) out[j] = v;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Launch {
  const void* h;
  const void* z;
  const int* rows;
  const int* offsets;
  const int* items;
  const int* ends;
  const int* dlist;
  float* gram_partial;
  float* direct_partial;
  float* out;
  int n_seg, P_in, P_out;
  long long h_ss, z_ss;
  int gram_blocks;  // the gram kernel's grid; 0: no segment can take it
  int direct;       // the direct kernel's grid depth, the blocks that
                    // stride the direct list for each tile of G; 0: no
                    // segment can take the direct route
  bool vec;         // bf16: the cp.async route
};

template <bool kVec>
cudaError_t launch_gram_wgmma(const GramParams& p, int blocks,
                              cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(segmented_gram_wgmma<kVec>);
  const cudaError_t err = allow_smem(fn, gram_smem_bytes());
  if (err != cudaSuccess) return err;
  segmented_gram_wgmma<kVec>
      <<<blocks, kGramThreads, gram_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch(const Launch& a, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const T* h = static_cast<const T*>(a.h);
  const T* z = static_cast<const T*>(a.z);
  cudaError_t err = cudaSuccess;
  if (a.gram_blocks > 0) {
    if constexpr (kBf16) {
      GramParams p = {};
      p.h = h;
      p.z = z;
      p.h_ss = a.h_ss;
      p.z_ss = a.z_ss;
      p.P_in = a.P_in;
      p.P_out = a.P_out;
      p.rows = a.rows;
      p.offsets = a.offsets;
      p.items = a.items;
      p.ends = a.ends;
      p.n_seg = a.n_seg;
      p.partial = a.gram_partial;
      err = a.vec ? launch_gram_wgmma<true>(p, a.gram_blocks, stream)
                  : launch_gram_wgmma<false>(p, a.gram_blocks, stream);
    } else {
      segmented_gram<<<a.gram_blocks, kThreads, 0, stream>>>(
          h, z, a.rows, a.offsets, a.items, a.ends, a.gram_partial, a.n_seg,
          a.P_in, a.P_out, a.h_ss, a.z_ss);
      err = cudaGetLastError();
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.P_out + kTile - 1) / kTile, (a.P_in + kTile - 1) / kTile,
                  a.direct);
  if (a.direct > 0) {
    if constexpr (kBf16) {
      segmented_partial_mma<<<grid, kThreads, 0, stream>>>(
          h, z, a.rows, a.offsets, a.dlist, a.ends, a.direct_partial,
          a.n_seg, a.P_in, a.P_out, a.h_ss, a.z_ss, a.vec);
    } else {
      segmented_partial<T><<<grid, kThreads, 0, stream>>>(
          h, z, a.rows, a.offsets, a.dlist, a.ends, a.direct_partial,
          a.n_seg, a.P_in, a.P_out, a.h_ss, a.z_ss);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_sums<<<a.n_seg, repro::kReduceThreads, 0, stream>>>(
      a.gram_partial, a.direct_partial, a.ends, a.out, a.n_seg,
      direct_tiles(a.P_in, a.P_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of direct-route partials per listed segment: the wrapper
// allocates a (direct segments at most, n) f32 scratch buffer of this width.
extern "C" int segmented_norm_tiles(int P_in, int P_out) {
  return direct_tiles(P_in, P_out);
}

// The launcher's plan (kernels/segmented_norm.py), in device memory: items
// (segment, ti, tj, weight) int32 rows, one per gram work item; ends
// (3, n_seg) int32, the inclusive running counts of gram items, gram
// segments and direct segments over the segments (ends[0][n_seg - 1] items,
// ends[2][n_seg - 1] direct segments); dlist the direct segments' ids in
// order. gram_partial holds a f32 per item, direct_partial
// segmented_norm_tiles(P_in, P_out) f32 per direct segment. gram_blocks is
// the gram kernel's persistent grid (0: no launch, no segment can take the
// gram route); direct is the direct kernel's grid depth, the blocks that
// stride the direct list for each tile of G (0 skips the direct kernel). vec 1 (bf16 only): rows
// 16-byte aligned, copied by cp.async; 0: by loads and stores.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int segmented_norm_launch(
    const void* h, const void* z, const void* rows, const void* offsets,
    const void* items, const void* ends, const void* dlist,
    void* gram_partial, void* direct_partial, void* out, int dtype, int n_seg,
    int P_in, int P_out, long long h_ss, long long z_ss, int gram_blocks,
    int direct, int vec, void* stream) {
  Launch a = {};
  a.h = h;
  a.z = z;
  a.rows = static_cast<const int*>(rows);
  a.offsets = static_cast<const int*>(offsets);
  a.items = static_cast<const int*>(items);
  a.ends = static_cast<const int*>(ends);
  a.dlist = static_cast<const int*>(dlist);
  a.gram_partial = static_cast<float*>(gram_partial);
  a.direct_partial = static_cast<float*>(direct_partial);
  a.out = static_cast<float*>(out);
  a.n_seg = n_seg;
  a.P_in = P_in;
  a.P_out = P_out;
  a.h_ss = h_ss;
  a.z_ss = z_ss;
  a.gram_blocks = gram_blocks;
  a.direct = direct;
  a.vec = vec != 0;
  if (n_seg < 1 || gram_blocks < 0 ||
      (gram_blocks > 0 && (items == nullptr || gram_partial == nullptr)) ||
      direct < 0 || direct > 65535 ||
      (direct && (dlist == nullptr || direct_partial == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && !vec) return launch<float>(a, st);
  if (dtype == repro::kBFloat16) return launch<bf16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the bf16 gram body (its
// cp.async route).
extern "C" int segmented_norm_kernel_info(int* out) {
  const void* f = reinterpret_cast<const void*>(segmented_gram_wgmma<true>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err == cudaSuccess) err = allow_smem(f, gram_smem_bytes());
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, f, kGramThreads, gram_smem_bytes());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(gram_smem_bytes());
  out[3] = kGramThreads;
  out[4] = blocks;
  return 0;
}
