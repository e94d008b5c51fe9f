// Helpers shared by the per-example norm kernels: input loads in f32, a
// deterministic block sum, and the second-pass reduction of per-block
// partials.
//
// Every kernel of this package cuts one example's sum into per-block
// partials in a (B, n_blocks) f32 scratch buffer; reduce_partials then sums
// each row in a fixed order. No atomics are used, so a run reproduces its
// norms bit for bit (a DP audit re-runs steps and expects the same norms).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes shared with the Python wrappers (kernels/_build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum of v over the block, valid on thread 0. The order of the additions is
// fixed by the thread layout, so the result is the same on every run.
// `red` holds one float per warp; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------------
// bf16 tensor-core helpers (mma.sync m16n8k16, f32 accumulate)
// ---------------------------------------------------------------------------

// Four 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the row
// addresses of matrix j, and r[j] receives this lane's fragment of it.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The same with each 8x8 matrix transposed on the way into registers.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy 8 consecutive bf16 of one row, x[col .. col + 8), to 16-byte-aligned
// shared memory; elements at or past P read as 0. `vec` says the source is
// 16-byte aligned wherever col is a multiple of 8.
__device__ __forceinline__ void stage8_bf16(const __nv_bfloat16* row, int col,
                                            int P, bool vec, void* dst) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec && col + 8 <= P) {
    v = *reinterpret_cast<const uint4*>(row + col);
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
    alignas(16) unsigned short tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tmp[e] = (col + e < P) ? src[col + e] : 0;
    v = *reinterpret_cast<const uint4*>(tmp);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

constexpr int kReduceThreads = 256;

// out[b] = sum_k partial[b, k], one block per example, fixed order. Static:
// each .cu file that includes this header launches its own copy.
static __global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partial, float* __restrict__ out,
                int n_blocks) {
  __shared__ float red[kReduceThreads / 32];
  const float* row = partial + static_cast<long long>(blockIdx.x) * n_blocks;
  float v = 0.f;
  for (int k = threadIdx.x; k < n_blocks; k += kReduceThreads) v += row[k];
  v = block_sum(v, red);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

}  // namespace repro
