// Row-wise sum of squares: out[b, s] = sum_k x[b, s, k]^2, in f32.
//
// Replaces the TPU kernel src/repro/kernels/rowsumsq.py::rowsumsq
// (pallas_call at :58, body _kernel at :40; wrapper kernels/ops.py:229).
//
// x (B, S, N), f32 or bf16, with the last axis contiguous (strides of the
// batch and sequence axes are arguments, so a strided (B, S, N) view is read
// where it lies); out (B, S) f32, contiguous.
//
// What bounds it on the H100: bytes. Each element is read once and costs
// two operations (square, add): 0.5 flop per byte in f32, 1 in bf16, far
// below the card's balance point. On the token path the rows run from 512
// elements (wk/wv's z-bar) to 128,256 (the LM head's z-bar: 1.05 GB in bf16
// at B=8, S=512), so the design is about keeping enough loads in flight at
// both ends.
//
// Design: the TPU kernel carried per-row partials across its sequential N
// grid axis in a revisited output block. Here one warp owns a row of fewer
// than kWideRow elements, and one 256-thread block owns a wider row; the
// carry becomes the loop of each thread over its share of the row. Each
// thread reads 16 bytes at a time (4 f32 or 8 bf16) after a scalar head
// that brings the row to a 16-byte boundary, and ends with a scalar tail, so
// any width and any row alignment is taken without a copy. Each thread sums
// its elements in a fixed order, then warp shuffles (and, for a block, the
// shared-memory step of repro::block_sum) combine the threads in a fixed
// order. No atomics: the result is the same bit for bit on every run.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kWideRow = 16384;  // elements: from here on a block owns a row

__device__ __forceinline__ float sumsq16(const uint4& v, float) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
  const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
  return fmaf(d, d, fmaf(c, c, fmaf(b, b, a * a)));
}

__device__ __forceinline__ float sumsq16(const uint4& v, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    acc = fmaf(f.x, f.x, acc);
    acc = fmaf(f.y, f.y, acc);
  }
  return acc;
}

// This thread's share of sum(row[k]^2), the thread being number `l` of the
// `g` threads that own the row: the scalar head up to a 16-byte boundary,
// the 16-byte vectors, then the scalar tail, each strided by g.
template <typename T>
__device__ __forceinline__ float row_partial(const T* __restrict__ row, int n,
                                             int l, int g) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int head = min(n, static_cast<int>(((16 - (addr & 15)) & 15) /
                                           sizeof(T)));
  const int nv = (n - head) / V;
  float acc = 0.f;
  for (int k = l; k < head; k += g) {
    const float v = to_f32(row[k]);
    acc = fmaf(v, v, acc);
  }
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (int i = l; i < nv; i += g) acc += sumsq16(__ldg(vec + i), T());
  for (int k = head + nv * V + l; k < n; k += g) {
    const float v = to_f32(row[k]);
    acc = fmaf(v, v, acc);
  }
  return acc;
}

// One warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsumsq_warp(const T* __restrict__ x, float* __restrict__ out, int S, int n,
              long long rows, long long sb, long long ss) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp leaves together
  const T* row = x + (r / S) * sb + (r % S) * ss;
  float v = row_partial(row, n, lane, 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) out[r] = v;
}

// One block per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rowsumsq_block(const T* __restrict__ x, float* __restrict__ out, int S, int n,
               long long sb, long long ss) {
  __shared__ float red[kWarpsPerBlock];
  const long long r = blockIdx.x;
  const T* row = x + (r / S) * sb + (r % S) * ss;
  float v = row_partial(row, n, static_cast<int>(threadIdx.x), kThreads);
  v = repro::block_sum(v, red);
  if (threadIdx.x == 0) out[r] = v;
}

template <typename T>
int launch(const void* x, float* out, int B, int S, int n, long long sb,
           long long ss, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * S;
  const T* xp = static_cast<const T*>(x);
  if (n >= kWideRow) {
    rowsumsq_block<T><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
        xp, out, S, n, sb, ss);
  } else {
    const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    rowsumsq_warp<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        xp, out, S, n, rows, sb, ss);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(bool wide, int* out) {
  const void* f = wide ? reinterpret_cast<const void*>(rowsumsq_block<T>)
                       : reinterpret_cast<const void*>(rowsumsq_warp<T>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = 0;  // no dynamic shared memory (the block body's 8-float
               // reduction scratch is static)
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

}  // namespace

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the body of `dtype` that
// owns a row by a warp (wide 0) or by a block (wide 1).
extern "C" int rowsumsq_kernel_info(int dtype, int wide, int* out) {
  if (dtype == repro::kFloat32) return info<float>(wide != 0, out);
  if (dtype == repro::kBFloat16) return info<__nv_bfloat16>(wide != 0, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns cudaGetLastError() after the launch (0 on success). B, S, n >= 1.
extern "C" int rowsumsq_launch(const void* x, void* out, int dtype, int B,
                               int S, int n, long long sb, long long ss,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32)
    return launch<float>(x, o, B, S, n, sb, ss, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, o, B, S, n, sb, ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
