// Row rescale: out[b, s, :] = c[b] * z[b, s, :] (paper section 6's Z-bar
// modification).
//
// Replaces the TPU kernel src/repro/kernels/clip_scale.py::clip_scale
// (pallas_call at :56, body _kernel at :38; wrapper kernels/ops.py:328).
//
// z (B, S, N), f32 or bf16, with the last axis contiguous (strides of the
// batch and sequence axes are arguments); c (B,) f32; out (B, S, N)
// contiguous, z's dtype. Each element is multiplied in f32 and rounded once
// to z's dtype, as the Pallas body does (z.astype(f32) * c[b]).astype(dtype).
//
// What bounds it on the H100: bytes. One multiply per element against one
// read and one write of it.
//
// Design: the TPU kernel read c[b] from SMEM by scalar prefetch and streamed
// (tile_s x tile_p) blocks of one example. Here blockIdx.y walks the rows
// (b, s), each block reads its row's c[b] once, and the threads of
// blockIdx.x stream the row in 16-byte vectors (4 f32 or 8 bf16) when the
// input and output rows lie on 16-byte boundaries, element by element
// otherwise. No block depends on another and nothing is summed, so the
// result is exact and the same on every run.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y limit

__device__ __forceinline__ float from_f32(float x, float) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint4 scale16(const uint4& v, float c, float) {
  return make_uint4(__float_as_uint(__uint_as_float(v.x) * c),
                    __float_as_uint(__uint_as_float(v.y) * c),
                    __float_as_uint(__uint_as_float(v.z) * c),
                    __float_as_uint(__uint_as_float(v.w) * c));
}

__device__ __forceinline__ uint4 scale16(const uint4& v, float c,
                                         __nv_bfloat16) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    const __nv_bfloat162 r = __floats2bfloat162_rn(f.x * c, f.y * c);
    w[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
clip_scale_kernel(const T* __restrict__ z, const float* __restrict__ c,
                  T* __restrict__ out, int S, int n, long long rows,
                  long long sb, long long ss, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const int slots = vec ? n / V : n;
  const int stride = gridDim.x * kThreads;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / S;
    const T* zr = z + b * sb + (r % S) * ss;
    T* o = out + r * n;
    const float cb = c[b];
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < slots; i += stride) {
      if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(zr) + i);
        reinterpret_cast<uint4*>(o)[i] = scale16(v, cb, T());
      } else {
        o[i] = from_f32(to_f32(zr[i]) * cb, T());
      }
    }
  }
}

template <typename T>
int launch(const void* z, const float* c, void* out, int B, int S, int n,
           long long sb, long long ss, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long rows = static_cast<long long>(B) * S;
  // 16-byte vectors need every input row and every output row (r * n
  // elements from the output's base) on a 16-byte boundary
  const bool vec = reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 && n % V == 0 &&
                   (B == 1 || sb % V == 0) && (S == 1 || ss % V == 0);
  const int slots = vec ? n / V : n;
  dim3 grid((slots + kThreads - 1) / kThreads,
            static_cast<unsigned>(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
  clip_scale_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(z), c, static_cast<T*>(out), S, n, rows, sb, ss,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int info(int* out) {
  const void* f = reinterpret_cast<const void*>(clip_scale_kernel<T>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = 0;  // no shared memory
  out[3] = kThreads;
  out[4] = blocks;
  return 0;
}

}  // namespace

// Registers, local memory bytes a thread, dynamic shared memory bytes,
// threads and resident blocks per SM (out[0..4]) of the body of `dtype`.
extern "C" int clip_scale_kernel_info(int dtype, int* out) {
  if (dtype == repro::kFloat32) return info<float>(out);
  if (dtype == repro::kBFloat16) return info<__nv_bfloat16>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns cudaGetLastError() after the launch (0 on success). B, S, n >= 1.
extern "C" int clip_scale_launch(const void* z, const void* c, void* out,
                                 int dtype, int B, int S, int n, long long sb,
                                 long long ss, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(c);
  if (dtype == repro::kFloat32)
    return launch<float>(z, cp, out, B, S, n, sb, ss, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(z, cp, out, B, S, n, sb, ss, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
