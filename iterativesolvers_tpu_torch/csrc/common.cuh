// Shared device helpers for the port's kernels: value loads in f32 and the
// deterministic two-pass dot.
//
// A dot across the whole vector is summed in two passes with no atomics:
// each block of the main kernel writes one f32 partial, and one block of
// `reduce_partials` sums the partials in a fixed order.  The result is the
// same bits on every run for a given n and grid, so a CG solve takes the
// same iteration count every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace its {

// Threads per block of the main kernels.  The grid (at most 2048 blocks, a
// grid-stride loop covers the rest) is chosen by the Python wrapper, which
// allocates one partial per block.
constexpr int kThreads = 256;
constexpr int kReduceThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum of `v` over the block, valid in thread 0.  blockDim.x is a multiple of
// 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (threadIdx.x < nwarps) ? warp_sums[threadIdx.x] : 0.0f;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Second pass of the dot: one block sums `m` partials in a fixed order.
__global__ void reduce_partials(const float* __restrict__ partials, int m,
                                float* __restrict__ out) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s += partials[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace its
