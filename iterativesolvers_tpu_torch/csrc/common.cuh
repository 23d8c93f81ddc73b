// Shared device helpers for the port's kernels: value loads in f32, 16-byte
// vector loads, division by a runtime constant without a divide, and the
// deterministic dot.
//
// A dot across the whole vector is summed in a fixed order: each block of
// the main kernel writes f32 partials, and the partials are summed in a
// fixed order, either by the block that finishes last (`finish_dot`, in
// the same launch) or by one block of `reduce_partials` (a second launch).
// Which block sums does not change the order of the sum, so the result is
// the same bits on every run of the same grid, and a CG solve takes the
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

// Elements of T in one 16-byte vector load or store.
constexpr int kVecBytes = 16;
template <typename T> constexpr int kVecOf = kVecBytes / static_cast<int>(sizeof(T));

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

// 16 bytes of kVecOf<T> values of T as floats: bf16 widens by a shift; int8
// by the exact float trick 2^23 + (b + 128) - (2^23 + 128), a byte permute
// and an add where a conversion would take the slower conversion unit.
template <typename T>
__device__ __forceinline__ void unpack_vec(uint4 v, float* out);

template <>
__device__ __forceinline__ void unpack_vec<float>(uint4 v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack_vec<__nv_bfloat16>(uint4 v, float* out) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[2 * q] = __uint_as_float(w[q] << 16);
    out[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

template <>
__device__ __forceinline__ void unpack_vec<int8_t>(uint4 v, float* out) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned b = w[q] ^ 0x80808080u;   // each byte as b + 128
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // bytes (b_k + 128, 0, 0, 0x4B): the float 2^23 + b_k + 128
      out[4 * q + k] =
          __uint_as_float(__byte_perm(b, 0x4Bu, 0x4550u | k)) - 8388736.0f;
    }
  }
}

// The 16 bytes at p (16-byte aligned).  kStream: a stream read once, loaded
// with the evict-first hint (ld.global.cs), so that it does not push reused
// data out of L2; else through the read-only path.
template <bool kStream>
__device__ __forceinline__ uint4 load16(const void* p) {
  const uint4* q = static_cast<const uint4*>(p);
  return kStream ? __ldcs(q) : __ldg(q);
}

// The 16 bytes at p as kVecOf<T> floats.
template <typename T, bool kStream>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* out) {
  unpack_vec<T>(load16<kStream>(p), out);
}

// v as kVecOf<T> values of T, stored as one 16-byte vector at p (aligned).
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v);

template <>
__device__ __forceinline__ void store_vec<float>(float* __restrict__ p,
                                                 const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16>(
    __nv_bfloat16* __restrict__ p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16(v[2 * q]));
    const unsigned hi = __bfloat16_as_ushort(__float2bfloat16(v[2 * q + 1]));
    w[q] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// w[e] = x[g0 + S + e], e < R, from 16-byte loads: g0 a multiple of
// kVecOf<T> with x + g0 16-byte aligned, and [g0, g0 + P V) inside x.  S is
// a template argument, so the shift is a choice of registers.
template <typename T, int R, int S>
__device__ __forceinline__ void window_vec(const T* __restrict__ x, int g0,
                                           float (&w)[R]) {
  constexpr int V = kVecOf<T>;
  constexpr int P = (R + S + V - 1) / V;
  float buf[P * V];
#pragma unroll
  for (int p = 0; p < P; ++p) load_vec<T, false>(x + g0 + p * V, buf + p * V);
#pragma unroll
  for (int e = 0; e < R; ++e) w[e] = buf[e + S];
}

// window_vec with the shift s (0 <= s < kVecOf<T>) known at run time only;
// s is the same across a warp, so the choice does not diverge.
template <typename T, int R, int S = 0>
__device__ __forceinline__ void window_vec_at(const T* __restrict__ x, int g0,
                                              int s, float (&w)[R]) {
  if constexpr (S + 1 < kVecOf<T>) {
    if (s == S) {
      window_vec<T, R, S>(x, g0, w);
    } else {
      window_vec_at<T, R, S + 1>(x, g0, s, w);
    }
  } else {
    window_vec<T, R, S>(x, g0, w);
  }
}

// w[e] = x[j0 + e] for the R rows of a run, x of length n and 16-byte
// aligned.  Where the aligned vectors that cover the window lie inside x
// (every run but those at the two ends of x), 16-byte loads, and returns
// true.  Else one load a row from a clamped index, and returns false: the
// caller then masks the rows whose j0 + e lies outside [0, n), which read
// x[0] or x[n - 1] here.  No load stands behind a per-row branch.
template <typename T, int R>
__device__ __forceinline__ bool load_window(const T* __restrict__ x, int j0,
                                            int n, float (&w)[R]) {
  constexpr int V = kVecOf<T>;
  const int s = j0 & (V - 1);
  const int g0 = j0 - s;
  if (g0 >= 0 && g0 + R + (s ? V : 0) <= n) {
    window_vec_at<T, R>(x, g0, s, w);
    return true;
  }
#pragma unroll
  for (int e = 0; e < R; ++e) w[e] = to_f32(x[min(max(j0 + e, 0), n - 1)]);
  return false;
}

// floor(i / d) for 0 <= i < 2^31 from the host's constants for d (mul, shr):
// mul = ceil(2^(31 + l) / d), shr = l - 1, l = ceil(log2 d); mul = 0 for
// d = 1 (the multiply-high and shift of CUTLASS's FastDivmod; replayed on
// the host by ops/cuda_stencil.fast_divisor).
__device__ __forceinline__ unsigned fast_div(unsigned i, unsigned mul,
                                             unsigned shr) {
  return mul ? (__umulhi(i, mul) >> shr) : i;
}

// arr[e] = v for a run index e known at run time only, arr kept in
// registers.
template <int R>
__device__ __forceinline__ void set_at(float (&arr)[R], int e, float v) {
#pragma unroll
  for (int q = 0; q < R; ++q) arr[q] = q == e ? v : arr[q];
}

// Finish the in-launch dot.  `local` is this thread's sum of its rows'
// products, added by fmaf from 0 in the order of its grid-stride loop.
// Each block writes the block_sum of its threads to partials[blockIdx.x];
// the block that draws the last ticket sums the gridDim.x partials (thread
// t adds partials t, t + blockDim.x, ... from 0, then block_sum), writes
// *dot and sets the ticket back to 0 for the next launch.  The order
// depends on n and the grid alone, so a launch on the same inputs and grid
// gives the same bits on every run.  Every thread of the block calls it.
__device__ __forceinline__ void finish_dot(float local, float* partials,
                                           unsigned* ticket, float* dot) {
  __shared__ bool last;
  const float s = block_sum(local);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  float v = 0.0f;
  for (int i = threadIdx.x; i < gridDim.x; i += blockDim.x) v += __ldcg(partials + i);
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *dot = v;
    *ticket = 0u;
  }
}

// Blocks of `kernel` (kThreads threads, no dynamic shared memory) that one
// SM holds at once, written to *blocks; returns a CUDA error code.
inline int blocks_per_sm(const void* kernel, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, 0));
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
