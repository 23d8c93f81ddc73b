// The two shard-local sweeps of distributed CGS2, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of
// iterativesolvers_tpu/parallel/panel_ortho.py: `_pallas_dots` (:197, kernel
// `_dots_kernel` :121-150) and `_pallas_update` (:227, kernel
// `_update_kernel` :153-190).  On one shard, with V the (m1, N) panel block
// (N = R * 512 entries a row, f32 or bf16), w an f32 (N,) vector and k read
// from device memory:
//
//   panel_dots:    out[j] = <V_j, w>  for j <= k,  0 for j > k
//   panel_update:  y = w - h_0 V_0 - h_1 V_1 - ... - h_k V_k   (rows in this
//                  order, each product subtracted in f32 with one rounding),
//                  and ss = sum_i y_i^2
//
// A bf16 row is widened to f32 before its product.  The partial dots of all
// shards are summed by one allreduce outside the kernels (dist_panel_ortho).
//
// Bound on an H100 SXM (3.35 TB/s): both are streams over the shard's panel.
// panel_dots reads rows 0..k and w once, (k + 1) N es + 4N bytes for es-byte
// entries; panel_update also writes y, (k + 1) N es + 8N.  At D = 2 ranks of
// the 216^3 Laplacian (N = 5,242,880) and k = 19: panel_dots 440 MB (131 us)
// f32, 231 MB (69 us) bf16; panel_update 461 MB (138 us) f32, 252 MB (75 us)
// bf16.  The operations (2 a row and entry) are far below 67 TFLOP/s f32.
//
// Design.  The TPU kernels keep the whole shard's w in VMEM and run rows on
// their sequential grid.  Here a block owns one chunk of 4096 entries (256
// threads of kVec = 4 float4 groups): each thread keeps its 16 entries of w (or y) in registers, loaded
// once, and walks the rows j = 0..k, reading each row's chunk with 16-byte
// (f32) or 8-byte (bf16) loads, neighbouring threads on neighbouring
// addresses.  So every panel entry and every w entry is read once, and w
// makes no round trip through memory between rows.  A dot leaves one f32
// partial per (row, block); a second small launch sums a row's partials in
// a fixed order, so the result is the same bits on every run and a solve
// takes the same steps every time.  Rows past k are never read.
#include "common.cuh"

namespace its {

constexpr int kVec = 4;  // float4 groups per thread

__device__ __forceinline__ float4 load4(const float* p, int q) {
  return __ldg(reinterpret_cast<const float4*>(p) + q);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int q) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + q);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The float4 group of this thread's s-th slot: consecutive threads take
// consecutive groups.  A group at or past a row's n4 groups is skipped.
__device__ __forceinline__ int group(int s) {
  return blockIdx.x * (kThreads * kVec) + s * kThreads + threadIdx.x;
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
panel_dots_kernel(const TV* __restrict__ V, const float* __restrict__ w,
                  float* __restrict__ partials, const int* __restrict__ kp,
                  int n4, int m1) {
  const int k = min(*kp, m1 - 1);
  const size_t row = static_cast<size_t>(n4) * 4;
  float4 wr[kVec];
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    const int q = group(s);
    wr[s] = q < n4 ? load4(w, q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = 0; j <= k; ++j) {
    const TV* vj = V + static_cast<size_t>(j) * row;
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int q = group(s);
      if (q < n4) acc = dot4(load4(vj, q), wr[s], acc);
    }
    const float t = block_sum(acc);
    if (threadIdx.x == 0) partials[static_cast<size_t>(j) * gridDim.x + blockIdx.x] = t;
    __syncthreads();  // block_sum's shared slots are reused by the next row
  }
}

// Block j sums row j's g partials in a fixed order; rows past k give 0.
__global__ void __launch_bounds__(kThreads)
reduce_rows(const float* __restrict__ partials, int g,
            const int* __restrict__ kp, int m1, float* __restrict__ out) {
  const int j = blockIdx.x;
  if (j > min(*kp, m1 - 1)) {
    if (threadIdx.x == 0) out[j] = 0.0f;
    return;
  }
  float s = 0.0f;
  for (int i = threadIdx.x; i < g; i += blockDim.x) {
    s += partials[static_cast<size_t>(j) * g + i];
  }
  s = block_sum(s);
  if (threadIdx.x == 0) out[j] = s;
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
panel_update_kernel(const TV* __restrict__ V, const float* __restrict__ w,
                    const float* __restrict__ h, float* __restrict__ y,
                    float* __restrict__ partials, const int* __restrict__ kp,
                    int n4, int m1) {
  const int k = min(*kp, m1 - 1);
  const size_t row = static_cast<size_t>(n4) * 4;
  float4 yr[kVec];
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    const int q = group(s);
    yr[s] = q < n4 ? load4(w, q) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = 0; j <= k; ++j) {
    const TV* vj = V + static_cast<size_t>(j) * row;
    const float hj = -__ldg(h + j);
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const int q = group(s);
      if (q < n4) {
        const float4 v = load4(vj, q);
        yr[s].x = fmaf(hj, v.x, yr[s].x);
        yr[s].y = fmaf(hj, v.y, yr[s].y);
        yr[s].z = fmaf(hj, v.z, yr[s].z);
        yr[s].w = fmaf(hj, v.w, yr[s].w);
      }
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    const int q = group(s);
    if (q < n4) {
      reinterpret_cast<float4*>(y)[q] = yr[s];
      acc = dot4(yr[s], yr[s], acc);
    }
  }
  const float t = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
}

int grid_of(int n4) { return (n4 + kThreads * kVec - 1) / (kThreads * kVec); }

template <typename TV>
int dots(const void* V, const void* w, void* partials, void* out,
         const void* kp, int n4, int m1, cudaStream_t s) {
  const int g = grid_of(n4);
  panel_dots_kernel<TV><<<g, kThreads, 0, s>>>(
      static_cast<const TV*>(V), static_cast<const float*>(w),
      static_cast<float*>(partials), static_cast<const int*>(kp), n4, m1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_rows<<<m1, kThreads, 0, s>>>(static_cast<const float*>(partials), g,
                                      static_cast<const int*>(kp), m1,
                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename TV>
int update(const void* V, const void* w, const void* h, void* y,
           void* partials, void* ss, const void* kp, int n4, int m1,
           cudaStream_t s) {
  const int g = grid_of(n4);
  panel_update_kernel<TV><<<g, kThreads, 0, s>>>(
      static_cast<const TV*>(V), static_cast<const float*>(w),
      static_cast<const float*>(h), static_cast<float*>(y),
      static_cast<float*>(partials), static_cast<const int*>(kp), n4, m1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), g, static_cast<float*>(ss));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace its

// The number of blocks (and of partials a row) both kernels take for rows of
// n entries, n a multiple of 4.
extern "C" int its_panel_ortho_grid(int n) {
  return n >= 4 && n % 4 == 0 ? its::grid_of(n / 4) : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (the panel V, (m1, n) row-major, n a
// multiple of 4, 16-byte aligned).  w f32 (n,); out f32 (m1,); k one int32 on
// the device.  `partials` holds m1 * its_panel_ortho_grid(n) floats.  Returns
// the CUDA error code of the launches (0 = success), or -1 for bad arguments.
extern "C" int its_panel_dots(int dtype, const void* V, const void* w,
                              void* partials, void* out, const void* k, int n,
                              int m1, void* stream) {
  using namespace its;
  if (n < 4 || n % 4 != 0 || m1 < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dots<float>(V, w, partials, out, k, n / 4, m1, s);
  if (dtype == 1) {
    return dots<__nv_bfloat16>(V, w, partials, out, k, n / 4, m1, s);
  }
  return -1;
}

// As its_panel_dots; h f32 (m1,), y f32 (n,), ss one f32; `partials` holds
// its_panel_ortho_grid(n) floats.
extern "C" int its_panel_update(int dtype, const void* V, const void* w,
                                const void* h, void* y, void* partials,
                                void* ss, const void* k, int n, int m1,
                                void* stream) {
  using namespace its;
  if (n < 4 || n % 4 != 0 || m1 < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return update<float>(V, w, h, y, partials, ss, k, n / 4, m1, s);
  }
  if (dtype == 1) {
    return update<__nv_bfloat16>(V, w, h, y, partials, ss, k, n / 4, m1, s);
  }
  return -1;
}
