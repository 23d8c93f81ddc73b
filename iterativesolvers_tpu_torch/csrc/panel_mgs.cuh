// The panel MGS sweep shared by `panel_mgs.cu` (panel_mgs) and `arnoldi.cu`
// (fused_arnoldi): device code that runs inside one cooperative launch.
//
// Every pass is a grid-stride loop over the n entries with the same
// assignment of entries to threads, so each thread reads back only the
// working-vector entries it wrote itself.  A dot across the grid is summed
// deterministically: each block writes one f32 partial; after grid.sync()
// every block sums all partials in the same fixed order, so every block
// holds the same bits of h_j and a solve takes the same steps on every run.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace its {

namespace cg = cooperative_groups;

// Store this block's sum of `v` as its partial.  Valid in any thread; the
// caller synchronises the grid before the partials are read.
__device__ __forceinline__ void write_partial(float* partials, float v) {
  const float s = block_sum(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Sum of the `g` partials, in a fixed order, returned to every thread of the
// block.  Partials are written by other blocks in this launch, so they are
// read past L1 (__ldcg).
__device__ __forceinline__ float grid_total(const float* partials, int g) {
  __shared__ float total;
  float s = 0.0f;
  for (int i = threadIdx.x; i < g; i += blockDim.x) s += __ldcg(partials + i);
  s = block_sum(s);
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  const float r = total;
  __syncthreads();
  return r;
}

// After the partials of h_0 = <V_0, src> are in `partials[0:G]` and the grid
// has synchronised: modified Gram-Schmidt against rows 0..k, then the norm,
// then `out[i] = y[i] * (1 / nrm * scale)` in V's dtype (1/nrm taken as 1
// where nrm = 0): `out` is panel row k + 1 and scale is GMRES's do.
//
//   pass j (j < k):  y = src - h_j V_j, and the partials of <V_{j+1}, y>
//   pass k:          y = src - h_k V_k, and the partials of |y|^2
//   last pass:       the write of out
//
// src is the input w in the first pass and y after it; y may equal src.
// h[0..k] = h_j, h[k+1..m1) = 0; nrm_out = |y|.  `partials` holds
// (k + 2) * gridDim.x floats.
template <typename TV>
__device__ void mgs_sweep(cg::grid_group& grid, const TV* V, const float* src,
                          float* y, float* partials, float* h,
                          float* nrm_out, int n, int m1, int k, float scale,
                          TV* out) {
  const int g = gridDim.x;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int step = g * blockDim.x;
  for (int j = 0; j <= k; ++j) {
    const float hj = grid_total(partials + static_cast<size_t>(j) * g, g);
    if (blockIdx.x == 0 && threadIdx.x == 0) h[j] = hj;
    const TV* vj = V + static_cast<size_t>(j) * n;
    float acc = 0.0f;
    if (j < k) {
      const TV* vn = vj + n;
      for (int i = i0; i < n; i += step) {
        const float yi = fmaf(-hj, to_f32(vj[i]), src[i]);
        y[i] = yi;
        acc = fmaf(to_f32(vn[i]), yi, acc);
      }
    } else {
      for (int i = i0; i < n; i += step) {
        const float yi = fmaf(-hj, to_f32(vj[i]), src[i]);
        y[i] = yi;
        acc = fmaf(yi, yi, acc);
      }
    }
    write_partial(partials + static_cast<size_t>(j + 1) * g, acc);
    src = y;
    grid.sync();
  }
  const float nrm = sqrtf(grid_total(partials + static_cast<size_t>(k + 1) * g, g));
  const float inv = (nrm == 0.0f ? 1.0f : 1.0f / nrm) * scale;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) *nrm_out = nrm;
    for (int j = k + 1 + threadIdx.x; j < m1; j += blockDim.x) h[j] = 0.0f;
  }
  for (int i = i0; i < n; i += step) out[i] = from_f32<TV>(y[i] * inv);
}

// The largest grid of `kernel` (kThreads threads a block) that a cooperative
// launch takes on the current device, and no more blocks than n needs.
template <typename Kernel>
int cooperative_grid(Kernel kernel, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int need = (n + kThreads - 1) / kThreads;
  const int most = per_sm * sms;
  *grid = need < most ? need : most;
  return *grid >= 1 ? 0 : -1;
}

}  // namespace its
