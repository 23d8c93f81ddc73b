// Matrix-free constant-coefficient stencil SpMV with an optional fused
// <x, Ax>, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stencil_apply`
// (iterativesolvers_tpu/ops/pallas_stencil.py:147-308).  It computes
//     y[i] = center * x[i] + sum_t c_t * x[i + off_t]
// with the masks and the sum order of stencil.cuh.  With the dot it also
// gives <x, y> in f32, summed from the y it stored.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel has to read x once and write y
// once, 8 bytes a row in f32; at n = 216^3 that is 80.6 MB, 24.1 us.  The
// neighbours' reads hit L1/L2, since a thread block's rows and their +-1,
// +-side and +-side^2 neighbours are loaded by nearby blocks in the same
// window of time.
//
// Sum order (stencil.cuh): ascending offsets, the DIA kernel's order.  (The
// TPU kernel adds the center first: for a Laplacian the partial sums then
// reach 2x the magnitude, and at 216^3 an f32 CG on an H100 took 476 steps
// against the stored matrix's 408.)
//
// What the TPU design needed and this one does not: the period/LCM blocking,
// the pre-masked coefficient streams and the 1024-lane halo DMAs existed for
// VMEM and Mosaic alignment.  Here each thread computes its masks from its
// row index, the terms come by value in a small struct, and the output is
// written at its length n.  The TPU grid ran in order and summed the dot in
// SMEM across steps; here blocks run in no order, so each writes an f32
// partial and a second pass sums them in a fixed order (common.cuh).
// Simple by design: one thread per row in a grid-stride loop, coalesced
// loads, no shared-memory tiling yet.
#include "stencil.cuh"

namespace its {

template <typename T, bool kDot>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ x, T* __restrict__ y,
               float* __restrict__ partials, int n, StencilTerms t) {
  float local = 0.0f;
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const T yv = from_f32<T>(stencil_row(x, i, n, t));
    y[i] = yv;
    if (kDot) local = fmaf(to_f32(x[i]), to_f32(yv), local);
  }
  if (kDot) {
    const float s = block_sum(local);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

template <typename T>
void launch(int with_dot, const void* x, void* y, void* partials, int n,
            int grid, const StencilTerms& t, cudaStream_t s) {
  if (with_dot) {
    stencil_kernel<T, true><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<float*>(partials), n, t);
  } else {
    stencil_kernel<T, false><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<float*>(partials), n, t);
  }
}

}  // namespace its

// dtype: 0 = float32, 1 = bfloat16 (x and y).  The terms as in
// stencil.cuh's pack_terms.  `partials` holds `grid` floats; `dot` one
// float, written only when with_dot.  Returns the CUDA error code of the
// launches (0 = success), or -1 for bad arguments.
extern "C" int its_stencil_apply(int dtype, int with_dot, const void* x,
                                 void* y, void* partials, void* dot, int n,
                                 int grid, int nterms, const int* off,
                                 const int* step, const int* stride,
                                 const int* extent, const int* bit, int nsum,
                                 int center_bit, const int* sum_off,
                                 const float* sum_coeff, void* stream) {
  using namespace its;
  StencilTerms t;
  if (grid < 1 || n < 1 ||
      !pack_terms(&t, nterms, off, step, stride, extent, bit, nsum,
                  center_bit, sum_off, sum_coeff)) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(with_dot, x, y, partials, n, grid, t, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(with_dot, x, y, partials, n, grid, t, s);
  } else {
    return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_dot) return static_cast<int>(err);
  reduce_partials<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), grid, static_cast<float*>(dot));
  return static_cast<int>(cudaGetLastError());
}
