// Matrix-free constant-coefficient stencil SpMV with an optional fused
// <x, Ax>, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stencil_apply`
// (iterativesolvers_tpu/ops/pallas_stencil.py:147-308).  It computes
//     y[i] = center * x[i] + sum_t c_t * x[i + off_t]
// where term t counts only where the grid axis it couples stays on the grid,
// pos = (i / stride_t) % extent_t and 0 <= pos + off_t / stride_t < extent_t,
// and where 0 <= i + off_t < n: the same rule as StencilOperator._apply.
// With the dot it also gives <x, y> in f32, summed from the y it stored.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel has to read x once and write y
// once, 8 bytes a row in f32; at n = 216^3 that is 80.6 MB, 24.1 us.  The
// neighbours' reads hit L1/L2, since a thread block's rows and their +-1,
// +-side and +-side^2 neighbours are loaded by nearby blocks in the same
// window of time.
//
// Order of the sum: the products are added in ascending offset order, the
// center at offset 0, starting from 0 -- the order in which the DIA kernel
// (dia_spmv.cu) sums a DIAMatrix whose offsets are sorted, as laplace_dia's
// and to_dia's are.  So the matrix-free and the stored Laplacian give the
// same bits, and an f32 CG takes the same steps on both.  (The TPU kernel
// adds the center first: for a Laplacian the partial sums then reach 2x the
// magnitude, and at 216^3 an f32 CG on an H100 took 476 steps against the
// stored matrix's 408.)  A first loop, over the terms grouped by (stride,
// extent), sets one bit per valid term; a second adds the valid products in
// order.
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
#include "common.cuh"

namespace its {

constexpr int kMaxTerms = 8;             // off-diagonal terms
constexpr int kMaxSum = kMaxTerms + 1;   // and the center

struct StencilTerms {
  // validity of the off-diagonal terms, grouped by (stride, extent)
  int nterms;
  int off[kMaxTerms];
  int step[kMaxTerms];          // off / stride, floor division (host side)
  unsigned stride[kMaxTerms];
  unsigned extent[kMaxTerms];
  int reuse[kMaxTerms];         // same (stride, extent) as the term before
  int bit[kMaxTerms];           // position of the term in the sum below
  // the sum, in ascending offset order; the center's bit is always set
  int nsum;
  unsigned center_bit;
  int sum_off[kMaxSum];
  float sum_coeff[kMaxSum];
};

template <typename T, bool kDot>
__global__ void __launch_bounds__(kThreads)
stencil_kernel(const T* __restrict__ x, T* __restrict__ y,
               float* __restrict__ partials, int n, StencilTerms t) {
  float local = 0.0f;
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    unsigned valid = t.center_bit;
    int pos = 0;
#pragma unroll
    for (int k = 0; k < kMaxTerms; ++k) {
      if (k < t.nterms) {
        if (!t.reuse[k]) pos = static_cast<int>((static_cast<unsigned>(i) / t.stride[k]) % t.extent[k]);
        const int p = pos + t.step[k];
        const int j = i + t.off[k];
        if (p >= 0 && p < static_cast<int>(t.extent[k]) && j >= 0 && j < n) {
          valid |= 1u << t.bit[k];
        }
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxSum; ++k) {
      if (k < t.nsum && ((valid >> k) & 1u)) {
        acc = fmaf(t.sum_coeff[k], to_f32(x[i + t.sum_off[k]]), acc);
      }
    }
    const T yv = from_f32<T>(acc);
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

// dtype: 0 = float32, 1 = bfloat16 (x and y).  The `nterms` off-diagonal
// terms come as (off, step, stride, extent, bit) arrays; the `nsum` products
// as (sum_off, sum_coeff) in the order they are added, the center's at
// `center_bit`.  `partials` holds `grid` floats; `dot` one float, written
// only when with_dot.  Returns the CUDA error code of the launches
// (0 = success), or -1 for bad arguments.
extern "C" int its_stencil_apply(int dtype, int with_dot, const void* x,
                                 void* y, void* partials, void* dot, int n,
                                 int grid, int nterms, const int* off,
                                 const int* step, const int* stride,
                                 const int* extent, const int* bit, int nsum,
                                 int center_bit, const int* sum_off,
                                 const float* sum_coeff, void* stream) {
  using namespace its;
  if (nterms < 0 || nterms > kMaxTerms || nsum != nterms + 1 || grid < 1 ||
      n < 1 || center_bit < 0 || center_bit >= nsum) {
    return -1;
  }
  StencilTerms t = {};
  t.nterms = nterms;
  for (int k = 0; k < nterms; ++k) {
    if (stride[k] <= 0 || extent[k] <= 0 || bit[k] < 0 || bit[k] >= nsum) return -1;
    t.off[k] = off[k];
    t.step[k] = step[k];
    t.stride[k] = static_cast<unsigned>(stride[k]);
    t.extent[k] = static_cast<unsigned>(extent[k]);
    t.reuse[k] = k > 0 && stride[k] == stride[k - 1] && extent[k] == extent[k - 1];
    t.bit[k] = bit[k];
  }
  t.nsum = nsum;
  t.center_bit = 1u << center_bit;
  for (int k = 0; k < nsum; ++k) {
    t.sum_off[k] = sum_off[k];
    t.sum_coeff[k] = sum_coeff[k];
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
