// DIA SpMV with an optional fused <u, Ax>, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `dia_spmv` / `dia_spmv_dot`
// (iterativesolvers_tpu/ops/pallas_spmv.py:53-153).  It computes
//     y[i] = sum_d diag_d[i] * x[i + off_d],   diag_d[i] = A[i, i + off_d],
// where a column outside [0, n) reads 0, and with the dot also sum_i u[i] y[i]
// in f32.  x, u and y are f32; the diagonals are f32, bf16 or int8 (the
// streams compress_values makes), and each product is promoted to f32 before
// it is summed, as DIAMatrix.mv promotes to result_type(diag, x).
//
// Bound on an H100 SXM (3.35 TB/s): the kernel has to read every diagonal
// once, x once (u = x in CG) and write y once.  At n = 216^3 with 7
// diagonals: f32 362.8 MB (108.3 us), bf16 221.7 MB (66.2 us), int8
// 151.2 MB (45.1 us).  The diagonals are the dominant stream, so narrowing
// them is the lever; the shifted reads of x hit L1/L2.
//
// What the TPU design needed and this one does not: the halo/padding plan
// (1024-lane aligned windows, padded diagonals).  Each thread reads its own
// x[i + off] and masks the ragged edge from the index.  The TPU grid summed
// the dot in SMEM across sequential steps; here each block writes an f32
// partial and one block sums them in a fixed order (common.cuh), so the dot
// is the same bits on every run.  One thread per row in a grid-stride loop,
// coalesced loads, no vector loads yet.
#include "common.cuh"

namespace its {

constexpr int kMaxDiags = 16;

struct DiaArgs {
  int nd;
  int off[kMaxDiags];
  const void* diag[kMaxDiags];
};

template <typename D, bool kDot>
__global__ void __launch_bounds__(kThreads)
dia_kernel(DiaArgs a, const float* __restrict__ x, const float* __restrict__ u,
           float* __restrict__ y, float* __restrict__ partials, int n) {
  float local = 0.0f;
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxDiags; ++k) {
      if (k < a.nd) {
        const int j = i + a.off[k];
        if (j >= 0 && j < n) {
          const float d = to_f32(static_cast<const D*>(a.diag[k])[i]);
          acc = fmaf(d, x[j], acc);
        }
      }
    }
    y[i] = acc;
    if (kDot) local = fmaf(u[i], acc, local);
  }
  if (kDot) {
    const float s = block_sum(local);
    if (threadIdx.x == 0) partials[blockIdx.x] = s;
  }
}

template <typename D>
void launch(int with_dot, const DiaArgs& a, const void* x, const void* u,
            void* y, void* partials, int n, int grid, cudaStream_t s) {
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(partials);
  if (with_dot) {
    dia_kernel<D, true><<<grid, kThreads, 0, s>>>(a, xf, uf, yf, pf, n);
  } else {
    dia_kernel<D, false><<<grid, kThreads, 0, s>>>(a, xf, uf, yf, pf, n);
  }
}

}  // namespace its

// diag_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  `diags` and `offs` are
// host arrays of `nd` device pointers and offsets.  `partials` holds `grid`
// floats; `dot` one float, written only when with_dot.  Returns the CUDA
// error code of the launches (0 = success), or -1 for bad arguments.
extern "C" int its_dia_spmv(int diag_dtype, int with_dot,
                            const void* const* diags, const int* offs, int nd,
                            const void* x, const void* u, void* y,
                            void* partials, void* dot, int n, int grid,
                            void* stream) {
  using namespace its;
  if (nd < 1 || nd > kMaxDiags || grid < 1 || n < 1) return -1;
  DiaArgs a = {};
  a.nd = nd;
  for (int k = 0; k < nd; ++k) {
    a.off[k] = offs[k];
    a.diag[k] = diags[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag_dtype == 0) {
    launch<float>(with_dot, a, x, u, y, partials, n, grid, s);
  } else if (diag_dtype == 1) {
    launch<__nv_bfloat16>(with_dot, a, x, u, y, partials, n, grid, s);
  } else if (diag_dtype == 2) {
    launch<int8_t>(with_dot, a, x, u, y, partials, n, grid, s);
  } else {
    return -1;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_dot) return static_cast<int>(err);
  reduce_partials<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partials), grid, static_cast<float*>(dot));
  return static_cast<int>(cudaGetLastError());
}
