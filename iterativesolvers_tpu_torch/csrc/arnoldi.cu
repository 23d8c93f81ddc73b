// The GMRES step on a stencil operator straight from the Krylov panel, for
// Hopper (sm_90a): two kernels.
//
// stencil_panel_mv replaces the Pallas TPU kernel `stencil_panel_mv`
// (iterativesolvers_tpu/ops/pallas_arnoldi.py:560): w = A V[k] in f32, from
// panel row k stored as f32 or bf16, k read from device memory.  It is the
// stencil kernel of stencil.cu (stencil.cuh, the same sum order) with an f32
// output and the input at the row's offset.  Bound on an H100 SXM
// (3.35 TB/s) at n = 216^3: read one row, write w: 8n bytes (80.6 MB,
// 24.1 us) from an f32 panel, 6n bytes (60.5 MB, 18.0 us) from bf16.
//
// fused_arnoldi replaces the Pallas TPU kernel `fused_arnoldi`
// (iterativesolvers_tpu/ops/pallas_arnoldi.py:385): in one cooperative
// launch, w = A V[k] into an f32 scratch vector, MGS of w against rows
// 0..k, the norm, and the write of w / nrm * do as panel row k + 1 in place
// (a masked step, do = 0, writes zeros).  Rows 0..k are only read.  The
// stencil pass also sums the partials of h_0 = <V_0, w>, and the sweep is
// panel_mgs.cu's (panel_mgs.cuh).  Bound at k = 19: read 20 rows (row k is
// one of them), write one: 84n bytes (846.5 MB, 252.7 us) in f32, 42n bytes
// (423.3 MB, 126.4 us) in bf16.
//
// What the TPU design needed and this one does not: the sliding VMEM
// windows with halo rows, the chunk-periodic int8 mask tiles and the lane
// rolls of `_flat_shift` (pallas_arnoldi.py:139-164) existed for VMEM and
// Mosaic's (8, 128) tiling.  Here a thread computes its row's masks from the
// row index, and the panel is flat (m1, n) with no padding.  w makes one
// round trip through device memory, since 40.3 MB of f32 does not fit on
// chip.
#include "panel_mgs.cuh"
#include "stencil.cuh"

namespace its {

template <typename TV>
__global__ void __launch_bounds__(kThreads)
panel_mv_kernel(const TV* __restrict__ V, const int* __restrict__ kp,
                float* __restrict__ w, int n, int m1, StencilTerms t) {
  const int k = max(0, min(*kp, m1 - 1));
  const TV* x = V + static_cast<size_t>(k) * n;
  const int step = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    w[i] = stencil_row(x, i, n, t);
  }
}

template <typename TV>
__global__ void __launch_bounds__(kThreads)
fused_arnoldi_kernel(TV* V, float* y, float* partials, float* h, float* nrm,
                     const int* kp, const int* dop, int n, int m1,
                     StencilTerms t) {
  cg::grid_group grid = cg::this_grid();
  const int k = max(0, min(*kp, m1 - 2));
  const TV* x = V + static_cast<size_t>(k) * n;
  const int step = gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const float wi = stencil_row(x, i, n, t);
    y[i] = wi;
    acc = fmaf(to_f32(V[i]), wi, acc);
  }
  write_partial(partials, acc);
  grid.sync();
  const float scale = *dop != 0 ? 1.0f : 0.0f;
  mgs_sweep<TV>(grid, V, y, y, partials, h, nrm, n, m1, k, scale,
                    V + static_cast<size_t>(k + 1) * n);
}

template <typename TV>
int launch_fused(void* V, void* y, void* partials, void* h, void* nrm,
                 const void* kp, const void* dop, int n, int m1, int grid,
                 StencilTerms t, cudaStream_t s) {
  TV* v_ = static_cast<TV*>(V);
  float* y_ = static_cast<float*>(y);
  float* p_ = static_cast<float*>(partials);
  float* h_ = static_cast<float*>(h);
  float* nrm_ = static_cast<float*>(nrm);
  const int* k_ = static_cast<const int*>(kp);
  const int* do_ = static_cast<const int*>(dop);
  void* args[] = {&v_, &y_, &p_, &h_, &nrm_, &k_, &do_, &n, &m1, &t};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_arnoldi_kernel<TV>), dim3(grid),
      dim3(kThreads), args, 0, s));
}

}  // namespace its

// dtype: 0 = float32, 1 = bfloat16 (the panel V, (m1, n) row-major); w f32
// (n,); k one int32 on the device; the terms as in stencil.cuh's
// pack_terms.  Returns the CUDA error code of the launch (0 = success), or
// -1 for bad arguments.
extern "C" int its_stencil_panel_mv(int dtype, const void* V, const void* k,
                                    void* w, int n, int m1, int grid,
                                    int nterms, const int* off,
                                    const int* step, const int* stride,
                                    const int* extent, const int* bit,
                                    int nsum, int center_bit,
                                    const int* sum_off, const float* sum_coeff,
                                    void* stream) {
  using namespace its;
  StencilTerms t;
  if (n < 1 || m1 < 1 || grid < 1 ||
      !pack_terms(&t, nterms, off, step, stride, extent, bit, nsum,
                  center_bit, sum_off, sum_coeff)) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k_ = static_cast<const int*>(k);
  float* w_ = static_cast<float*>(w);
  if (dtype == 0) {
    panel_mv_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(V), k_, w_, n, m1, t);
  } else if (dtype == 1) {
    panel_mv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(V), k_, w_, n, m1, t);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// The grid `its_fused_arnoldi` takes for (dtype, n), written to *grid;
// returns a CUDA error code, or -1 for bad arguments.
extern "C" int its_fused_arnoldi_grid(int dtype, int n, int* grid) {
  using namespace its;
  if (n < 1) return -1;
  if (dtype == 0) return cooperative_grid(fused_arnoldi_kernel<float>, n, grid);
  if (dtype == 1) {
    return cooperative_grid(fused_arnoldi_kernel<__nv_bfloat16>, n, grid);
  }
  return -1;
}

// dtype as above; y f32 (n,) scratch; h f32 (m1,); nrm one f32; k and do one
// int32 each on the device; `partials` holds (m1 + 1) * grid floats, grid
// from its_fused_arnoldi_grid; m1 >= 2.  Writes panel row k + 1.  Returns
// the CUDA error code of the launch (0 = success), or -1 for bad arguments.
extern "C" int its_fused_arnoldi(int dtype, void* V, void* y, void* partials,
                                 void* h, void* nrm, const void* k,
                                 const void* dop, int n, int m1, int grid,
                                 int nterms, const int* off, const int* step,
                                 const int* stride, const int* extent,
                                 const int* bit, int nsum, int center_bit,
                                 const int* sum_off, const float* sum_coeff,
                                 void* stream) {
  using namespace its;
  StencilTerms t;
  if (n < 1 || m1 < 2 || grid < 1 ||
      !pack_terms(&t, nterms, off, step, stride, extent, bit, nsum,
                  center_bit, sum_off, sum_coeff)) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fused<float>(V, y, partials, h, nrm, k, dop, n, m1, grid, t, s);
  }
  if (dtype == 1) {
    return launch_fused<__nv_bfloat16>(V, y, partials, h, nrm, k, dop, n, m1,
                                       grid, t, s);
  }
  return -1;
}
