// Panel modified Gram-Schmidt with normalisation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `panel_mgs`
// (iterativesolvers_tpu/ops/pallas_mgs.py:294): its two-pass chunk sweep
// `_kernel` (:115) and its single-pass row-buffer sweep `_kernel_rowbuf`
// (:186), which compute the same function.  For j = 0..k in order,
//     h_j = <V_j, w>,   w -= h_j V_j          (MGS, not CGS)
// then nrm = |w|, h_j = 0 for j > k, and w / nrm * do is written in V's
// dtype as panel row k + 1 (GMRES's step: a masked step, do = 0, writes
// zeros, as the fused TPU kernel does), so that
// w_in = sum_j h_j V_j + nrm * V_{k+1}.  The panel V is (m1, n), f32 or
// bf16; the arithmetic is f32, with an f32 scratch vector y for the working
// w.  k and do are read from device memory, so GMRES issues the step with
// no host read.
//
// Bound on an H100 SXM (3.35 TB/s) at k = 19, n = 216^3: read w and 20 panel
// rows and write row k + 1 once: 4n + 20 es n + es n bytes for a panel of
// es-byte entries, 88n (887 MB, 265 us) in f32 and 46n (464 MB, 138 us) in
// bf16.
//
// Design.  At 216^3 an f32 w is 40.3 MB, far beyond one SM's 227 KB, so the
// TPU's VMEM-resident w does not carry over: w makes a round trip through
// device memory (and the 50 MB L2) in every pass.  One cooperative launch
// (cudaLaunchCooperativeKernel) of as many blocks as fit on the card at
// once takes the place of the TPU's sequential grid; grid.sync() falls
// between a row's dot and its axpy, and the axpy of row j shares its pass
// with the dot of row j + 1 (panel_mgs.cuh).  So the sweep makes k + 3
// passes: each reads V_j, V_{j+1} and w and writes w, 16n bytes in f32,
// about 3.6x the bound at k = 19.  Rows past k are never read.
#include "panel_mgs.cuh"

namespace its {

template <typename TV>
__global__ void __launch_bounds__(kThreads)
panel_mgs_kernel(TV* V, const float* w, float* y, float* partials, float* h,
                 float* nrm, const int* kp, const int* dop, int n, int m1) {
  cg::grid_group grid = cg::this_grid();
  const int k = max(0, min(*kp, m1 - 2));
  const int step = gridDim.x * blockDim.x;
  float acc = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    acc = fmaf(to_f32(V[i]), w[i], acc);
  }
  write_partial(partials, acc);
  grid.sync();
  const float scale = *dop != 0 ? 1.0f : 0.0f;
  mgs_sweep<TV>(grid, V, w, y, partials, h, nrm, n, m1, k, scale,
                    V + static_cast<size_t>(k + 1) * n);
}

template <typename TV>
int launch(void* V, const void* w, void* y, void* partials, void* h,
           void* nrm, const void* kp, const void* dop, int n, int m1,
           int grid, cudaStream_t s) {
  TV* v_ = static_cast<TV*>(V);
  const float* w_ = static_cast<const float*>(w);
  float* y_ = static_cast<float*>(y);
  float* p_ = static_cast<float*>(partials);
  float* h_ = static_cast<float*>(h);
  float* nrm_ = static_cast<float*>(nrm);
  const int* k_ = static_cast<const int*>(kp);
  const int* do_ = static_cast<const int*>(dop);
  void* args[] = {&v_, &w_, &y_, &p_, &h_, &nrm_, &k_, &do_, &n, &m1};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(panel_mgs_kernel<TV>), dim3(grid),
      dim3(kThreads), args, 0, s));
}

}  // namespace its

// The grid `its_panel_mgs` takes for (dtype, n): written to *grid; returns
// a CUDA error code, or -1 for bad arguments.
extern "C" int its_panel_mgs_grid(int dtype, int n, int* grid) {
  using namespace its;
  if (n < 1) return -1;
  if (dtype == 0) return cooperative_grid(panel_mgs_kernel<float>, n, grid);
  if (dtype == 1) {
    return cooperative_grid(panel_mgs_kernel<__nv_bfloat16>, n, grid);
  }
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (the panel V, (m1, n) row-major, m1 >= 2).
// w and the scratch y are f32 (n,); h f32 (m1,); nrm one f32; k and do one
// int32 each, on the device.  `partials` holds (m1 + 1) * grid floats, grid
// from its_panel_mgs_grid (or fewer blocks).  Writes panel row k + 1.
// Returns the CUDA error code of the launch (0 = success), or -1 for bad
// arguments.
extern "C" int its_panel_mgs(int dtype, void* V, const void* w, void* y,
                             void* partials, void* h, void* nrm,
                             const void* k, const void* dop, int n, int m1,
                             int grid, void* stream) {
  using namespace its;
  if (n < 1 || m1 < 2 || grid < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(V, w, y, partials, h, nrm, k, dop, n, m1, grid, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(V, w, y, partials, h, nrm, k, dop, n, m1,
                                 grid, s);
  }
  return -1;
}
