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
// bf16; the arithmetic is f32 on a working vector y.  k and do are read from
// device memory, so GMRES issues the step with no host read.
//
// Bound on an H100 SXM (3.35 TB/s) at k = 19, n = 216^3: read w and 20 panel
// rows and write row k + 1 once: 4n + 20 es n + es n bytes for a panel of
// es-byte entries, 88n (887 MB, 265 us) in f32 and 46n (464 MB, 138 us) in
// bf16.
//
// Design.  The TPU kernel keeps w resident in VMEM for the whole sweep and
// its row-buffer sweep reads each row once for the dot and the axpy.  An
// f32 w at 216^3 is 40.3 MB: far beyond one SM, but not beyond the card,
// whose 132 SMs hold 132 x 256 KB of registers and 132 x 227 KB of shared
// memory.  So one cooperative launch runs one block on each SM, and each
// block keeps its contiguous chunk of w (305 KB at 216^3) in registers and
// shared memory for the whole sweep (panel_mgs.cuh).  The k + 2 passes move
// only panel rows, streamed tile by tile through a ring in shared memory
// with cp.async, so the loads in flight hold no registers; each row's chunk
// is read once for its dot and once more for its axpy, from L2 where it
// stayed (bf16) or mostly from device memory (f32: two rows exceed L2).
// w is read once and row k + 1 written once.  Beyond what the card holds
// (a large n, or a grid cut short) the rest of the chunk goes through the
// scratch y in device memory, as the whole of w once did.
#include "panel_mgs.cuh"

namespace its {

// The vector panel_mgs orthogonalises: w, read once (streaming) into the
// block's three tiers; the shared and spill tiers first, while the
// register tier holds nothing yet and leaves the registers to loads.
struct FillW {
  const float* w;
  __device__ __forceinline__ void operator()(float (&reg)[kRowRegs], float* sy,
                                             float* gy, const Chunk& ch) const {
    constexpr int RT = kRowRegs * kThreads;
    const int t = threadIdx.x;
    const float* wb = w + ch.lo;
#pragma unroll 8
    for (int e = RT + t; e < ch.send; e += kThreads) sy[e - RT] = load_once(wb + e);
#pragma unroll 8
    for (int e = RT + ch.S + t; e < ch.len; e += kThreads) gy[e] = load_once(wb + e);
#pragma unroll
    for (int r = 0; r < kRowRegs; ++r) {
      const int e = r * kThreads + t;
      reg[r] = load_once(wb + e, e < ch.len);
    }
  }
};

template <typename TV>
__global__ void __launch_bounds__(kThreads, 1)
panel_mgs_kernel(TV* V, const float* __restrict__ w, float* y,
                 float* partials, float* h, float* nrm, const int* kp,
                 const int* dop, int n, int m1, int c, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int k = max(0, min(*kp, m1 - 2));
  const float scale = *dop != 0 ? 1.0f : 0.0f;
  mgs_sweep<TV>(grid, V, FillW{w}, y, partials, h, nrm, n, m1, k, scale,
                V + static_cast<size_t>(k + 1) * n, c, S, smem);
}

template <typename TV>
int launch(void* V, const void* w, void* y, void* partials, void* h,
           void* nrm, const void* kp, const void* dop, int n, int m1,
           int grid, int c, int S, cudaStream_t s) {
  TV* v_ = static_cast<TV*>(V);
  const float* w_ = static_cast<const float*>(w);
  float* y_ = static_cast<float*>(y);
  float* p_ = static_cast<float*>(partials);
  float* h_ = static_cast<float*>(h);
  float* nrm_ = static_cast<float*>(nrm);
  const int* k_ = static_cast<const int*>(kp);
  const int* do_ = static_cast<const int*>(dop);
  void* args[] = {&v_, &w_, &y_, &p_, &h_, &nrm_, &k_, &do_, &n, &m1,
                  &c, &S};
  const int smem = ring_bytes<TV>() + S * static_cast<int>(sizeof(float));
  return launch_sweep(reinterpret_cast<const void*>(panel_mgs_kernel<TV>),
                      grid, smem, args, s);
}

}  // namespace its

// The dynamic shared memory a block of `its_panel_mgs` may take on the
// current device (dtype as below), written to *bytes; returns a CUDA error
// code, or -1 for bad arguments.
extern "C" int its_panel_mgs_smem(int dtype, int* bytes) {
  using namespace its;
  if (dtype == 0) return dynamic_smem_limit(panel_mgs_kernel<float>, bytes);
  if (dtype == 1) {
    return dynamic_smem_limit(panel_mgs_kernel<__nv_bfloat16>, bytes);
  }
  return -1;
}

// The grid `its_panel_mgs` takes for (dtype, n), one block on each SM, with
// `smem` bytes of dynamic shared memory a block at most: written to *grid;
// returns a CUDA error code, -1 for bad arguments, or -2 if such a block
// does not fit on an SM.
extern "C" int its_panel_mgs_grid(int dtype, int n, int smem, int* grid) {
  using namespace its;
  if (n < 1 || smem < 0) return -1;
  if (dtype == 0) {
    return cooperative_grid(panel_mgs_kernel<float>, n, smem, grid);
  }
  if (dtype == 1) {
    return cooperative_grid(panel_mgs_kernel<__nv_bfloat16>, n, smem, grid);
  }
  return -1;
}

// dtype: 0 = float32, 1 = bfloat16 (the panel V, (m1, n) row-major, m1 >= 2).
// w and the scratch y are f32 (n,); h f32 (m1,); nrm one f32; k and do one
// int32 each, on the device.  `partials` holds (m1 + 1) * grid floats, grid
// from its_panel_mgs_grid (or fewer blocks).  The residency plan of
// ops/cuda_mgs.py: chunk c entries a block, of which kRowRegs a thread in
// registers and S in shared memory.  Writes panel row k + 1.  Returns the
// CUDA error code of the launch (0 = success), or -1 for bad arguments.
extern "C" int its_panel_mgs(int dtype, void* V, const void* w, void* y,
                             void* partials, void* h, void* nrm,
                             const void* k, const void* dop, int n, int m1,
                             int grid, int c, int S, void* stream) {
  using namespace its;
  if (n < 1 || m1 < 2 || grid < 1 || c < 1 || S < 0 ||
      static_cast<long long>(grid) * c < n) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(V, w, y, partials, h, nrm, k, dop, n, m1, grid, c,
                         S, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(V, w, y, partials, h, nrm, k, dop, n, m1,
                                 grid, c, S, s);
  }
  return -1;
}
