// The GMRES step on a stencil operator straight from the Krylov panel, for
// Hopper (sm_90a): two kernels.
//
// stencil_panel_mv replaces the Pallas TPU kernel `stencil_panel_mv`
// (iterativesolvers_tpu/ops/pallas_arnoldi.py:560): w = A V[k] in f32, from
// panel row k stored as f32 or bf16, k read from device memory.  It is the
// stencil kernel of stencil.cu (stencil.cuh's stencil_kernel: runs of 8
// rows a thread, 16-byte loads and stores, the grid position by
// multiply-high and shift, the same sum order) with an f32 output and the
// input at the row's offset.  Bound on an H100 SXM (3.35 TB/s) at
// n = 216^3: read one row, write w: 8n bytes (80.6 MB, 24.1 us) from an f32
// panel, 6n bytes (60.5 MB, 18.0 us) from bf16.
//
// fused_arnoldi replaces the Pallas TPU kernel `fused_arnoldi`
// (iterativesolvers_tpu/ops/pallas_arnoldi.py:385): in one cooperative
// launch, w = A V[k], MGS of w against rows 0..k, the norm, and the write of
// w / nrm * do as panel row k + 1 in place (a masked step, do = 0, writes
// zeros).  Rows 0..k are only read.  Bound at k = 19: read 20 rows (row k is
// one of them), write one: 84n bytes (846.5 MB, 252.7 us) in f32, 42n bytes
// (423.3 MB, 126.4 us) in bf16.
//
// Design.  The sweep is panel_mgs.cu's (panel_mgs.cuh): one block on each
// SM keeps its contiguous chunk of w on chip, in registers and shared
// memory, for the whole sweep.  Pass 0 computes the stencil of row k for
// the block's own rows (its reads of row k go through L1 and L2) while
// V_0's first tiles stream in, then sums the partials of h_0 = <V_0, w>;
// each later pass moves only panel rows.  The stencil runs before the
// register tier is filled, so that its loads have the registers: the
// register tier's share of w goes once through the scratch y, written and
// read back by the same thread while L2 holds it.  With one block of
// kThreads threads on an SM, too few to hide the grid arithmetic of each
// row (integer divisions in the first design), the stencil reads each
// row's valid terms from a mask of two bytes a row,
// built once per operator by the wrapper, as the TPU kernel read its int8
// mask tiles: 2n bytes more than the bound's.  What the TPU design needed
// and this one does not: the sliding VMEM windows with halo rows and the
// lane rolls of `_flat_shift` (pallas_arnoldi.py:139-164) existed for VMEM
// and Mosaic's (8, 128) tiling; here the panel is flat (m1, n) with no
// padding.
#include "panel_mgs.cuh"
#include "stencil.cuh"

namespace its {

// Row i of the stencil product, as stencil_row (stencil.cuh: the same terms
// in the same order), from the row's valid terms as stencil_row would find
// them, read from a mask (bit b: sum slot b) instead of computed: the
// fused kernel runs few threads an SM, too few to hide row_valid's grid
// arithmetic.  Every slot's load is formed, from a clamped index,
// so no load waits for the mask or stands behind a branch and the
// compiler keeps all the row's loads in flight; an invalid slot adds
// nothing, so the row adds the same values in the same order.
template <typename TV>
__device__ __forceinline__ float stencil_row_masked(const TV* __restrict__ x,
                                                    int i, int n,
                                                    unsigned valid,
                                                    const StencilTerms& t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxSum; ++k) {
    const float xv = to_f32(x[min(max(i + t.sum_off[k], 0), n - 1)]);
    const float sum = fmaf(t.sum_coeff[k], xv, acc);
    acc = (valid >> k) & 1u ? sum : acc;
  }
  return acc;
}

// The vector fused_arnoldi orthogonalises: w = A x for the block's rows,
// into its three tiers.  The stencil runs while the register tier holds
// nothing yet, so that its loads have the registers: the register tier's
// rows go first to the scratch y at their own offsets (which the spill tier
// leaves unused; L2 keeps them), and each thread then loads its own back
// into registers, one predicated load an entry.
template <typename TV>
struct FillStencil {
  const TV* x;
  int n;
  const unsigned short* masks;
  const StencilTerms& t;
  __device__ __forceinline__ float row(int i) const {
    return stencil_row_masked(x, i, n, __ldcs(masks + i), t);
  }
  __device__ __forceinline__ void operator()(float (&reg)[kRowRegs], float* sy,
                                             float* gy, const Chunk& ch) const {
    constexpr int RT = kRowRegs * kThreads;
    const int tid = threadIdx.x;
    const int rend = min(ch.len, RT);
#pragma unroll 8
    for (int e = tid; e < rend; e += kThreads) gy[e] = row(ch.lo + e);
#pragma unroll 8
    for (int e = RT + tid; e < ch.send; e += kThreads) sy[e - RT] = row(ch.lo + e);
#pragma unroll 8
    for (int e = RT + ch.S + tid; e < ch.len; e += kThreads) gy[e] = row(ch.lo + e);
#pragma unroll
    for (int r = 0; r < kRowRegs; ++r) {
      const int e = r * kThreads + tid;
      reg[r] = load_once(gy + e, e < ch.len);
    }
  }
};

template <typename TV>
__global__ void __launch_bounds__(kThreads, 1)
fused_arnoldi_kernel(TV* V, float* y, float* partials, float* h, float* nrm,
                     const int* kp, const int* dop,
                     const unsigned short* masks, int n, int m1, int c, int S,
                     StencilTerms t) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int k = max(0, min(*kp, m1 - 2));
  const float scale = *dop != 0 ? 1.0f : 0.0f;
  const FillStencil<TV> fill{V + static_cast<size_t>(k) * n, n, masks, t};
  mgs_sweep<TV>(grid, V, fill, y, partials, h, nrm, n, m1, k, scale,
                V + static_cast<size_t>(k + 1) * n, c, S, smem);
}

template <typename TV>
int launch_fused(void* V, void* y, void* partials, void* h, void* nrm,
                 const void* kp, const void* dop, const void* masks, int n,
                 int m1, int grid, int c, int S, StencilTerms t,
                 cudaStream_t s) {
  TV* v_ = static_cast<TV*>(V);
  float* y_ = static_cast<float*>(y);
  float* p_ = static_cast<float*>(partials);
  float* h_ = static_cast<float*>(h);
  float* nrm_ = static_cast<float*>(nrm);
  const int* k_ = static_cast<const int*>(kp);
  const int* do_ = static_cast<const int*>(dop);
  const unsigned short* m_ = static_cast<const unsigned short*>(masks);
  void* args[] = {&v_, &y_, &p_, &h_, &nrm_, &k_, &do_, &m_, &n, &m1, &c,
                  &S, &t};
  const int smem = ring_bytes<TV>() + S * static_cast<int>(sizeof(float));
  return launch_sweep(
      reinterpret_cast<const void*>(fused_arnoldi_kernel<TV>), grid, smem,
      args, s);
}

template <typename TV>
const void* panel_mv_kernel() {
  return plain_stencil_kernel<TV, float, false>();
}

const void* panel_mv_kernel(int dtype) {
  if (dtype == 0) return panel_mv_kernel<float>();
  if (dtype == 1) return panel_mv_kernel<__nv_bfloat16>();
  return nullptr;
}

}  // namespace its

// Blocks of its_stencil_panel_mv's kernel for dtype that one SM holds at
// once, written to *blocks; returns a CUDA error code, or -1 for bad
// arguments.
extern "C" int its_stencil_panel_mv_blocks_per_sm(int dtype, int* blocks) {
  using namespace its;
  const void* k = panel_mv_kernel(dtype);
  return k == nullptr ? -1 : blocks_per_sm(k, blocks);
}

// dtype: 0 = float32, 1 = bfloat16 (the panel V, (m1, n) row-major); w f32
// (n,); k one int32 on the device; vec = 1 when V and w are 16-byte aligned
// (a row k > 0 is checked on the device); `terms`: the StencilTerms that
// stencil.cu's its_stencil_pack_terms packed (the same header, the same
// layout).  Returns the CUDA error code of the launch (0 = success), or -1
// for bad arguments.
extern "C" int its_stencil_panel_mv(int dtype, const void* V, const void* k,
                                    void* w, int n, int m1, int grid, int vec,
                                    const void* terms, void* stream) {
  using namespace its;
  const void* kern = panel_mv_kernel(dtype);
  if (kern == nullptr || n < 1 || m1 < 1 || grid < 1 || terms == nullptr) {
    return -1;
  }
  StencilTerms t = *static_cast<const StencilTerms*>(terms);
  void* V_ = const_cast<void*>(V);
  void* k_ = const_cast<void*>(k);
  void* none = nullptr;
  void* args[] = {&V_, &k_, &m1, &w, &none, &none, &none, &n, &vec, &t};
  return static_cast<int>(cudaLaunchKernel(kern, dim3(grid), dim3(kThreads),
                                           args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// The dynamic shared memory a block of `its_fused_arnoldi` may take on the
// current device, written to *bytes; returns a CUDA error code, or -1 for
// bad arguments.
extern "C" int its_fused_arnoldi_smem(int dtype, int* bytes) {
  using namespace its;
  if (dtype == 0) return dynamic_smem_limit(fused_arnoldi_kernel<float>, bytes);
  if (dtype == 1) {
    return dynamic_smem_limit(fused_arnoldi_kernel<__nv_bfloat16>, bytes);
  }
  return -1;
}

// The grid `its_fused_arnoldi` takes for (dtype, n), one block on each SM,
// with `smem` bytes of dynamic shared memory a block at most: written to
// *grid; returns a CUDA error code, -1 for bad arguments, or -2 if such a
// block does not fit on an SM.
extern "C" int its_fused_arnoldi_grid(int dtype, int n, int smem, int* grid) {
  using namespace its;
  if (n < 1 || smem < 0) return -1;
  if (dtype == 0) {
    return cooperative_grid(fused_arnoldi_kernel<float>, n, smem, grid);
  }
  if (dtype == 1) {
    return cooperative_grid(fused_arnoldi_kernel<__nv_bfloat16>, n, smem,
                            grid);
  }
  return -1;
}

// dtype as above; y f32 (n,) scratch; h f32 (m1,); nrm one f32; k and do one
// int32 each on the device; `masks` (n,) uint16, each row's valid terms as
// stencil_row finds them (bit b: sum slot b, as ops/cuda_arnoldi.py's
// _row_masks builds them); `partials` holds (m1 + 1) * grid floats, grid
// from its_fused_arnoldi_grid; m1 >= 2; the residency plan (c, S) as
// its_panel_mgs takes it; `terms` as its_stencil_panel_mv takes them.
// Writes panel row k + 1.  Returns the CUDA
// error code of the launch (0 = success), or -1 for bad arguments.
extern "C" int its_fused_arnoldi(int dtype, void* V, void* y, void* partials,
                                 void* h, void* nrm, const void* k,
                                 const void* dop, const void* masks, int n,
                                 int m1, int grid, int c, int S,
                                 const void* terms, void* stream) {
  using namespace its;
  if (n < 1 || m1 < 2 || grid < 1 || c < 1 || S < 0 ||
      static_cast<long long>(grid) * c < n || terms == nullptr) {
    return -1;
  }
  const StencilTerms t = *static_cast<const StencilTerms*>(terms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fused<float>(V, y, partials, h, nrm, k, dop, masks, n, m1,
                               grid, c, S, t, s);
  }
  if (dtype == 1) {
    return launch_fused<__nv_bfloat16>(V, y, partials, h, nrm, k, dop, masks,
                                       n, m1, grid, c, S, t, s);
  }
  return -1;
}
