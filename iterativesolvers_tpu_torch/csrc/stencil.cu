// Matrix-free constant-coefficient stencil SpMV with an optional fused
// <x, Ax>, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stencil_apply`
// (iterativesolvers_tpu/ops/pallas_stencil.py:230).  It computes
//     y[i] = center * x[i] + sum_t c_t * x[i + off_t]
// with the masks and the sum order of stencil.cuh.  With the dot it also
// gives <x, y> in f32, summed from the y it stored.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel has to read x once and write y
// once, 8 bytes a row in f32; at n = 216^3 that is 80.6 MB, 24.1 us.  The
// neighbours' reads hit L1/L2, since a block's rows and their +-1, +-side and
// +-side^2 neighbours are loaded by nearby blocks in the same window of
// time.  At 8 bytes a row the card moves a row in ~2.4 ps, so the row's
// instructions, not its bytes, set the time unless they stay near 50 a row.
//
// Design (stencil.cuh's stencil_kernel, also the kernel of
// stencil_panel_mv in arnoldi.cu).  A thread takes a run of 8 rows: the
// center run is two aligned 16-byte loads of f32 x or one of bf16, each
// shifted window one more (the shift a choice of registers, the extra
// vector an L1 hit), and y goes out as 16-byte stores.  The grid positions
// are found once for the run, by a multiply-high and a shift with host
// constants instead of a division and a modulo by runtime values (three of
// each a row on the 3-D Laplacian in the first design), and stepped across
// its rows; a run that crosses a grid line, or lies at an end of x, finds
// them row by row the same way.  Each row's valid terms are set as bits,
// and an invalid product is dropped by a select, so no load stands behind
// a branch.  Runs whose window leaves [0, n), the tail past the last
// whole run, and an x that is not 16-byte aligned take one load a row from a
// clamped index, in the same launch.  The dot is finished in the same
// launch: the block that finishes last sums the blocks' partials
// (common.cuh's finish_dot) in an order fixed by n and the grid, the same
// bits on every run.  The grid is as many blocks as the SMs hold, with
// the dot as without it.
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
// written at its length n.
#include "stencil.cuh"

namespace its {

template <typename T>
const void* kernel_of(int with_dot) {
  return with_dot ? reinterpret_cast<const void*>(stencil_kernel<T, T, true>)
                  : reinterpret_cast<const void*>(stencil_kernel<T, T, false>);
}

const void* kernel_of(int dtype, int with_dot) {
  if (dtype == 0) return kernel_of<float>(with_dot);
  if (dtype == 1) return kernel_of<__nv_bfloat16>(with_dot);
  return nullptr;
}

}  // namespace its

// Blocks of its_stencil_apply's kernel for (dtype, with_dot) that one SM
// holds at once, written to *blocks; returns a CUDA error code, or -1 for
// bad arguments.
extern "C" int its_stencil_blocks_per_sm(int dtype, int with_dot,
                                         int* blocks) {
  using namespace its;
  const void* k = kernel_of(dtype, with_dot);
  return k == nullptr ? -1 : blocks_per_sm(k, blocks);
}

// The size of stencil.cuh's StencilTerms, for the host buffer that
// its_stencil_pack_terms fills.
extern "C" int its_stencil_terms_bytes() {
  return static_cast<int>(sizeof(its::StencilTerms));
}

// Pack the terms, as stencil.cuh's pack_terms takes them, into `out` (a host
// buffer of its_stencil_terms_bytes() bytes): once per stencil, so that a
// launch passes one pointer.  Returns 0, or -1 for bad arguments.
extern "C" int its_stencil_pack_terms(void* out, int nterms, const int* off,
                                      const int* step, const int* stride,
                                      const int* extent, const unsigned* magic,
                                      const int* bit, int nsum, int center_bit,
                                      const int* sum_off,
                                      const float* sum_coeff) {
  return its::pack_terms(static_cast<its::StencilTerms*>(out), nterms, off,
                         step, stride, extent, magic, bit, nsum, center_bit,
                         sum_off, sum_coeff)
             ? 0
             : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y).  vec = 1 when x and y are
// 16-byte aligned.  `terms`: the StencilTerms its_stencil_pack_terms
// packed.  With the dot: `partials` holds `grid` floats, `ticket` one
// unsigned that is 0 between launches (the kernel leaves it 0), `dot` one
// float.  Returns the CUDA error code of the launch (0 = success), or -1
// for bad arguments.
extern "C" int its_stencil_apply(int dtype, int with_dot, const void* x,
                                 void* y, void* partials, void* ticket,
                                 void* dot, int n, int grid, int vec,
                                 const void* terms, void* stream) {
  using namespace its;
  const void* k = kernel_of(dtype, with_dot);
  if (k == nullptr || grid < 1 || n < 1 || terms == nullptr) return -1;
  StencilTerms t = *static_cast<const StencilTerms*>(terms);
  const int* kp = nullptr;
  int m1 = 1;
  void* x_ = const_cast<void*>(x);
  void* args[] = {&x_, &kp, &m1, &y, &partials, &ticket, &dot, &n, &vec, &t};
  return static_cast<int>(cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args,
                                           0, static_cast<cudaStream_t>(stream)));
}
