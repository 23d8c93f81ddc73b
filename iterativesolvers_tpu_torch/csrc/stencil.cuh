// The stencil row product shared by the stencil kernels: `stencil.cu`
// (stencil_apply) and `arnoldi.cu` (stencil_panel_mv, fused_arnoldi).
//
//     y[i] = center * x[i] + sum_t c_t * x[i + off_t]
//
// where term t counts only where the grid axis it couples stays on the grid,
// pos = (i / stride_t) % extent_t and 0 <= pos + off_t / stride_t < extent_t,
// and where 0 <= i + off_t < n: the same rule as StencilOperator._apply.
//
// Order of the sum: the products are added in ascending offset order, the
// center at offset 0, starting from 0 -- the order in which the DIA kernel
// (dia_spmv.cu) sums a DIAMatrix whose offsets are sorted, as laplace_dia's
// and to_dia's are.  So the matrix-free and the stored Laplacian give the
// same bits, and every kernel that includes this header gives the same bits
// for the same row.  A first loop, over the terms grouped by (stride,
// extent), sets one bit per valid term; a second adds the valid products in
// order.
#pragma once

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

// Row i of the product, in f32, from x stored as T.
template <typename T>
__device__ __forceinline__ float stencil_row(const T* __restrict__ x, int i,
                                             int n, const StencilTerms& t) {
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
  return acc;
}

// Fill `t` from the host arrays of ops/cuda_stencil.py's plan: the `nterms`
// off-diagonal terms as (off, step, stride, extent, bit) arrays, the `nsum`
// products as (sum_off, sum_coeff) in the order they are added, the
// center's at `center_bit`.  Returns false on bad arguments.
inline bool pack_terms(StencilTerms* t, int nterms, const int* off,
                       const int* step, const int* stride, const int* extent,
                       const int* bit, int nsum, int center_bit,
                       const int* sum_off, const float* sum_coeff) {
  if (nterms < 0 || nterms > kMaxTerms || nsum != nterms + 1 ||
      center_bit < 0 || center_bit >= nsum) {
    return false;
  }
  *t = StencilTerms{};
  t->nterms = nterms;
  for (int k = 0; k < nterms; ++k) {
    if (stride[k] <= 0 || extent[k] <= 0 || bit[k] < 0 || bit[k] >= nsum) return false;
    t->off[k] = off[k];
    t->step[k] = step[k];
    t->stride[k] = static_cast<unsigned>(stride[k]);
    t->extent[k] = static_cast<unsigned>(extent[k]);
    t->reuse[k] = k > 0 && stride[k] == stride[k - 1] && extent[k] == extent[k - 1];
    t->bit[k] = bit[k];
  }
  t->nsum = nsum;
  t->center_bit = 1u << center_bit;
  for (int k = 0; k < nsum; ++k) {
    t->sum_off[k] = sum_off[k];
    t->sum_coeff[k] = sum_coeff[k];
  }
  return true;
}

}  // namespace its
