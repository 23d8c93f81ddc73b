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
// order, an invalid one dropped by a select.  The division and the modulo
// of the grid position are a multiply-high and a shift each, by constants
// the host computes (ops/cuda_stencil.fast_divisor), and every load reads a
// clamped index, so no load stands behind a branch.
//
// `stencil_kernel` is the one kernel of stencil_apply and stencil_panel_mv:
// runs of kStencilRun = 8 rows a thread, read as aligned 16-byte vectors
// (common.cuh, load_window) and written as 16-byte stores, the valid terms
// found once for a run where it can (run_valid); see stencil.cu for its
// bound and design.
//
// Its halo form (the overload that takes a StencilHalo) computes one rank's
// block of rows of a product whose vector is split over ranks
// (parallel/sharded.py HaloStencilOperator): row i of the block is global
// row base + i of a vector of n_global rows, masked as that row, and a
// column outside the block reads the exchanged planes, `left` below it and
// `right` above it, instead of 0.  The rank's whole product is then one
// launch, its in-launch dot the rank's share of <x, Ax>.
#pragma once

#include "common.cuh"

namespace its {

constexpr int kMaxTerms = 8;             // off-diagonal terms
constexpr int kMaxSum = kMaxTerms + 1;   // and the center
// Rows a thread of stencil_kernel takes: two 16-byte vectors of f32 x, one
// of bf16; 8 divides the sides of the grids users run (216), so a run seldom
// crosses a grid line
constexpr int kStencilRun = 8;

struct StencilTerms {
  // validity of the off-diagonal terms, grouped by (stride, extent)
  int nterms;
  int off[kMaxTerms];
  int step[kMaxTerms];          // off / stride, floor division (host side)
  unsigned stride[kMaxTerms];
  unsigned extent[kMaxTerms];
  unsigned smul[kMaxTerms];     // fast_div constants of stride
  unsigned sshr[kMaxTerms];
  unsigned emul[kMaxTerms];     // and of extent
  unsigned eshr[kMaxTerms];
  int reuse[kMaxTerms];         // same (stride, extent) as the term before
  int bit[kMaxTerms];           // position of the term in the sum below
  // the sum, in ascending offset order; the center's bit is always set
  int nsum;
  unsigned center_bit;
  int sum_off[kMaxSum];
  float sum_coeff[kMaxSum];
  int min_off, max_off;         // sum_off's first and last (sorted)
};

// The halo form's block: rows [base, base + n) of a vector of n_global
// rows, with `halo` rows on each side: left holds global rows
// [base - halo, base), right [base + n, base + n + halo) (the ring's
// neighbours; what wraps around the ends is masked as a column outside
// [0, n_global)).  halo >= 1 and no offset wider than it.  vec = 1 when
// left and right are 16-byte aligned and halo and n whole vectors of T.
template <typename T>
struct StencilHalo {
  const T* left;
  const T* right;
  int halo;
  int base;
  int n_global;
  int vec;
};

// The sum slots that row i adds (bit k: slot k), for 0 <= i < n.
__device__ __forceinline__ unsigned row_valid(int i, int n,
                                              const StencilTerms& t) {
  unsigned valid = t.center_bit;
  unsigned pos = 0;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k < t.nterms) {
      if (!t.reuse[k]) {
        const unsigned q = fast_div(static_cast<unsigned>(i), t.smul[k], t.sshr[k]);
        pos = q - fast_div(q, t.emul[k], t.eshr[k]) * t.extent[k];
      }
      const int p = static_cast<int>(pos) + t.step[k];
      const int j = i + t.off[k];
      const bool ok = static_cast<unsigned>(p) < t.extent[k] &&
                      static_cast<unsigned>(j) < static_cast<unsigned>(n);
      valid |= static_cast<unsigned>(ok) << t.bit[k];
    }
  }
  return valid;
}

// row_valid for the R rows of a run at r0, all in [0, n) and with every
// column in [0, n), computed once for the run: each group's grid position
// at r0 (a multiply-high and a shift), then for the rows either the same
// (stride > 1: the run crosses no multiple of the stride) or stepping by
// one (stride 1: the run crosses no multiple of the extent).  Returns false
// for a run that crosses one; valid[] is then not set.
template <int R>
__device__ __forceinline__ bool run_valid(int r0, const StencilTerms& t,
                                          unsigned (&valid)[R]) {
  unsigned same = t.center_bit;   // slots every row of the run adds
  unsigned step_bits[R];          // slots of stride-1 terms, by row
#pragma unroll
  for (int e = 0; e < R; ++e) step_bits[e] = 0u;
  unsigned pos = 0;
  bool unit = false, ok = true;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k < t.nterms) {
      if (!t.reuse[k]) {
        const unsigned i = static_cast<unsigned>(r0);
        const unsigned q = fast_div(i, t.smul[k], t.sshr[k]);
        pos = q - fast_div(q, t.emul[k], t.eshr[k]) * t.extent[k];
        unit = t.stride[k] == 1u;
        ok = ok && (unit ? pos + R <= t.extent[k]
                         : i - q * t.stride[k] + R <= t.stride[k]);
      }
      const int p = static_cast<int>(pos) + t.step[k];
      if (unit) {
#pragma unroll
        for (int e = 0; e < R; ++e) {
          step_bits[e] |= static_cast<unsigned>(static_cast<unsigned>(p + e) <
                                                t.extent[k]) << t.bit[k];
        }
      } else {
        same |= static_cast<unsigned>(static_cast<unsigned>(p) < t.extent[k])
                << t.bit[k];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < R; ++e) valid[e] = same | step_bits[e];
  return ok;
}

// Row i of the product, in f32, from x stored as T, one load a slot.
template <typename T>
__device__ __forceinline__ float stencil_row(const T* __restrict__ x, int i,
                                             int n, const StencilTerms& t) {
  const unsigned valid = row_valid(i, n, t);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxSum; ++k) {
    if (k < t.nsum) {
      const float xv = to_f32(x[min(max(i + t.sum_off[k], 0), n - 1)]);
      const float sum = fmaf(t.sum_coeff[k], xv, acc);
      acc = (valid >> k) & 1u ? sum : acc;
    }
  }
  return acc;
}

// Column j of the halo form's block (-halo <= j < n + halo): x, or the
// plane below or above it.  Every address is clamped into its array, so no
// load stands behind a branch.
template <typename T>
__device__ __forceinline__ float halo_at(const T* __restrict__ x, int j, int n,
                                         const StencilHalo<T>& h) {
  const T* p = j < 0 ? h.left + max(h.halo + j, 0)
                     : (j < n ? x + j : h.right + min(j - n, h.halo - 1));
  return to_f32(*p);
}

// load_window for the halo form: w[e] = column j0 + e of the block, by
// 16-byte loads where the aligned vectors that cover the window lie inside
// x, inside left or inside right; else one load a column (halo_at).
template <typename T, int R>
__device__ __forceinline__ void load_window_halo(const T* __restrict__ x,
                                                 int j0, int n,
                                                 const StencilHalo<T>& h,
                                                 float (&w)[R]) {
  constexpr int V = kVecOf<T>;
  const int s = j0 & (V - 1);
  const int g0 = j0 - s;
  const int g1 = g0 + R + (s ? V : 0);
  if (g0 >= 0 && g1 <= n) {
    window_vec_at<T, R>(x, g0, s, w);
  } else if (h.vec && g0 >= -h.halo && g1 <= 0) {
    window_vec_at<T, R>(h.left, g0 + h.halo, s, w);
  } else if (h.vec && g0 >= n && g1 <= n + h.halo) {
    window_vec_at<T, R>(h.right, g0 - n, s, w);
  } else {
#pragma unroll
    for (int e = 0; e < R; ++e) w[e] = halo_at(x, j0 + e, n, h);
  }
}

// stencil_row for the halo form: row i of the block, masked as global row
// base + i.
template <typename T>
__device__ __forceinline__ float stencil_row_halo(const T* __restrict__ x,
                                                  int i, int n,
                                                  const StencilTerms& t,
                                                  const StencilHalo<T>& h) {
  const unsigned valid = row_valid(h.base + i, h.n_global, t);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxSum; ++k) {
    if (k < t.nsum) {
      const float sum = fmaf(t.sum_coeff[k], halo_at(x, i + t.sum_off[k], n, h),
                             acc);
      acc = (valid >> k) & 1u ? sum : acc;
    }
  }
  return acc;
}

// The run of R rows at r0 of y = A x: y stored; with kDot also the run's x
// values in px and the stored y values in py (rows past n left as they
// are).  vx: x (and y) 16-byte aligned.  kHalo: the halo form, on the block
// that `h` places (else h is not read).
template <typename TI, typename TO, int R, bool kDot, bool kHalo = false>
__device__ __forceinline__ void stencil_run(const TI* __restrict__ x,
                                            TO* __restrict__ y, int n, int r0,
                                            bool vx, const StencilTerms& t,
                                            float (&px)[R], float (&py)[R],
                                            const StencilHalo<TI>& h = {}) {
  constexpr int V = kVecOf<TI>;
  static_assert(R % V == 0 && R % kVecOf<TO> == 0, "a run is whole vectors");
  if (vx && r0 + R <= n) {
    unsigned valid[R];
    if constexpr (kHalo) {
      // the run's rows as global rows: every column of an interior run
      // lies in [0, n_global)
      const int g0 = h.base + r0;
      const bool interior =
          g0 + t.min_off >= 0 && g0 + R + t.max_off <= h.n_global;
      if (!(interior && run_valid<R>(g0, t, valid))) {
#pragma unroll
        for (int e = 0; e < R; ++e) valid[e] = row_valid(g0 + e, h.n_global, t);
      }
    } else {
      // every window of an interior run lies inside x: no column check
      const bool interior = r0 + t.min_off >= V && r0 + R + V + t.max_off <= n;
      if (!(interior && run_valid<R>(r0, t, valid))) {
#pragma unroll
        for (int e = 0; e < R; ++e) valid[e] = row_valid(r0 + e, n, t);
      }
    }
    float acc[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxSum; ++k) {
      if (k < t.nsum) {
        // a window that leaves [0, n) reads clamped rows, whose slots
        // row_valid has cleared
        float w[R];
        if constexpr (kHalo) {
          load_window_halo<TI, R>(x, r0 + t.sum_off[k], n, h, w);
        } else {
          load_window<TI, R>(x, r0 + t.sum_off[k], n, w);
        }
        const float c = t.sum_coeff[k];
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const float sum = fmaf(c, w[e], acc[e]);
          acc[e] = (valid[e] >> k) & 1u ? sum : acc[e];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < R; p += kVecOf<TO>) store_vec<TO>(y + r0 + p, acc + p);
    if (kDot) {
      window_vec<TI, R, 0>(x, r0, px);   // the center run again, from L1
#pragma unroll
      for (int e = 0; e < R; ++e) py[e] = to_f32(from_f32<TO>(acc[e]));
    }
  } else {
    // the rare rows: the tail past the last whole run, an unaligned x
#pragma unroll 1
    for (int e = 0; e < R; ++e) {
      const int i = r0 + e;
      if (i < n) {
        float acc;
        if constexpr (kHalo) {
          acc = stencil_row_halo(x, i, n, t, h);
        } else {
          acc = stencil_row(x, i, n, t);
        }
        const TO yv = from_f32<TO>(acc);
        y[i] = yv;
        if (kDot) {
          set_at(px, e, to_f32(x[i]));
          set_at(py, e, to_f32(yv));
        }
      }
    }
  }
}

// y = A x for x stored as TI, y as TO; x is `base`, or with kp given, row
// *kp (clamped to [0, m1)) of the (m1, n) panel `base`, read on the device.
// vec = 1 when base and y are 16-byte aligned; a panel row must be too
// (checked here, since k is on the device), else every row takes the
// per-row loads.  Runs of kStencilRun rows a thread, in a grid-stride
// loop.  With kDot also <x, y> in f32 from the y stored: each thread adds
// its rows' products in the order of its loop, and the launch finishes the
// sum (common.cuh's finish_dot).
template <typename TI, typename TO, bool kDot>
// (kThreads, 1): registers up to 255 a thread; with (kThreads) alone ptxas
// held the bf16 instance with the dot to 48 registers and spilled 12 bytes
__global__ void __launch_bounds__(kThreads, 1)
stencil_kernel(const TI* __restrict__ base, const int* __restrict__ kp, int m1,
               TO* __restrict__ y, float* __restrict__ partials,
               unsigned* __restrict__ ticket, float* __restrict__ dot, int n,
               int vec, StencilTerms t) {
  constexpr int R = kStencilRun;
  const TI* x = base;
  if (kp != nullptr) x += static_cast<size_t>(max(0, min(*kp, m1 - 1))) * n;
  const bool vx = vec && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  float px[R], py[R];
  float local = 0.0f;
  const int runs = n / R + (n % R != 0);
  for (int run = blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += gridDim.x * blockDim.x) {
    stencil_run<TI, TO, R, kDot>(x, y, n, run * R, vx, t, px, py);
    if constexpr (kDot) {
      const int cnt = min(R, n - run * R);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        local = e < cnt ? fmaf(px[e], py[e], local) : local;
      }
    }
  }
  if constexpr (kDot) finish_dot(local, partials, ticket, dot);
}

// The halo form of stencil_kernel (see the top of this file): y = rows
// [base, base + n) of A x for the rank's block x and the planes of `h`;
// with kDot also the block's <x, y>.  The same runs, grid-stride loop and
// dot as the one-card form; vec = 1 when x and y are 16-byte aligned.
template <typename TI, typename TO, bool kDot>
__global__ void __launch_bounds__(kThreads, 1)
stencil_kernel(const TI* __restrict__ x, TO* __restrict__ y,
               float* __restrict__ partials, unsigned* __restrict__ ticket,
               float* __restrict__ dot, int n, int vec, StencilTerms t,
               StencilHalo<TI> h) {
  constexpr int R = kStencilRun;
  const bool vx = vec != 0;
  float px[R], py[R];
  float local = 0.0f;
  const int runs = n / R + (n % R != 0);
  for (int run = blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += gridDim.x * blockDim.x) {
    stencil_run<TI, TO, R, kDot, true>(x, y, n, run * R, vx, t, px, py, h);
    if constexpr (kDot) {
      const int cnt = min(R, n - run * R);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        local = e < cnt ? fmaf(px[e], py[e], local) : local;
      }
    }
  }
  if constexpr (kDot) finish_dot(local, partials, ticket, dot);
}

// The address of each form of the overloaded stencil_kernel, for the
// launches and the occupancy queries.
template <typename TI, typename TO, bool kDot>
const void* plain_stencil_kernel() {
  void (*k)(const TI*, const int*, int, TO*, float*, unsigned*, float*, int,
            int, StencilTerms) = stencil_kernel<TI, TO, kDot>;
  return reinterpret_cast<const void*>(k);
}

template <typename TI, typename TO, bool kDot>
const void* halo_stencil_kernel() {
  void (*k)(const TI*, TO*, float*, unsigned*, float*, int, int, StencilTerms,
            StencilHalo<TI>) = stencil_kernel<TI, TO, kDot>;
  return reinterpret_cast<const void*>(k);
}

// Fill `t` from the host arrays of ops/cuda_stencil.py's plan: the `nterms`
// off-diagonal terms as (off, step, stride, extent, bit) arrays and their
// fast_div constants `magic` (smul, sshr, emul, eshr for each term), the
// `nsum` products as (sum_off, sum_coeff) in the order they are added, the
// center's at `center_bit`.  Returns false on bad arguments.
inline bool pack_terms(StencilTerms* t, int nterms, const int* off,
                       const int* step, const int* stride, const int* extent,
                       const unsigned* magic, const int* bit, int nsum,
                       int center_bit, const int* sum_off,
                       const float* sum_coeff) {
  if (nterms < 0 || nterms > kMaxTerms || nsum != nterms + 1 ||
      center_bit < 0 || center_bit >= nsum) {
    return false;
  }
  *t = StencilTerms{};
  t->nterms = nterms;
  for (int k = 0; k < nterms; ++k) {
    if (stride[k] <= 0 || extent[k] <= 0 || bit[k] < 0 || bit[k] >= nsum ||
        magic[4 * k + 1] > 31 || magic[4 * k + 3] > 31) {
      return false;
    }
    t->off[k] = off[k];
    t->step[k] = step[k];
    t->stride[k] = static_cast<unsigned>(stride[k]);
    t->extent[k] = static_cast<unsigned>(extent[k]);
    t->smul[k] = magic[4 * k];
    t->sshr[k] = magic[4 * k + 1];
    t->emul[k] = magic[4 * k + 2];
    t->eshr[k] = magic[4 * k + 3];
    t->reuse[k] = k > 0 && stride[k] == stride[k - 1] && extent[k] == extent[k - 1];
    t->bit[k] = bit[k];
  }
  t->nsum = nsum;
  t->center_bit = 1u << center_bit;
  for (int k = 0; k < nsum; ++k) {
    if (k > 0 && sum_off[k] < sum_off[k - 1]) return false;
    t->sum_off[k] = sum_off[k];
    t->sum_coeff[k] = sum_coeff[k];
  }
  t->min_off = sum_off[0];
  t->max_off = sum_off[nsum - 1];
  return true;
}

}  // namespace its
