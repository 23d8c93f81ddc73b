// Red-black IC(0) apply z = M^{-1} x on a constant-coefficient stencil, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package applies RedBlackICPreconditioner
// by XLA fusions of `_shift_sum` (iterativesolvers_tpu/operators/
// preconditioners.py), and the port ran the same apply as eager torch, one
// addcmul pass over an accumulator a term (operators/preconditioners.py
// shift_sum) with the where and scale passes around them: ~2 GB moved an
// apply at 216^3, 1.24 ms, 72% of a PCG step on the 7-point Laplacian.  This
// kernel takes the preconditioner that RedBlackICPreconditioner.from_stencil
// builds from an f32 stencil on a nested grid (strides 1, e0, e0 e1, ...;
// n their product), applied to a 1-D f32 x: every coefficient is a scalar,
// and every valid term couples a red row with a black one.
//
// With a_t the coefficient of term t = (o_t, stride, extent), m_t(i) its grid
// mask (stencil.cuh's rule), s_r = 1/sqrt(center) and s_b the black pivot's
// 1/sqrt:
//     pass 0:  w_r = x_r s_r
//              w_b = ((x_b - sum_t m_t a_t ((x s_r) s_r)[b + o_t]) s_b) s_b
//     pass 1:  z_r = (w_r - s_r sum_t m_t a_t w[r + o_t]) s_r
//              z_b = w_b
// the L solve and then the L^T solve of the eager apply
// (RedBlackICPreconditioner._apply), operation for operation and rounded at
// the same places: a term adds its product by one fused multiply-add, in the
// terms' order, as torch's addcmul does on the card, and every other product
// and difference is rounded on its own (__fmul_rn, __fsub_rn: nothing else
// is contracted).  At 216^3 z has the eager apply's bits.
//
// Bound on an H100 SXM (3.35 TB/s): an apply has to read x and write z,
// 8 bytes a row; at n = 216^3 that is 80.6 MB, 24.1 us.  This design moves
// 16 bytes a row (pass 0 reads x and writes w, pass 1 reads w and writes z):
// 161 MB, 48.1 us, less what of w the 50 MB L2 still holds when pass 1
// reads it.  The neighbours' reads hit L1/L2, as in the stencil kernel.
//
// Design.  No coefficient or mask stream: a row's valid terms come from its
// grid position, by stencil.cuh's row_valid / run_valid, with term t's bit at
// its place in the terms' order; its colour is the parity of the sum of its
// grid positions (black_of), which steps by one across a run that crosses
// no grid line.  The coefficients come by value.  The black scale s_b
// depends only on which terms are valid: a table of 2^T entries indexed by
// those bits, with s_r after them, that the wrapper builds on the device
// with the torch arithmetic that builds s_inv, so each entry has its bits;
// a block copies it to shared memory.  So pass 0 reads only x and pass 1
// only w.  Each pass is shaped as the stencil kernel: runs of kStencilRun = 8
// rows a thread, 16-byte loads of each shifted window (common.cuh's
// load_window) and 16-byte stores, one load a row from a clamped index at
// the ends and for an unaligned vector, a grid-stride loop over as many
// blocks as the SMs hold.  Two launches, not one: a single launch would need
// each red row's black neighbours' w, each made from the x around it, a
// two-deep halo of x (a 2.5-D tile in shared memory would reach the 8-byte
// bound); the two passes keep the stencil kernel's simple shape at twice
// the bytes.
#include "stencil.cuh"

namespace its {

// The terms of an apply.  `t` holds them grouped by (stride, extent) for
// row_valid / run_valid, term k setting bit `t.bit[k]`, its place in the
// terms' order, and the center bit 1 << nterms; `off` and `coeff` hold them
// in the terms' order, the order of the sum.
struct RbicTerms {
  StencilTerms t;
  int off[kMaxTerms];
  float coeff[kMaxTerms];
};

// The scale table: 2^T black scales by validity bits, then s_r.
constexpr int kMaxScales = (1 << kMaxTerms) + 1;

// 1 for a black row, 0 for a red one: the parity of the sum of row i's grid
// positions, one per (stride, extent) group.
__device__ __forceinline__ unsigned black_of(int i, const StencilTerms& t) {
  unsigned sum = 0;
#pragma unroll
  for (int k = 0; k < kMaxTerms; ++k) {
    if (k < t.nterms && !t.reuse[k]) {
      const unsigned q = fast_div(static_cast<unsigned>(i), t.smul[k], t.sshr[k]);
      sum += q - fast_div(q, t.emul[k], t.eshr[k]) * t.extent[k];
    }
  }
  return sum & 1u;
}

// What a term reads at a neighbour: pass 0 the eager apply's u = (x s_r) s_r
// (a black row's valid neighbours are red), pass 1 w itself.
template <int kPass>
__device__ __forceinline__ float operand(float v, float sr) {
  return kPass == 0 ? __fmul_rn(__fmul_rn(v, sr), sr) : v;
}

// The row's value from its own value c (x in pass 0, w in pass 1) and the
// sum acc of its valid terms.
template <int kPass>
__device__ __forceinline__ float finish_row(float c, float acc, unsigned black,
                                            unsigned valid, unsigned code_mask,
                                            const float* scale, float sr) {
  if (kPass == 0) {
    if (!black) return __fmul_rn(c, sr);
    const float sb = scale[valid & code_mask];
    return __fmul_rn(__fmul_rn(__fsub_rn(c, acc), sb), sb);
  }
  return black ? c : __fmul_rn(__fsub_rn(c, __fmul_rn(sr, acc)), sr);
}

// Pass kPass of the apply: `in` is x (pass 0) or w (pass 1), `out` w or z.
// vec = 1 when in and out are 16-byte aligned.  `scales`: the table above,
// on the device.
template <int kPass>
__global__ void __launch_bounds__(kThreads, 1)
rbic_apply_kernel(const float* __restrict__ in, float* __restrict__ out,
                  const float* __restrict__ scales, int n, int vec,
                  RbicTerms r) {
  constexpr int R = kStencilRun;
  constexpr int V = kVecOf<float>;
  __shared__ float scale[kMaxScales];
  const StencilTerms& t = r.t;
  const int nt = t.nterms;
  const unsigned code_mask = (1u << nt) - 1u;
  for (int k = threadIdx.x; k <= (1 << nt); k += blockDim.x) scale[k] = scales[k];
  __syncthreads();
  const float sr = scale[1 << nt];
  const int runs = n / R + (n % R != 0);
  for (int run = blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += gridDim.x * blockDim.x) {
    const int r0 = run * R;
    if (vec && r0 + R <= n) {
      const bool interior = r0 + t.min_off >= V && r0 + R + V + t.max_off <= n;
      unsigned valid[R], black[R];
      if (interior && run_valid<R>(r0, t, valid)) {
        // the run stays on one line of the stride-1 axis
        const unsigned b0 = black_of(r0, t);
#pragma unroll
        for (int e = 0; e < R; ++e) black[e] = b0 ^ static_cast<unsigned>(e & 1);
      } else {
#pragma unroll
        for (int e = 0; e < R; ++e) {
          valid[e] = row_valid(r0 + e, n, t);
          black[e] = black_of(r0 + e, t);
        }
      }
      float c[R], acc[R];
      load_window<float, R>(in, r0, n, c);
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxTerms; ++k) {
        if (k < nt) {
          // a window that leaves [0, n) reads clamped rows, whose bits
          // row_valid has cleared
          float w[R];
          load_window<float, R>(in, r0 + r.off[k], n, w);
          const float a = r.coeff[k];
#pragma unroll
          for (int e = 0; e < R; ++e) {
            const float sum = fmaf(a, operand<kPass>(w[e], sr), acc[e]);
            acc[e] = (valid[e] >> k) & 1u ? sum : acc[e];
          }
        }
      }
      float o[R];
#pragma unroll
      for (int e = 0; e < R; ++e) {
        o[e] = finish_row<kPass>(c[e], acc[e], black[e], valid[e], code_mask,
                                 scale, sr);
      }
#pragma unroll
      for (int p = 0; p < R; p += V) store_vec<float>(out + r0 + p, o + p);
    } else {
      // the rare rows: the tail past the last whole run, an unaligned vector
#pragma unroll 1
      for (int e = 0; e < R; ++e) {
        const int i = r0 + e;
        if (i < n) {
          const unsigned valid = row_valid(i, n, t);
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < kMaxTerms; ++k) {
            if (k < nt) {
              const float v = in[min(max(i + r.off[k], 0), n - 1)];
              const float sum = fmaf(r.coeff[k], operand<kPass>(v, sr), acc);
              acc = (valid >> k) & 1u ? sum : acc;
            }
          }
          out[i] = finish_row<kPass>(in[i], acc, black_of(i, t), valid,
                                     code_mask, scale, sr);
        }
      }
    }
  }
}

const void* kernel_of(int pass) {
  if (pass == 0) return reinterpret_cast<const void*>(rbic_apply_kernel<0>);
  if (pass == 1) return reinterpret_cast<const void*>(rbic_apply_kernel<1>);
  return nullptr;
}

}  // namespace its

// Blocks of pass `pass`'s kernel that one SM holds at once, written to
// *blocks; returns a CUDA error code, or -1 for bad arguments.
extern "C" int its_rbic_blocks_per_sm(int pass, int* blocks) {
  const void* k = its::kernel_of(pass);
  return k == nullptr ? -1 : its::blocks_per_sm(k, blocks);
}

// The size of RbicTerms, for the host buffer that its_rbic_pack_terms fills.
extern "C" int its_rbic_terms_bytes() {
  return static_cast<int>(sizeof(its::RbicTerms));
}

// Pack the `nterms` terms into `out` (a host buffer of its_rbic_terms_bytes()
// bytes), once per preconditioner: `t` by stencil.cuh's pack_terms from its
// arguments (`off` to `sum_coeff`: the terms grouped by (stride, extent),
// term k setting bit `bit[k]`, its place in the terms' order, the center's
// bit `center_bit` = nterms; the kernel reads only the first and last of
// `sum_off`), `off` and `coeff` from `term_off` and `term_coeff`, in the
// terms' order.  Returns 0, or -1 for bad arguments.
extern "C" int its_rbic_pack_terms(void* out, int nterms, const int* off,
                                   const int* step, const int* stride,
                                   const int* extent, const unsigned* magic,
                                   const int* bit, int nsum, int center_bit,
                                   const int* sum_off, const float* sum_coeff,
                                   const int* term_off,
                                   const float* term_coeff) {
  using namespace its;
  if (out == nullptr || nterms < 1 || center_bit != nterms) return -1;
  RbicTerms r{};
  if (!pack_terms(&r.t, nterms, off, step, stride, extent, magic, bit, nsum,
                  center_bit, sum_off, sum_coeff)) {
    return -1;
  }
  // each term's bit once: the scale table's index is the valid terms' bits
  unsigned seen = 0;
  for (int k = 0; k < nterms; ++k) seen |= 1u << bit[k];
  if (seen != (1u << nterms) - 1u) return -1;
  for (int j = 0; j < nterms; ++j) {
    r.off[j] = term_off[j];
    r.coeff[j] = term_coeff[j];
  }
  *static_cast<RbicTerms*>(out) = r;
  return 0;
}

// z = M^{-1} x in two launches on `stream`: pass 0 from x into w, pass 1 from
// w into z, each on its own grid (grid0, grid1) and vector flag (vec0: x and
// w 16-byte aligned, vec1: w and z).  `scales`: the device table of
// 2^nterms + 1 floats; `terms`: the RbicTerms its_rbic_pack_terms packed.
// Each launch is checked (cudaLaunchKernel, then cudaGetLastError); returns
// the first CUDA error code (0 = success), or -1 for bad arguments.
extern "C" int its_rbic_apply(const void* x, void* w, void* z,
                              const void* scales, int n, int grid0, int grid1,
                              int vec0, int vec1, const void* terms,
                              void* stream) {
  using namespace its;
  if (x == nullptr || w == nullptr || z == nullptr || scales == nullptr ||
      terms == nullptr || n < 1 || grid0 < 1 || grid1 < 1) {
    return -1;
  }
  RbicTerms r = *static_cast<const RbicTerms*>(terms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const float* in0 = static_cast<const float*>(x);
  float* out0 = static_cast<float*>(w);
  const float* in1 = out0;
  float* out1 = static_cast<float*>(z);
  void* args0[] = {&in0, &out0, &sc, &n, &vec0, &r};
  cudaError_t err = cudaLaunchKernel(kernel_of(0), dim3(grid0), dim3(kThreads),
                                     args0, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args1[] = {&in1, &out1, &sc, &n, &vec1, &r};
  err = cudaLaunchKernel(kernel_of(1), dim3(grid1), dim3(kThreads), args1, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
