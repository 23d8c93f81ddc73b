// DIA SpMV with an optional fused <u, Ax>, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `dia_spmv` / `dia_spmv_dot`
// (iterativesolvers_tpu/ops/pallas_spmv.py:142,149).  It computes
//     y[i] = sum_d diag_d[i] * x[i + off_d],   diag_d[i] = A[i, i + off_d],
// where a column outside [0, n) adds nothing, and with the dot also
// sum_i u[i] y[i] in f32, in the fixed order of common.cuh.  x, u and y
// are f32;
// the diagonals are f32, bf16 or int8 (the streams compress_values makes),
// and each product is promoted to f32 before it is summed, as DIAMatrix.mv
// promotes to result_type(diag, x).
// Each row is an FMA chain from 0 over the diagonals in the order given
// (ascending offsets for laplace_dia and to_dia): the stencil kernel's order,
// so the stored and the matrix-free Laplacian give the same bits.
//
// Bound on an H100 SXM (3.35 TB/s): the kernel has to read every diagonal
// once, x once (u = x in CG) and write y once.  At n = 216^3 with 7
// diagonals: f32 362.8 MB (108.3 us), bf16 221.7 MB (66.2 us), int8
// 151.2 MB (45.1 us).  The diagonals are the dominant stream, so narrowing
// them is the lever, and it pays only if the instructions a row shrink with
// the bytes.
//
// Design.  Each thread takes a run of R consecutive rows, R = 16 bytes of
// one diagonal: 4 rows for f32, 8 for bf16, 16 for int8.  A diagonal's run
// is one 16-byte load with the evict-first hint, those of up to 8
// diagonals issued before the first product waits for one (more diagonals
// go in groups of 8, so that one register plan serves every nd); a stream
// read once, so that x, 40 MB, keeps its place in the 50 MB L2 for its
// seven reads.  bf16 widens by shifts and int8 by a byte permute and an
// add.  x's window for
// offset off is read as aligned 16-byte vectors: R / 4 of them where
// off % 4 == 0 (+-216 and +-46,656 at 216^3), one more where it is not
// (+-1), the shift a choice of registers; the extra vector hits L1.  Runs
// whose window leaves [0, n) (the few at the ends of x) load one row at a
// time from a clamped index, and a column outside [0, n) is dropped by a
// select, not by a branch around its load.  y goes out as 16-byte stores.
// Rows past the last whole run, and operands not 16-byte aligned, take the
// same per-row loads inside the kernel.  With the dot, the run of u is
// read after the products (when u is x, as in CG, the center run again,
// from L1), so that the loop holds the registers it holds without the dot.
// The dot is finished in the same launch: each thread adds its rows'
// products in the order of its grid-stride loop, each block writes its
// partial, and the block that finishes last sums them (common.cuh's
// finish_dot), in an order fixed by n and the grid; the grid is as many
// blocks as the SMs hold, with the dot as without it.
//
// More than kMaxDiags diagonals: the wrapper launches the kernel once for
// each group of kMaxDiags, in order, each launch after the first starting
// every row's chain from the y the one before stored (DiaArgs::accumulate),
// so the rows are the FMA chain one launch over all the diagonals would
// make; only the last launch takes the dot.
//
// What the TPU design needed and this one does not: the halo/padding plan
// (1024-lane aligned windows, padded diagonals); here the ragged edge is
// masked from the index.  The TPU grid summed the dot in SMEM across
// sequential steps; here blocks run in no order, and the fixed order of the
// partials' sum keeps the dot the same bits on every run.
#include "common.cuh"

namespace its {

// Diagonals one launch takes (the wrapper launches more in groups).
constexpr int kMaxDiags = 16;
// Diagonals whose loads a run issues together: a matrix with more takes
// its diagonals in groups of kGroup, one after the other, so the registers
// of one group's raw runs serve every nd.
constexpr int kGroup = 8;

struct DiaArgs {
  int nd;
  int accumulate;  // 1: each row's chain starts from y, else from 0
  int off[kMaxDiags];
  const void* diag[kMaxDiags];
};

// Row i alone: one load a term from a clamped index, an out-of-range column
// dropped by a select.
template <typename D>
__device__ __forceinline__ float dia_row(const DiaArgs& a,
                                         const float* __restrict__ x,
                                         const float* y, int i,
                                         int n) {
  float acc = a.accumulate ? y[i] : 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxDiags; ++k) {
    if (k < a.nd) {
      const int j = i + a.off[k];
      const float xv = x[min(max(j, 0), n - 1)];
      const float d = to_f32(static_cast<const D*>(a.diag[k])[i]);
      const float sum = fmaf(d, xv, acc);
      acc = static_cast<unsigned>(j) < static_cast<unsigned>(n) ? sum : acc;
    }
  }
  return acc;
}

// The run of R rows at r0: y stored; with kDot also the run's u values in
// pu and y values in py (rows past n left as they are).
template <typename D, bool kDot>
__device__ __forceinline__ void dia_run(
    const DiaArgs& a, const float* __restrict__ x, const float* __restrict__ u,
    float* __restrict__ y, int n, int r0, int vec,
    float (&pu)[kVecOf<D>], float (&py)[kVecOf<D>]) {
  constexpr int R = kVecOf<D>;
  if (vec && r0 + R <= n) {
    float acc[R];
    if (a.accumulate) {
      // plain loads: y is written by this launch
#pragma unroll
      for (int p = 0; p < R; p += 4) {
        const float4 v = *reinterpret_cast<const float4*>(y + r0 + p);
        acc[p] = v.x;
        acc[p + 1] = v.y;
        acc[p + 2] = v.z;
        acc[p + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < R; ++e) acc[e] = 0.0f;
    }
#pragma unroll
    for (int k0 = 0; k0 < kMaxDiags; k0 += kGroup) {
      if (k0 < a.nd) {
        // the group's diagonal runs in flight at once, before the first FMA
        // waits
        uint4 raw[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k0 + k < a.nd) {
            raw[k] = load16<true>(static_cast<const D*>(a.diag[k0 + k]) + r0);
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          if (k0 + k < a.nd) {
            float d[R], w[R];
            unpack_vec<D>(raw[k], d);
            const int off = a.off[k0 + k];
            unsigned ok = ~0u;
            if (!load_window<float, R>(x, r0 + off, n, w)) {
              ok = 0u;
#pragma unroll
              for (int e = 0; e < R; ++e) {
                ok |= static_cast<unsigned>(
                          static_cast<unsigned>(r0 + off + e) <
                          static_cast<unsigned>(n)) << e;
              }
            }
#pragma unroll
            for (int e = 0; e < R; ++e) {
              const float sum = fmaf(d[e], w[e], acc[e]);
              acc[e] = (ok >> e) & 1u ? sum : acc[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < R; p += 4) store_vec<float>(y + r0 + p, acc + p);
    if (kDot) {
      // u's run after the products: when u is x, the center run again,
      // from L1, so that the main loop holds no more registers than
      // without the dot
      window_vec<float, R, 0>(u, r0, pu);
#pragma unroll
      for (int e = 0; e < R; ++e) py[e] = acc[e];
    }
  } else {
    // the rare rows: the tail past the last whole run, unaligned operands
#pragma unroll 1
    for (int e = 0; e < R; ++e) {
      const int i = r0 + e;
      if (i < n) {
        const float yi = dia_row<D>(a, x, y, i, n);
        y[i] = yi;
        if (kDot) {
          set_at(pu, e, u[i]);
          set_at(py, e, yi);
        }
      }
    }
  }
}

template <typename D, bool kDot>
__global__ void __launch_bounds__(kThreads)
dia_kernel(DiaArgs a, const float* __restrict__ x, const float* __restrict__ u,
           float* __restrict__ y, float* __restrict__ partials,
           unsigned* __restrict__ ticket, float* __restrict__ dot, int n,
           int vec) {
  constexpr int R = kVecOf<D>;
  float pu[R], py[R];
  float local = 0.0f;
  const int runs = n / R + (n % R != 0);
  for (int run = blockIdx.x * blockDim.x + threadIdx.x; run < runs;
       run += gridDim.x * blockDim.x) {
    dia_run<D, kDot>(a, x, u, y, n, run * R, vec, pu, py);
    if constexpr (kDot) {
      const int cnt = min(R, n - run * R);
#pragma unroll
      for (int e = 0; e < R; ++e) {
        local = e < cnt ? fmaf(pu[e], py[e], local) : local;
      }
    }
  }
  if constexpr (kDot) finish_dot(local, partials, ticket, dot);
}

template <typename D>
const void* kernel_of(int with_dot) {
  return with_dot ? reinterpret_cast<const void*>(dia_kernel<D, true>)
                  : reinterpret_cast<const void*>(dia_kernel<D, false>);
}

const void* kernel_of(int diag_dtype, int with_dot, int nd) {
  if (nd < 1 || nd > kMaxDiags) return nullptr;
  if (diag_dtype == 0) return kernel_of<float>(with_dot);
  if (diag_dtype == 1) return kernel_of<__nv_bfloat16>(with_dot);
  if (diag_dtype == 2) return kernel_of<int8_t>(with_dot);
  return nullptr;
}

}  // namespace its

// Blocks of its_dia_spmv's kernel for (diag_dtype, with_dot, nd) that one
// SM holds at once, written to *blocks; returns a CUDA error code, or -1
// for bad arguments.  The wrapper's grid is this times the SM count, or
// fewer where n needs fewer.
extern "C" int its_dia_blocks_per_sm(int diag_dtype, int with_dot, int nd,
                                     int* blocks) {
  using namespace its;
  const void* k = kernel_of(diag_dtype, with_dot, nd);
  if (k == nullptr) return -1;
  return blocks_per_sm(k, blocks);
}

// diag_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  `diags` and `offs` are
// host arrays of `nd` device pointers and offsets (nd <= kMaxDiags; the
// wrapper launches more in groups).  accumulate = 1 adds the products to
// the y already stored (each row's chain starts from it).  vec = 1 when x, u, y and
// every diagonal are 16-byte aligned (else every row takes the per-row
// loads).  With the dot: `partials` holds `grid`
// floats, `ticket` one unsigned that is 0 between launches (the kernel
// leaves it 0), `dot` one float.  Returns the CUDA error code of the launch
// (0 = success), or -1 for bad arguments.
extern "C" int its_dia_spmv(int diag_dtype, int with_dot,
                            const void* const* diags, const int* offs, int nd,
                            const void* x, const void* u, void* y,
                            void* partials, void* ticket, void* dot, int n,
                            int grid, int vec, int accumulate,
                            void* stream) {
  using namespace its;
  if (nd < 1 || nd > kMaxDiags || grid < 1 || n < 1) return -1;
  DiaArgs a = {};
  a.nd = nd;
  a.accumulate = accumulate;
  for (int k = 0; k < nd; ++k) {
    a.off[k] = offs[k];
    a.diag[k] = diags[k];
  }
  const float* xf = static_cast<const float*>(x);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* pf = static_cast<float*>(partials);
  unsigned* tk = static_cast<unsigned*>(ticket);
  float* df = static_cast<float*>(dot);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* k = kernel_of(diag_dtype, with_dot, nd);
  if (k == nullptr) return -1;
  void* args[] = {&a, &xf, &uf, &yf, &pf, &tk, &df, &n, &vec};
  return static_cast<int>(
      cudaLaunchKernel(k, dim3(grid), dim3(kThreads), args, 0, s));
}
