// The vector work of a CG step (solvers/cg.py `_cg_step`) on a real f32
// solve vector, around the operator's product, whose launch is unchanged:
//
//   rho launch (preconditioned):  rho = <c, r>
//   direction launch:   beta = rho / rho_prev;  u' = c + beta u
//   (the product:       c' = A u', sigma = <u', c'>)
//   update launch:      alpha = rho / sigma;  x' = x + alpha u';
//                       r' = r - alpha c';  |r'|^2
//
// Without a preconditioner c = r, and rho is the square of the state's
// residual |r|, the reference's unpreconditioned recurrence
// (`it.residual^2`, src/cg.jl:50-51); so that step reduces nothing before
// the product.  Every scalar is read from and written to device memory, so a
// step reads nothing back to the host and may be captured in a CUDA graph.
//
// The mask: where *live is false, the direction launch writes u and the
// update launch x and r unchanged (copies), and the update's last block
// keeps the residual, the count and the log; rho_out keeps rho_prev.
//
// Rounding, as the eager step's torch operations round on the card: u' =
// c + (beta u), the product rounded first (`addcmul(beta * u, 1, c)`);
// x' = fmaf(alpha, u', x) (`addcmul(x, alpha, u)`, one fused multiply-add);
// r' = r - (alpha c'), the product rounded first (`addcmul(r, alpha, c,
// value=-1)` rounds twice there); beta, alpha, rho and the square root are
// correctly rounded.  The
// sums take each product rounded and then add it (no contraction), in the
// fixed order of common.cuh's in-launch dot: a thread takes runs of kRun rows
// j = blockIdx.x kThreads + threadIdx.x + m gridDim.x kThreads, m = 0, 1, ...,
// and adds their products from 0 in row order; then block_sum; the block that
// draws the last ticket sums the partials.  ops/cuda_cg.py replays the order.
#include "common.cuh"

namespace its {
namespace {

// rows a thread takes at once: one 16-byte vector of f32
constexpr int kRun = 4;

// The sum of `local` over the grid in common.cuh's finish_dot order.  Each
// block writes its block_sum to partials[blockIdx.x]; the block that draws
// the last ticket sums the partials, sets the ticket back to 0 and returns
// true (in every thread), with the sum in thread 0's *total; every other
// block returns false.  Every thread of the block calls it.
__device__ __forceinline__ bool sum_in_last_block(float local,
                                                  float* partials,
                                                  unsigned* ticket,
                                                  float* total) {
  __shared__ bool last;
  const float s = block_sum(local);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return false;
  float v = 0.0f;
  for (int i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    v = __fadd_rn(v, __ldcg(partials + i));
  }
  v = block_sum(v);
  if (threadIdx.x == 0) {
    *total = v;
    *ticket = 0u;
  }
  return true;
}

// f32 rows [4 j, 4 j + 4) of p as four floats: one 16-byte load where the
// run is whole and `vec` (every vector of the launch 16-byte aligned), else
// one load a row, 0 past n.  kStream: a stream read once (common.cuh load16).
template <bool kStream>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int j,
                                         int n, bool whole, float (&v)[kRun]) {
  if (whole) {
    unpack_vec<float>(load16<kStream>(p + kRun * j), v);
    return;
  }
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const int i = kRun * j + e;
    v[e] = i < n ? p[i] : 0.0f;
  }
}

// v to rows [4 j, 4 j + 4) of p, as load_run reads them.
__device__ __forceinline__ void store_run(float* __restrict__ p, int j, int n,
                                          bool whole, const float (&v)[kRun]) {
  if (whole) {
    store_vec<float>(p + kRun * j, v);
    return;
  }
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const int i = kRun * j + e;
    if (i < n) p[i] = v[e];
  }
}

// *out = <c, r> (PCG's rho), summed in the order of the file's comment.
__global__ void __launch_bounds__(kThreads)
    cg_rho_kernel(const float* __restrict__ c, const float* __restrict__ r,
                  float* partials, unsigned* ticket, float* out, int n,
                  int vec) {
  const int runs = (n + kRun - 1) / kRun;
  const int stride = gridDim.x * blockDim.x;
  float local = 0.0f;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < runs; j += stride) {
    const bool whole = vec && kRun * j + kRun <= n;
    float cv[kRun], rv[kRun];
    load_run<false>(c, j, n, whole, cv);
    load_run<false>(r, j, n, whole, rv);
#pragma unroll
    for (int e = 0; e < kRun; ++e) local = __fadd_rn(local, __fmul_rn(cv[e], rv[e]));
  }
  float total;
  if (sum_in_last_block(local, partials, ticket, &total) && threadIdx.x == 0) {
    *out = total;
  }
}

// u' = c + beta u where *live, else u; rho = (*rho_src)^2 (`square`: the
// residual |r|) or *rho_src (<c, r>), beta = rho / *rho_prev.  Block 0 writes
// *rho_out = live ? rho : *rho_prev, the state's next rho.
__global__ void __launch_bounds__(kThreads)
    cg_direction_kernel(const float* __restrict__ c,
                        const float* __restrict__ u, float* __restrict__ u_out,
                        const float* __restrict__ rho_src, int square,
                        const float* __restrict__ rho_prev,
                        const unsigned char* __restrict__ live,
                        float* __restrict__ rho_out, int n, int vec) {
  const bool on = *live != 0;
  const float src = *rho_src;
  const float rho = square ? __fmul_rn(src, src) : src;
  const float prev = *rho_prev;
  const float beta = __fdiv_rn(rho, prev);
  if (blockIdx.x == 0 && threadIdx.x == 0) *rho_out = on ? rho : prev;
  const int runs = (n + kRun - 1) / kRun;
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < runs; j += stride) {
    const bool whole = vec && kRun * j + kRun <= n;
    float uv[kRun];
    load_run<false>(u, j, n, whole, uv);
    if (on) {
      float cv[kRun];
      load_run<false>(c, j, n, whole, cv);
#pragma unroll
      for (int e = 0; e < kRun; ++e) uv[e] = __fadd_rn(cv[e], __fmul_rn(beta, uv[e]));
    }
    store_run(u_out, j, n, whole, uv);
  }
}

// x' = x + alpha u, r' = r - alpha c with alpha = *rho / *sigma where *live,
// else x and r unchanged; *rr = |r'|^2 in the file's order.  With res_out
// (one card) the last block also writes the state's next residual, count and
// log slot: *res_out = live ? sqrt(|r'|^2) : *res_in, *k_out = *k_in + live,
// log[min(max(*k_in, 0), log_len - 1)] = *res_out where live.  Without it (a
// mesh) *rr is this rank's share, which the caller sums over the ranks.
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     const float* __restrict__ r, const float* __restrict__ c,
                     float* __restrict__ x_out, float* __restrict__ r_out,
                     const float* __restrict__ rho,
                     const float* __restrict__ sigma,
                     const unsigned char* __restrict__ live, float* partials,
                     unsigned* ticket, float* rr, const float* res_in,
                     float* res_out, const long long* k_in, long long* k_out,
                     float* log, long long log_len, int n, int vec) {
  const bool on = *live != 0;
  const float alpha = on ? __fdiv_rn(*rho, *sigma) : 0.0f;
  const int runs = (n + kRun - 1) / kRun;
  const int stride = gridDim.x * blockDim.x;
  float local = 0.0f;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < runs; j += stride) {
    const bool whole = vec && kRun * j + kRun <= n;
    float xv[kRun], rv[kRun];
    load_run<true>(x, j, n, whole, xv);
    load_run<false>(r, j, n, whole, rv);
    if (on) {
      float uv[kRun], cv[kRun];
      load_run<false>(u, j, n, whole, uv);
      load_run<false>(c, j, n, whole, cv);
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        xv[e] = fmaf(alpha, uv[e], xv[e]);
        rv[e] = __fsub_rn(rv[e], __fmul_rn(alpha, cv[e]));
      }
    }
    store_run(x_out, j, n, whole, xv);
    store_run(r_out, j, n, whole, rv);
#pragma unroll
    for (int e = 0; e < kRun; ++e) local = __fadd_rn(local, __fmul_rn(rv[e], rv[e]));
  }
  float total;
  if (!sum_in_last_block(local, partials, ticket, &total) || threadIdx.x != 0) {
    return;
  }
  *rr = total;
  if (res_out == nullptr) return;
  const long long k = *k_in;
  if (on) {
    const float res = __fsqrt_rn(total);
    *res_out = res;
    log[k < 0 ? 0 : (k >= log_len ? log_len - 1 : k)] = res;
  } else {
    *res_out = *res_in;
  }
  *k_out = k + (on ? 1 : 0);
}

const void* kernel_of(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(&cg_rho_kernel);
    case 1: return reinterpret_cast<const void*>(&cg_direction_kernel);
    case 2: return reinterpret_cast<const void*>(&cg_update_kernel);
    default: return nullptr;
  }
}

int checked(cudaError_t err) {
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace
}  // namespace its

// Blocks of kernel `which` (0 rho, 1 direction, 2 update) one SM holds at
// once, written to *blocks; returns a CUDA error code, or -1.
extern "C" int its_cg_blocks_per_sm(int which, int* blocks) {
  const void* k = its::kernel_of(which);
  return k == nullptr ? -1 : its::blocks_per_sm(k, blocks);
}

// The launches on `stream` with `grid` blocks (kThreads threads each) over
// n rows; `vec`: every vector of the launch starts on a 16-byte boundary.
// `partials` holds `grid` floats and `ticket` is 0 between launches (one
// each per device and stream).  Each returns the launch's CUDA error code
// (0 = success), or -1 for bad arguments.
extern "C" int its_cg_rho(const float* c, const float* r, float* partials,
                          unsigned* ticket, float* out, int n, int grid,
                          int vec, void* stream) {
  if (c == nullptr || r == nullptr || partials == nullptr ||
      ticket == nullptr || out == nullptr || n < 1 || grid < 1) {
    return -1;
  }
  its::cg_rho_kernel<<<grid, its::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      c, r, partials, ticket, out, n, vec);
  return its::checked(cudaSuccess);
}

extern "C" int its_cg_direction(const float* c, const float* u, float* u_out,
                                const float* rho_src, int square,
                                const float* rho_prev, const void* live,
                                float* rho_out, int n, int grid, int vec,
                                void* stream) {
  if (c == nullptr || u == nullptr || u_out == nullptr ||
      rho_src == nullptr || rho_prev == nullptr || live == nullptr ||
      rho_out == nullptr || n < 1 || grid < 1) {
    return -1;
  }
  its::cg_direction_kernel<<<grid, its::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      c, u, u_out, rho_src, square, rho_prev,
      static_cast<const unsigned char*>(live), rho_out, n, vec);
  return its::checked(cudaSuccess);
}

// res_out null: the mesh's form (res_in, k_in, k_out and log unused).
extern "C" int its_cg_update(const float* x, const float* u, const float* r,
                             const float* c, float* x_out, float* r_out,
                             const float* rho, const float* sigma,
                             const void* live, float* partials,
                             unsigned* ticket, float* rr, const float* res_in,
                             float* res_out, const long long* k_in,
                             long long* k_out, float* log, long long log_len,
                             int n, int grid, int vec, void* stream) {
  if (x == nullptr || u == nullptr || r == nullptr || c == nullptr ||
      x_out == nullptr || r_out == nullptr || rho == nullptr ||
      sigma == nullptr || live == nullptr || partials == nullptr ||
      ticket == nullptr || rr == nullptr || n < 1 || grid < 1 ||
      (res_out != nullptr && (res_in == nullptr || k_in == nullptr ||
                              k_out == nullptr || log == nullptr ||
                              log_len < 1))) {
    return -1;
  }
  its::cg_update_kernel<<<grid, its::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, u, r, c, x_out, r_out, rho, sigma,
      static_cast<const unsigned char*>(live), partials, ticket, rr, res_in,
      res_out, k_in, k_out, log, log_len, n, vec);
  return its::checked(cudaSuccess);
}
