// The panel MGS sweep shared by `panel_mgs.cu` (panel_mgs) and `arnoldi.cu`
// (fused_arnoldi): device code that runs inside one cooperative launch of
// one block of kThreads threads on each SM.
//
// Residency.  Block b owns the contiguous chunk [b c, min((b + 1) c, n)) of
// the working vector y and keeps it on chip for the whole sweep, in three
// tiers (e is the entry's index in the chunk):
//   - registers: e < kRowRegs kThreads, entry e = r kThreads + t in thread
//     t's reg[r]; reg is indexed only in fully unrolled loops, so it stays
//     in registers (a short chunk leaves the rest of reg unused);
//   - shared memory: the next S entries (dynamic shared memory);
//   - the spill tier: the rest, in the global scratch y at the chunk's
//     offsets, read and written in every pass.
//
// Streaming.  A pass walks the chunk in tiles of tile_size entries (tile_rows
// a thread) and brings each tile of the rows it reads into a ring of
// kStages stages in shared memory with cp.async, kStages - 1 tiles ahead
// (a pass's first tiles are issued before the grid sync that precedes it):
// the loads in flight hold no registers, which the register tier fills.
// A row read twice (its dot in pass j, its axpy in pass j + 1) is read
// with evict_last the first time and evict_first the second, so that L2
// keeps what it can of it between the two reads: two bf16 rows at 216^3
// (40 MB) fit the 50 MB L2, two f32 rows do not, and an f32 pass moves
// about both rows' bytes from device memory.  ops/cuda_mgs.py's
// plan_residency picks S from n, the grid and the card's shared memory.
//
//   pass 0:          y = src (w, or the stencil of row k), dot with V_0
//   pass j (1..k):   y -= h_{j-1} V_{j-1}, dot with V_j
//   pass k + 1:      y -= h_k V_k, |y|^2
//   then:            out = y * (1 / nrm * scale), from chip
//
// with a grid.sync() after each of the k + 2 passes.  A dot across the grid
// is summed deterministically: each block writes one f32 partial; after
// grid.sync() every block sums all partials in the same fixed order, so
// every block holds the same bits of h_j and a solve takes the same steps on
// every run for a given n and grid.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace its {

namespace cg = cooperative_groups;

// The register tier, in entries a thread (ops/cuda_mgs.py's ROW_REGS names
// the same).
constexpr int kRowRegs = 144;

// Store this block's sum of `v` as its partial.  Valid in any thread; the
// caller synchronises the grid before the partials are read.
__device__ __forceinline__ void write_partial(float* partials, float v) {
  const float s = block_sum(v);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Sum of the `g` partials, in a fixed order, returned to every thread of the
// block.  Partials are written by other blocks in this launch, so they are
// read past L1 (__ldcg).
__device__ __forceinline__ float grid_total(const float* partials, int g) {
  __shared__ float total;
  float s = 0.0f;
  for (int i = threadIdx.x; i < g; i += blockDim.x) s += __ldcg(partials + i);
  s = block_sum(s);
  if (threadIdx.x == 0) total = s;
  __syncthreads();
  const float r = total;
  __syncthreads();
  return r;
}

// L2 eviction policies (PTX createpolicy) for the loads of panel rows,
// made where a copy is issued (volatile: not hoisted, so that no register
// holds a policy across the sweep).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// A streaming load of an f32 read once, predicated on `pred` (0 where it
// is false): no branch, so the compiler may keep many in flight.
__device__ __forceinline__ float load_once(const float* p, bool pred = true) {
  float v = 0.0f;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.cs.f32 %0, [%1];\n\t}"
      : "+f"(v) : "l"(p), "r"(static_cast<int>(pred)));
  return v;
}

// The tiles a pass streams through shared memory: kTileBytes of a row for
// each thread, so 8 f32 or 16 bf16 entries a thread, 8 KB a row's tile
// (ops/cuda_mgs.py's TILE_BYTES and STAGES name the same).
constexpr int kTileBytes = 32;
constexpr int kStages = 4;                    // tiles in the ring

template <typename TV>
__host__ __device__ constexpr int tile_rows() {
  return kTileBytes / static_cast<int>(sizeof(TV));
}

template <typename TV>
__host__ __device__ constexpr int tile_size() {
  return tile_rows<TV>() * kThreads;
}

// A slot holds one row's tile and one 16-byte piece more (a tile that
// starts inside a piece); a stage holds two slots (V_{j-1}, V_j).
template <typename TV>
__host__ __device__ constexpr int slot_elems() {
  return tile_size<TV>() + 16 / static_cast<int>(sizeof(TV));
}

template <typename TV>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * slot_elems<TV>() * static_cast<int>(sizeof(TV));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t pol) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "l"(pol) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where entry p lands in its slot: copies start at the 16-byte piece that
// holds it.
template <typename TV>
__device__ __forceinline__ int slot_offset(const TV* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(TV));
}

// Copy entries [p, p + cnt) of a row into `slot` (from the piece that holds
// p), each thread of the block its share of the 16-byte pieces.
template <typename TV>
__device__ __forceinline__ void copy_tile(TV* slot, const TV* p, int cnt,
                                          uint64_t pol) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const char* src = reinterpret_cast<const char*>(a & ~uintptr_t(15));
  const int pieces = static_cast<int>(
      ((a & 15) + static_cast<uintptr_t>(cnt) * sizeof(TV) + 15) / 16);
  char* dst = reinterpret_cast<char*>(slot);
  for (int i = threadIdx.x; i < pieces; i += kThreads) {
    cp_async16(dst + 16 * i, src + 16 * i, pol);
  }
}

// A block's chunk: its first row, its length, the end of the shared tier.
struct Chunk {
  int lo;
  int len;
  int send;   // min(len, kRowRegs kThreads + S)
  int S;
};

// The rows a pass reads, at the block's chunk, and the ring they stream
// through.  A row's first read is evict_last, its second evict_first.
template <typename TV>
struct PassRows {
  const TV* prev;   // V_{j-1}, the axpy's (not in pass 0)
  const TV* next;   // V_j, the dot's (not in pass k + 1)
  TV* ring;
};

template <typename TV>
__device__ __forceinline__ TV* slot(TV* ring, int stage, int which) {
  return ring + (stage * 2 + which) * slot_elems<TV>();
}

// Start the copies of tile q's rows (none past the chunk), as one group.
template <typename TV, bool First, bool Last>
__device__ __forceinline__ void issue(const PassRows<TV>& p, const Chunk& ch,
                                      int q) {
  constexpr int kTile = tile_size<TV>();
  if (q * kTile < ch.len) {
    const int cnt = min(kTile, ch.len - q * kTile);
    const int st = q % kStages;
    if (!First) {
      copy_tile(slot(p.ring, st, 0), p.prev + q * kTile, cnt, l2_evict_first());
    }
    if (!Last) {
      copy_tile(slot(p.ring, st, 1), p.next + q * kTile, cnt, l2_evict_last());
    }
  }
  cp_async_commit();
}

// Tile q's rows in shared memory: wait for its copies, make every thread's
// visible, and refill the stage the tile before used (kStages - 1 ahead).
// Returns the tile's stage.
template <typename TV, bool First, bool Last>
__device__ __forceinline__ int begin_tile(const PassRows<TV>& p,
                                          const Chunk& ch, int q) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  issue<TV, First, Last>(p, ch, q + kStages - 1);
  return q % kStages;
}

// Start the copies of a pass's first kStages - 1 tiles.
template <typename TV, bool First, bool Last>
__device__ __forceinline__ void issue_ahead(const PassRows<TV>& p,
                                            const Chunk& ch) {
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue<TV, First, Last>(p, ch, q);
}

// Point p at the rows of pass j (1..k + 1) and start its first tiles, once
// every thread is done with the ring: the caller then synchronises the
// grid, and the tiles are in flight across the sync.
template <typename TV>
__device__ __forceinline__ void start_pass(PassRows<TV>& p, const TV* V,
                                           int n, int j, int k,
                                           const Chunk& ch) {
  p.prev = V + static_cast<size_t>(j - 1) * n + ch.lo;
  p.next = p.prev + n;
  __syncthreads();
  if (j <= k) {
    issue_ahead<TV, false, false>(p, ch);
  } else {
    issue_ahead<TV, false, true>(p, ch);
  }
}

// One entry of a pass, y held in `yi`: y -= hp prev (unless First), then
// the entry's term of <next, y> (or y^2 if Last), added to acc.
template <bool First, bool Last>
__device__ __forceinline__ void entry(float& yi, float prev, float next,
                                      float hp, float& acc) {
  if (!First) yi = fmaf(-hp, prev, yi);
  acc = Last ? fmaf(yi, yi, acc) : fmaf(next, yi, acc);
}

// One pass over the block's chunk, tile by tile, its first tiles already
// issued (issue_ahead); returns the thread's sum.  First: the dot of pass 0
// (no axpy); Last: the axpy of row k and |y|^2.
template <typename TV, bool First, bool Last>
__device__ __forceinline__ float sweep_pass(float (&reg)[kRowRegs], float* sy,
                                            float* gy, const Chunk& ch,
                                            const PassRows<TV>& p, float hp) {
  constexpr int kTileRows = tile_rows<TV>();
  constexpr int kTile = tile_size<TV>();
  static_assert(kRowRegs % kTileRows == 0,
                "kRowRegs must be a multiple of tile_rows");
  constexpr int kRegTiles = kRowRegs / kTileRows;
  const int t = threadIdx.x;
  const int nt = (ch.len + kTile - 1) / kTile;
  float acc = 0.0f;
  // the register tier
#pragma unroll
  for (int q = 0; q < kRegTiles; ++q) {
    if (q < nt) {
      const int st = begin_tile<TV, First, Last>(p, ch, q);
      const TV* sp = First ? nullptr
          : slot(p.ring, st, 0) + slot_offset(p.prev + q * kTile);
      const TV* sn = Last ? nullptr
          : slot(p.ring, st, 1) + slot_offset(p.next + q * kTile);
#pragma unroll
      for (int u = 0; u < kTileRows; ++u) {
        const int i = u * kThreads + t;
        if (q * kTile + i < ch.len) {
          entry<First, Last>(reg[q * kTileRows + u],
                             First ? 0.0f : to_f32(sp[i]),
                             Last ? 0.0f : to_f32(sn[i]), hp, acc);
        }
      }
    }
  }
  // the shared tier, then the spill tier: y at yt, in shared or device
  // memory; a full tile's entries with no branch, so that a spill tile's
  // loads of y are in flight together
  const int qs = kRegTiles + ch.S / kTile;
  for (int q = kRegTiles; q < nt; ++q) {
    const int st = begin_tile<TV, First, Last>(p, ch, q);
    const TV* sp = First ? nullptr
        : slot(p.ring, st, 0) + slot_offset(p.prev + q * kTile);
    const TV* sn = Last ? nullptr
        : slot(p.ring, st, 1) + slot_offset(p.next + q * kTile);
    float* yt = q < qs ? sy + (q - kRegTiles) * kTile : gy + q * kTile;
    if ((q + 1) * kTile <= ch.len) {
      float yv[kTileRows];
#pragma unroll
      for (int u = 0; u < kTileRows; ++u) yv[u] = yt[u * kThreads + t];
#pragma unroll
      for (int u = 0; u < kTileRows; ++u) {
        const int i = u * kThreads + t;
        entry<First, Last>(yv[u], First ? 0.0f : to_f32(sp[i]),
                           Last ? 0.0f : to_f32(sn[i]), hp, acc);
        yt[i] = yv[u];
      }
    } else {
      for (int u = 0; u < kTileRows; ++u) {
        const int i = u * kThreads + t;
        if (q * kTile + i < ch.len) {
          float yi = yt[i];
          entry<First, Last>(yi, First ? 0.0f : to_f32(sp[i]),
                             Last ? 0.0f : to_f32(sn[i]), hp, acc);
          yt[i] = yi;
        }
      }
    }
  }
  return acc;
}

// Modified Gram-Schmidt of the vector `fill` puts in the chunk against rows
// 0..k of V, then the norm, then `out[i] = y[i] * (1 / nrm * scale)` in
// V's dtype (1/nrm taken as 1 where nrm = 0): `out` is panel row k + 1 and
// scale is GMRES's do.  `fill(reg, sy, gy, ch)` writes the block's entries
// of that vector into the three tiers (zeros in reg past ch.len).
// h[0..k] = h_j, h[k+1..m1) = 0; nrm_out = |y|.  `partials` holds
// (k + 2) * gridDim.x floats.  The block's chunk is [blockIdx.x c, ...)
// with S entries in shared memory; `smem` is the dynamic shared memory:
// the ring, then the S floats of the shared tier; y is the spill tier.
template <typename TV, typename Fill>
__device__ __forceinline__ void mgs_sweep(
    cg::grid_group& grid, const TV* V, const Fill& fill, float* y,
    float* partials, float* h, float* nrm_out, int n, int m1, int k,
    float scale, TV* out, int c, int S, unsigned char* smem) {
  constexpr int RT = kRowRegs * kThreads;
  const int t = threadIdx.x;
  const int g = gridDim.x;
  Chunk ch;
  ch.lo = static_cast<int>(
      min(static_cast<long long>(blockIdx.x) * c, static_cast<long long>(n)));
  ch.len = min(c, n - ch.lo);
  ch.send = min(ch.len, RT + S);
  ch.S = S;
  float* gy = y + ch.lo;
  float* sy = reinterpret_cast<float*>(smem + ring_bytes<TV>());
  PassRows<TV> p{V + ch.lo, V + ch.lo, reinterpret_cast<TV*>(smem)};
  float reg[kRowRegs];

  // pass 0: y = the vector (V_0's first tiles in flight meanwhile), and
  // the partials of <V_0, y>
  issue_ahead<TV, true, false>(p, ch);
  fill(reg, sy, gy, ch);
  float acc = sweep_pass<TV, true, false>(reg, sy, gy, ch, p, 0.0f);
  start_pass(p, V, n, 1, k, ch);
  write_partial(partials, acc);
  grid.sync();

  // passes 1..k + 1: the axpy of row j - 1 and the dot of row j (or |y|^2)
  for (int j = 1; j <= k + 1; ++j) {
    const float hp = grid_total(partials + static_cast<size_t>(j - 1) * g, g);
    if (blockIdx.x == 0 && t == 0) h[j - 1] = hp;
    acc = j <= k ? sweep_pass<TV, false, false>(reg, sy, gy, ch, p, hp)
                 : sweep_pass<TV, false, true>(reg, sy, gy, ch, p, hp);
    if (j <= k) start_pass(p, V, n, j + 1, k, ch);
    write_partial(partials + static_cast<size_t>(j) * g, acc);
    grid.sync();
  }

  const float nrm = sqrtf(grid_total(partials + static_cast<size_t>(k + 1) * g, g));
  const float inv = (nrm == 0.0f ? 1.0f : 1.0f / nrm) * scale;
  if (blockIdx.x == 0) {
    if (t == 0) *nrm_out = nrm;
    for (int j = k + 1 + t; j < m1; j += blockDim.x) h[j] = 0.0f;
  }
  TV* o = out + ch.lo;
#pragma unroll
  for (int r = 0; r < kRowRegs; ++r) {
    const int e = r * kThreads + t;
    if (e < ch.len) o[e] = from_f32<TV>(reg[r] * inv);
  }
  for (int e = RT + t; e < ch.send; e += kThreads) {
    o[e] = from_f32<TV>(sy[e - RT] * inv);
  }
  for (int e = RT + S + t; e < ch.len; e += kThreads) {
    o[e] = from_f32<TV>(gy[e] * inv);
  }
}

// The dynamic shared memory one block of `kernel` may take on the current
// device, written to *bytes: the device's opt-in limit a block less the
// kernel's static shared memory.  Returns a CUDA error code.
template <typename Kernel>
int dynamic_smem_limit(Kernel kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// The grid of a sweep kernel on the current device: one block on each SM,
// or fewer where n needs fewer blocks of kThreads.  Checks that one block
// of `kernel` with `smem` bytes of dynamic shared memory fits on an SM
// (after raising the kernel's dynamic shared memory limit to `smem`).
template <typename Kernel>
int cooperative_grid(Kernel kernel, int n, int smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return -2;
  const int need = (n + kThreads - 1) / kThreads;
  *grid = need < sms ? need : sms;
  return *grid >= 1 ? 0 : -1;
}

// Launch `kernel` cooperatively on `grid` blocks with `smem` bytes of
// dynamic shared memory; returns the CUDA error code (0 = success).
inline int launch_sweep(const void* kernel, int grid, int smem, void** args,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), args, static_cast<size_t>(smem), s));
}

}  // namespace its
