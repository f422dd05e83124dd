// Client encode r[n, j] = sum over leaves and i of x[n, i] * v_j(seed_n)[i] * 1[i in block j].
//
// Replaces the TPU kernel repro/kernels/seeded_projection.py::_proj_kernel.
// One launch covers every leaf of a tree (the leaf table of tree.cuh) for
// every client of a round: each leaf is (N, rows, cols) float32 or bf16
// (widened exactly on load, as the TPU kernel's x.astype(float32)), seeds
// are the (N,) round seeds (int64 words; their low 32 bits are the
// uint32 seed), and the result is float32 (N, k).  Per-block seeds are
// derived here as fold_seed(splitmix32(seed ^ (PROJ_SALT + j)), leaf_tag),
// and v is regenerated from (seed, row, col) by the factored chain of
// chain.cuh: it never exists in device memory.  A single leaf is a tree
// of one (project_blocks).
//
// Bound on this card: the kernel must read x once, 4 bytes (bf16: 2) per
// element per client, and writes N*k floats.  The chain costs one
// SplitMix32 round (~10 integer ops) plus the value map per element per
// block; at k = 1 that sits near the ratio where the 3.35 TB/s of HBM
// and the integer ALUs take about the same time.
//
// Design.  Blocks walk the flat tile space of all leaves (TILE_ROWS rows
// of one leaf per tile) with a grid-stride loop, one block row per (j,
// n).  Each tile writes one partial sum to scratch that the wrapper
// allocates; a second launch sums, for each (n, j), every leaf's tiles
// in a fixed order and then the leaves in table (sorted-key) order, as
// the per-leaf path adds its leaves.  No float atomics: the encode gives
// the same bits run after run.  Inside a tile each warp takes one row at
// a time, so the row rounds of the chain run once per row; the lanes
// stride along the row with 16-byte loads (8 bf16 or 4 float32 values),
// UNROLL of them issued before the first is used, so a warp keeps
// several loads in flight instead of a chain of dependent 2-byte loads
// and adds, and each lane alternates two accumulators.  A leaf whose rows
// are not 16-byte aligned takes a scalar loop.  The ragged edge is masked
// here; the leaf is not padded.  In BLOCK mode a tile whose flat range
// cannot meet block j is skipped, and inside a tile an element counts
// only if its float32 flat index lies in [lo_j, hi_j), as in the
// reference; masked = 0 (k = 1 and FULL mode) runs the body with no mask.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tree.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 32;
constexpr int UNROLL = 4;   // 16-byte loads in flight per lane

__device__ __forceinline__ float warp_sum(float v) {
  // Fixed butterfly order: deterministic.
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <int DIST, bool MASKED>
__device__ __forceinline__ float product(float xv, const fs::RowState& st, uint32_t col,
                                         float rowf, float lo_b, float hi_b) {
  const float p = __fmul_rn(xv, fs::value_from_state<DIST>(st, col));
  if (!MASKED) return p;
  const float flat = __fadd_rn(rowf, __uint2float_rn(col));
  return __fmul_rn(p, (flat >= lo_b && flat < hi_b) ? 1.0f : 0.0f);
}

// This thread's share of one tile's sum for client n (xn) and block seed s.
template <typename T, int DIST, bool MASKED>
__device__ float tile_partial(const fs::TreeLeaf& L, const T* __restrict__ xn,
                              int tile, uint32_t s, float lo_b, float hi_b,
                              int warp, int lane) {
  constexpr int V = fs::VecOf<T>::V;
  const int cols = L.cols;
  const int r0 = tile * TILE_ROWS;
  const int r_end = min(r0 + TILE_ROWS, L.rows);
  const float fcols = __int2float_rn(L.orig_cols);
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int r = r0 + warp; r < r_end; r += WARPS) {
    const uint32_t row = L.row_offset + (uint32_t)r;
    const fs::RowState st = fs::row_state<DIST>(s, row);
    const T* xr = xn + (size_t)r * cols;
    const float rowf = __fmul_rn(__uint2float_rn(row), fcols);
    if (L.vec) {
      for (int c0 = lane * V; c0 < cols; c0 += 32 * V * UNROLL) {
        uint4 buf[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = c0 + u * 32 * V;
          if (c < cols) buf[u] = __ldg(reinterpret_cast<const uint4*>(xr + c));
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = c0 + u * 32 * V;
          if (c < cols) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              const float p = product<DIST, MASKED>(
                  fs::vec_f32<T>(buf[u], j), st, L.col_offset + (uint32_t)(c + j),
                  rowf, lo_b, hi_b);
              if (j & 1) acc1 = __fadd_rn(acc1, p); else acc0 = __fadd_rn(acc0, p);
            }
          }
        }
      }
    } else {
      // Columns lane, lane + 64, ... into acc0; lane + 32, lane + 96, ... into acc1.
      for (int c = lane; c < cols; c += 64) {
        acc0 = __fadd_rn(acc0, product<DIST, MASKED>(
            fs::load_f32(xr + c), st, L.col_offset + (uint32_t)c, rowf, lo_b, hi_b));
        if (c + 32 < cols)
          acc1 = __fadd_rn(acc1, product<DIST, MASKED>(
              fs::load_f32(xr + c + 32), st, L.col_offset + (uint32_t)(c + 32), rowf,
              lo_b, hi_b));
      }
    }
  }
  return __fadd_rn(acc0, acc1);
}

// grid (tile walkers, k, n).  partials: (n, k, table.num_tiles).
template <int DIST, bool MASKED>
__global__ void __launch_bounds__(THREADS)
project_tree_kernel(const __grid_constant__ fs::TreeTable table,
                    const int64_t* __restrict__ seeds, const float* __restrict__ lo,
                    const float* __restrict__ hi, float* __restrict__ partials,
                    int k) {
  __shared__ float warp_sums[WARPS];
  const int b = blockIdx.y;
  const int n = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t seed = (uint32_t)seeds[n];
  float* out = partials + ((size_t)n * k + b) * table.num_tiles;
  for (long long t = blockIdx.x; t < table.num_tiles; t += gridDim.x) {
    const int l = fs::find_leaf(table, t);
    const fs::TreeLeaf& L = table.leaf[l];
    const int tile = (int)(t - L.tile0);
    float lo_b = 0.0f, hi_b = 0.0f;
    if (MASKED) {
      lo_b = lo[(size_t)l * k + b];
      hi_b = hi[(size_t)l * k + b];
      // Skip a tile whose flat range cannot meet the block.  The margin
      // keeps the test conservative against float32 rounding of the
      // per-element flat index; the element mask is exact.
      const double t_lo = ((double)L.row_offset + tile * TILE_ROWS) * L.orig_cols;
      const double t_hi = ((double)L.row_offset + tile * TILE_ROWS + TILE_ROWS)
                          * L.orig_cols;
      if (!(t_lo * (1.0 - 0x1p-20) - 1.0 < hi_b && t_hi * (1.0 + 0x1p-20) + 1.0 > lo_b)) {
        if (threadIdx.x == 0) out[t] = 0.0f;
        continue;   // uniform per block
      }
    }
    const uint32_t s = fs::block_leaf_seed(seed, (uint32_t)b, L.tag);
    const size_t leaf_elems = (size_t)L.rows * L.cols;
    float acc;
    if (L.dtype == fs::BF16)
      acc = tile_partial<__nv_bfloat16, DIST, MASKED>(
          L, static_cast<const __nv_bfloat16*>(L.x) + (size_t)n * leaf_elems, tile, s, lo_b,
          hi_b, warp, lane);
    else
      acc = tile_partial<float, DIST, MASKED>(
          L, static_cast<const float*>(L.x) + (size_t)n * leaf_elems, tile, s, lo_b, hi_b,
          warp, lane);
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = warp_sums[0];
      for (int w = 1; w < WARPS; ++w) v = __fadd_rn(v, warp_sums[w]);
      out[t] = v;
    }
    __syncthreads();
  }
}

// One warp per (n, j): each leaf's tiles summed by lanes striding over
// them and a fixed butterfly, then the leaves in table order from the
// first (or, with accumulate, from the value already in out: the sum of
// an earlier launch's leaves).
__global__ void sum_tree_partials_kernel(const __grid_constant__ fs::TreeTable table,
                                         const float* __restrict__ partials,
                                         float* __restrict__ out, int nk,
                                         int accumulate) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= nk) return;
  const float* p = partials + (size_t)w * table.num_tiles;
  float acc = accumulate ? out[w] : 0.0f;
  for (int l = 0; l < table.num_leaves; ++l) {
    const long long t0 = table.leaf[l].tile0;
    const long long t1 =
        l + 1 < table.num_leaves ? table.leaf[l + 1].tile0 : table.num_tiles;
    float s = 0.0f;
    for (long long t = t0 + lane; t < t1; t += 32) s = __fadd_rn(s, p[t]);
    s = warp_sum(s);
    acc = (l == 0 && !accumulate) ? s : __fadd_rn(acc, s);
  }
  if (lane == 0) out[w] = acc;
}

template <int DIST>
void launch(bool masked, dim3 grid, cudaStream_t st, const fs::TreeTable& table,
            const int64_t* seeds, const float* lo, const float* hi, float* partials,
            int k) {
  if (masked)
    project_tree_kernel<DIST, true><<<grid, THREADS, 0, st>>>(table, seeds, lo, hi,
                                                              partials, k);
  else
    project_tree_kernel<DIST, false><<<grid, THREADS, 0, st>>>(table, seeds, lo, hi,
                                                               partials, k);
}

}  // namespace

extern "C" int fs_project_tile_rows() { return TILE_ROWS; }

extern "C" int fs_tree_table_bytes() { return (int)sizeof(fs::TreeTable); }

// table: the leaves of this launch (host memory; copied into the launch
// by value); lo, hi: (table.num_leaves, k) float32 leaf-local block
// bounds, read only when masked (may be null otherwise); partials: (n, k,
// table.num_tiles) float32 scratch; out: (n, k) float32, added to when
// accumulate is set.  Returns cudaGetLastError() after both launches.
extern "C" int fs_project_tree(const fs::TreeTable* table, const int64_t* seeds,
                               const float* lo, const float* hi, float* partials,
                               float* out, int n, int k, int masked, int dist,
                               int accumulate, void* stream) {
  if (n <= 0 || k <= 0 || n > 65535 || k > 65535 || table->num_leaves <= 0
      || table->num_leaves > fs::MAX_TREE_LEAVES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (table->num_tiles > 0) {
    const dim3 grid(fs::grid_blocks(table->num_tiles, n * k), k, n);
    switch (dist) {
      case fs::RADEMACHER:
        launch<fs::RADEMACHER>(masked, grid, st, *table, seeds, lo, hi, partials, k);
        break;
      case fs::GAUSSIAN:
        launch<fs::GAUSSIAN>(masked, grid, st, *table, seeds, lo, hi, partials, k);
        break;
      case fs::SPARSE_RADEMACHER:
        launch<fs::SPARSE_RADEMACHER>(masked, grid, st, *table, seeds, lo, hi,
                                      partials, k);
        break;
      case fs::HADAMARD:
        launch<fs::HADAMARD>(masked, grid, st, *table, seeds, lo, hi, partials, k);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int nk = n * k;
  const int threads = 256;
  const int blocks = (nk * 32 + threads - 1) / threads;
  sum_tree_partials_kernel<<<blocks, threads, 0, st>>>(*table, partials, out, nk,
                                                       accumulate);
  return (int)cudaGetLastError();
}
