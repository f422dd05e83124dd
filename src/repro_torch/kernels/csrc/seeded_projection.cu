// Client encode r[n, j] = sum_i x[n, i] * v_j(seed_n)[i] * 1[i in block j].
//
// Replaces the TPU kernel repro/kernels/seeded_projection.py::_proj_kernel.
// One launch covers every client of a round for one leaf: x is
// (N, rows, cols) float32 or bf16 (widened exactly on load, as the TPU
// kernel's x.astype(float32)), seeds (N,) uint32 round seeds, and the
// result is float32 (N, k).  Per-block seeds are derived here as
// fold_seed(splitmix32(seed ^ (PROJ_SALT + j)), leaf_tag), and v is
// regenerated from (seed, row, col) by the factored chain of chain.cuh:
// it never exists in device memory.
//
// Bound on this card: the kernel must read x once, 4 bytes (bf16: 2) per
// element per client, and writes N*k floats.  The chain costs one
// SplitMix32 round (~10 integer ops) plus the value map per element per
// block; at k = 1 that sits near the ratio where the 3.35 TB/s of HBM
// and the integer ALUs take about the same time.
//
// Design.  The TPU grid runs in order and sums into one output cell
// across grid steps; a Hopper grid runs in parallel, so here each
// thread block (one tile of TILE_ROWS rows, one block j, one client n)
// writes one partial sum to scratch that the wrapper allocates, and a
// second pass sums the partials of each (n, j) in a fixed order.  No
// float atomics: the encode gives the same bits run after run.  Inside
// a tile each warp takes one row at a time, so the row rounds of the
// chain run once per row and the lanes stride along the row
// (coalesced).  The ragged edge is masked here; the leaf is not padded.
// In BLOCK mode a tile whose flat range cannot meet block j is skipped,
// and inside a tile an element counts only if its float32 flat index
// lies in [lo_j, hi_j), as in the reference; masked = 0 (k = 1 and FULL
// mode) runs the body with no mask at all.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_ROWS = 32;

__device__ __forceinline__ float warp_sum(float v) {
  // Fixed butterfly order: deterministic.
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int DIST, bool MASKED>
__global__ void __launch_bounds__(THREADS)
project_kernel(const T* __restrict__ x, const uint32_t* __restrict__ seeds,
               const float* __restrict__ lo, const float* __restrict__ hi,
               float* __restrict__ partials, int k, int rows, int cols,
               uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
               int orig_cols) {
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n = blockIdx.z;
  const int r0 = tile * TILE_ROWS;
  float* out = partials + ((size_t)n * k + b) * gridDim.x + tile;
  __shared__ float warp_sums[WARPS];

  float lo_b = 0.0f, hi_b = 0.0f;
  const float fcols = __int2float_rn(orig_cols);
  if (MASKED) {
    lo_b = lo[b];
    hi_b = hi[b];
    // Skip a tile whose flat range cannot meet the block.  The margin
    // keeps the test conservative against float32 rounding of the
    // per-element flat index; the element mask below is exact.
    const double t_lo = ((double)row_offset + r0) * orig_cols;
    const double t_hi = ((double)row_offset + r0 + TILE_ROWS) * orig_cols;
    if (!(t_lo * (1.0 - 0x1p-20) - 1.0 < hi_b && t_hi * (1.0 + 0x1p-20) + 1.0 > lo_b)) {
      if (threadIdx.x == 0) *out = 0.0f;
      return;
    }
  }

  const uint32_t s = fs::block_leaf_seed(seeds[n], (uint32_t)b, leaf_tag);
  const T* xn = x + (size_t)n * rows * cols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r_end = min(r0 + TILE_ROWS, rows);
  float acc = 0.0f;
  for (int r = r0 + warp; r < r_end; r += WARPS) {
    const uint32_t row = row_offset + (uint32_t)r;
    const fs::RowState st = fs::row_state<DIST>(s, row);
    const T* xr = xn + (size_t)r * cols;
    const float rowf = __fmul_rn(__uint2float_rn(row), fcols);
    for (int c = lane; c < cols; c += 32) {
      const uint32_t col = col_offset + (uint32_t)c;
      float p = __fmul_rn(fs::load_f32(xr + c), fs::value_from_state<DIST>(st, col));
      if (MASKED) {
        const float flat = __fadd_rn(rowf, __uint2float_rn(col));
        p = __fmul_rn(p, (flat >= lo_b && flat < hi_b) ? 1.0f : 0.0f);
      }
      acc = __fadd_rn(acc, p);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = warp_sums[0];
    for (int w = 1; w < WARPS; ++w) t = __fadd_rn(t, warp_sums[w]);
    *out = t;
  }
}

// One warp per (n, j): lanes stride over the tiles, then a fixed butterfly.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int num_tiles,
                                    int nk) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= nk) return;
  const float* p = partials + (size_t)w * num_tiles;
  float acc = 0.0f;
  for (int t = lane; t < num_tiles; t += 32) acc = __fadd_rn(acc, p[t]);
  acc = warp_sum(acc);
  if (lane == 0) out[w] = acc;
}

template <typename T, int DIST>
void launch(bool masked, dim3 grid, cudaStream_t st, const T* x,
            const uint32_t* seeds, const float* lo, const float* hi,
            float* partials, int k, int rows, int cols, uint32_t leaf_tag,
            uint32_t row_offset, uint32_t col_offset, int orig_cols) {
  if (masked)
    project_kernel<T, DIST, true><<<grid, THREADS, 0, st>>>(
        x, seeds, lo, hi, partials, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
  else
    project_kernel<T, DIST, false><<<grid, THREADS, 0, st>>>(
        x, seeds, lo, hi, partials, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
}

template <typename T>
bool launch_dist(int dist, bool masked, dim3 grid, cudaStream_t st,
                 const void* xv, const uint32_t* seeds, const float* lo,
                 const float* hi, float* partials, int k, int rows, int cols,
                 uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
                 int orig_cols) {
  const T* x = static_cast<const T*>(xv);
  switch (dist) {
    case fs::RADEMACHER:
      launch<T, fs::RADEMACHER>(masked, grid, st, x, seeds, lo, hi, partials, k,
                                rows, cols, leaf_tag, row_offset, col_offset,
                                orig_cols);
      return true;
    case fs::GAUSSIAN:
      launch<T, fs::GAUSSIAN>(masked, grid, st, x, seeds, lo, hi, partials, k,
                              rows, cols, leaf_tag, row_offset, col_offset,
                              orig_cols);
      return true;
    case fs::SPARSE_RADEMACHER:
      launch<T, fs::SPARSE_RADEMACHER>(masked, grid, st, x, seeds, lo, hi,
                                       partials, k, rows, cols, leaf_tag,
                                       row_offset, col_offset, orig_cols);
      return true;
    case fs::HADAMARD:
      launch<T, fs::HADAMARD>(masked, grid, st, x, seeds, lo, hi, partials, k,
                              rows, cols, leaf_tag, row_offset, col_offset,
                              orig_cols);
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int fs_project_tile_rows() { return TILE_ROWS; }

// x: (n, rows, cols) of dtype (fs::F32 or fs::BF16); partials: (n, k,
// ceil(rows / TILE_ROWS)) float32 scratch; out: (n, k) float32.
// Returns cudaGetLastError() after both launches.
extern "C" int fs_project(const void* x, const uint32_t* seeds,
                          const float* lo, const float* hi, float* partials,
                          float* out, int n, int k, int rows, int cols,
                          uint32_t leaf_tag, uint32_t row_offset,
                          uint32_t col_offset, int orig_cols, int masked,
                          int dist, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int num_tiles = (rows + TILE_ROWS - 1) / TILE_ROWS;
  dim3 grid(num_tiles, k, n);
  bool ok;
  if (dtype == fs::F32)
    ok = launch_dist<float>(dist, masked, grid, st, x, seeds, lo, hi, partials,
                            k, rows, cols, leaf_tag, row_offset, col_offset,
                            orig_cols);
  else if (dtype == fs::BF16)
    ok = launch_dist<__nv_bfloat16>(dist, masked, grid, st, x, seeds, lo, hi,
                                    partials, k, rows, cols, leaf_tag,
                                    row_offset, col_offset, orig_cols);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nk = n * k;
  const int threads = 256;
  const int blocks = (nk * 32 + threads - 1) / threads;
  sum_partials_kernel<<<blocks, threads, 0, st>>>(partials, out, num_tiles, nk);
  return (int)cudaGetLastError();
}
