// Fused server close: y = x + sum_b sum_chunks leftfold16((r[n,b] * v[n,b]) * mask_b).
//
// Replaces the TPU kernel repro/kernels/reconstruct_apply.py::_fused_kernel.
// The numeric spec is the reference's (reconstruct_apply.py docstring):
// the scale is folded into rs on the host, the cohort is zero-padded to
// a multiple of CHUNK = 16, and for each block b and each chunk c, in
// order, the 16 products (r * v) * mask are summed left to right from
// the first product, that sum is added to a float32 accumulator, and
// the result is a bare y = x + acc (x widened to float32, y rounded once
// to x's dtype, float32 or bf16).  Every float op is an _rn intrinsic
// and the file is built with -fmad=false, so nothing is contracted into
// an FMA: the result equals the plain version bit for bit for the ±1/±2
// families.
//
// Bound on this card: the kernel reads x and writes y, 8 bytes per
// element (8*d; 4*d for bf16), but does about N*k*d*(one SplitMix32 round + value map
// + mul + add) integer and float ops.  From a cohort of a few clients
// up it is bound by the ALUs, not by HBM: that is the point of
// regenerating v from seeds instead of reading it (the TPU kernel's
// design, seeded_reconstruct.py).
//
// Design.  One thread per output element; a thread block is a tile of
// TILE_R rows by TILE_C columns.  For each (block, chunk) the first
// CHUNK threads derive the chunk's per-block leaf-folded seeds
// fold_seed(splitmix32(seed ^ (PROJ_SALT + b)), leaf_tag) and stage its
// scalars in shared memory, then CHUNK * TILE_R threads hoist the row
// rounds of the chain for (client, row), so each element pays one mixer
// round per client.  In BLOCK mode a tile none of whose elements lies in
// block b skips that block, as the TPU kernel skips a tile that cannot
// meet the block; inside a tile the float32 flat-index mask multiplies
// each product, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int TILE_C = 32;
constexpr int TILE_R = 8;
constexpr int CHUNK = 16;   // FUSED_CHUNK: part of the numeric spec

template <typename T, int DIST, bool MASKED>
__global__ void __launch_bounds__(TILE_C * TILE_R)
fused_apply_kernel(const T* __restrict__ x, const uint32_t* __restrict__ seeds,
                   const float* __restrict__ rs, const float* __restrict__ lo,
                   const float* __restrict__ hi, T* __restrict__ y,
                   int num_chunks, int k, int rows, int cols, uint32_t leaf_tag,
                   uint32_t row_offset, uint32_t col_offset, int orig_cols) {
  __shared__ uint32_t s_seed[CHUNK];
  __shared__ float s_r[CHUNK];
  __shared__ fs::RowState s_state[CHUNK][TILE_R];

  const int c = blockIdx.x * TILE_C + threadIdx.x;
  const int r = blockIdx.y * TILE_R + threadIdx.y;
  const int tid = threadIdx.y * TILE_C + threadIdx.x;
  const bool valid = r < rows && c < cols;
  const uint32_t row = row_offset + (uint32_t)r;
  const uint32_t col = col_offset + (uint32_t)c;
  const float flat = __fadd_rn(__fmul_rn(__uint2float_rn(row), __int2float_rn(orig_cols)),
                               __uint2float_rn(col));

  float acc = 0.0f;
  for (int b = 0; b < k; ++b) {
    float mask = 1.0f;
    if (MASKED) {
      const bool in_block = flat >= lo[b] && flat < hi[b];
      mask = in_block ? 1.0f : 0.0f;
      if (!__syncthreads_or(valid && in_block)) continue;   // uniform per tile
    }
    for (int ch = 0; ch < num_chunks; ++ch) {
      __syncthreads();   // the previous chunk's shared reads are done
      if (tid < CHUNK) {
        const size_t i = (size_t)ch * CHUNK + tid;
        s_seed[tid] = fs::block_leaf_seed(seeds[i], (uint32_t)b, leaf_tag);
        s_r[tid] = rs[i * k + b];
      }
      __syncthreads();
      if (tid < CHUNK * TILE_R) {
        const int i = tid / TILE_R;
        const int rr = tid % TILE_R;
        s_state[i][rr] = fs::row_state<DIST>(
            s_seed[i], row_offset + (uint32_t)(blockIdx.y * TILE_R + rr));
      }
      __syncthreads();
      if (valid) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          float p = __fmul_rn(s_r[i],
                              fs::value_from_state<DIST>(s_state[i][threadIdx.y], col));
          if (MASKED) p = __fmul_rn(p, mask);
          s = (i == 0) ? p : __fadd_rn(s, p);
        }
        acc = __fadd_rn(acc, s);
      }
    }
  }
  if (valid) {
    const size_t idx = (size_t)r * cols + c;
    fs::store_rn(y + idx, __fadd_rn(fs::load_f32(x + idx), acc));
  }
}

template <typename T, int DIST>
void launch(bool masked, dim3 grid, cudaStream_t st, const T* x,
            const uint32_t* seeds, const float* rs, const float* lo,
            const float* hi, T* y, int num_chunks, int k, int rows, int cols,
            uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
            int orig_cols) {
  const dim3 block(TILE_C, TILE_R);
  if (masked)
    fused_apply_kernel<T, DIST, true><<<grid, block, 0, st>>>(
        x, seeds, rs, lo, hi, y, num_chunks, k, rows, cols, leaf_tag,
        row_offset, col_offset, orig_cols);
  else
    fused_apply_kernel<T, DIST, false><<<grid, block, 0, st>>>(
        x, seeds, rs, lo, hi, y, num_chunks, k, rows, cols, leaf_tag,
        row_offset, col_offset, orig_cols);
}

template <typename T>
bool launch_dist(int dist, bool masked, dim3 grid, cudaStream_t st,
                 const void* xv, const uint32_t* seeds, const float* rs,
                 const float* lo, const float* hi, void* yv, int num_chunks,
                 int k, int rows, int cols, uint32_t leaf_tag,
                 uint32_t row_offset, uint32_t col_offset, int orig_cols) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  switch (dist) {
    case fs::RADEMACHER:
      launch<T, fs::RADEMACHER>(masked, grid, st, x, seeds, rs, lo, hi, y,
                                num_chunks, k, rows, cols, leaf_tag, row_offset,
                                col_offset, orig_cols);
      return true;
    case fs::GAUSSIAN:
      launch<T, fs::GAUSSIAN>(masked, grid, st, x, seeds, rs, lo, hi, y,
                              num_chunks, k, rows, cols, leaf_tag, row_offset,
                              col_offset, orig_cols);
      return true;
    case fs::SPARSE_RADEMACHER:
      launch<T, fs::SPARSE_RADEMACHER>(masked, grid, st, x, seeds, rs, lo, hi, y,
                                       num_chunks, k, rows, cols, leaf_tag,
                                       row_offset, col_offset, orig_cols);
      return true;
    case fs::HADAMARD:
      launch<T, fs::HADAMARD>(masked, grid, st, x, seeds, rs, lo, hi, y,
                              num_chunks, k, rows, cols, leaf_tag, row_offset,
                              col_offset, orig_cols);
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int fs_fused_chunk() { return CHUNK; }

extern "C" int fs_fused_max_rows() { return 65535 * TILE_R; }

// x, y: (rows, cols) of dtype (fs::F32 or fs::BF16); seeds: (n_pad,)
// uint32; rs: (n_pad, k) float32 with the scale folded in; n_pad is a
// multiple of CHUNK.  Returns cudaGetLastError() after the launch.
extern "C" int fs_fused_apply(const void* x, const uint32_t* seeds,
                              const float* rs, const float* lo, const float* hi,
                              void* y, int n_pad, int k, int rows, int cols,
                              uint32_t leaf_tag, uint32_t row_offset,
                              uint32_t col_offset, int orig_cols, int masked,
                              int dist, int dtype, void* stream) {
  if (n_pad % CHUNK != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int num_chunks = n_pad / CHUNK;
  const dim3 grid((cols + TILE_C - 1) / TILE_C, (rows + TILE_R - 1) / TILE_R);
  bool ok;
  if (dtype == fs::F32)
    ok = launch_dist<float>(dist, masked, grid, st, x, seeds, rs, lo, hi, y,
                            num_chunks, k, rows, cols, leaf_tag, row_offset,
                            col_offset, orig_cols);
  else if (dtype == fs::BF16)
    ok = launch_dist<__nv_bfloat16>(dist, masked, grid, st, x, seeds, rs, lo, hi,
                                    y, num_chunks, k, rows, cols, leaf_tag,
                                    row_offset, col_offset, orig_cols);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
