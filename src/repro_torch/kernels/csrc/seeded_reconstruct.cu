// Per-client server decode: y = x + scale * sum_b sum_n r[n,b] * (v[n,b] * mask_b).
//
// Replaces the TPU kernel repro/kernels/seeded_reconstruct.py::_rec_kernel.
// The numeric spec is the reference kernel's: blocks b = 0..k-1 in order,
// and within a block the clients n = 0..N-1 in order, each adding its
// product to one float32 accumulator per element:
//
//   v   = v[n,b](row, col)        seed fold_seed(splitmix32(xi ^ (PROJ_SALT + b)), tag)
//   v   = v * mask_b              (BLOCK mode only: 0/1 flat-index mask)
//   acc = acc + r[n,b] * v
//   y   = x + scale * acc     (x widened to float32; y rounded once to
//                              x's dtype, float32 or bf16, with _rn)
//
// The reference zero-pads the cohort to a multiple of min(32, N); padded
// slots add r * v = +-0, which leaves acc unchanged (acc starts at +0 and
// a round-to-nearest sum is -0 only when both terms are), so the kernel
// simply stops at N.  For the same reason a tile that meets no element of
// block b skips that block.  Every float op is an _rn intrinsic and the
// file is built with -fmad=false, so nothing is contracted into an FMA and
// the result equals the plain version bit for bit for the +-1/+-2
// families.  There are no atomics: the same inputs give the same bits.
//
// Bound on this card: x is read and y written once (8 bytes per element,
// 4 for bf16),
// against N*k*(one SplitMix32 round + value map + multiply + add) integer
// and float ops per element.  From a few clients up it is bound by the
// ALUs, exactly as the fused close (reconstruct_apply.cu) is: both do the
// same work per (element, client, block); only the order of the adds
// differs.
//
// Design.  One thread per output element; a thread block is a tile of
// TILE_R rows by TILE_C columns.  Clients are staged CHUNK at a time: the
// first CHUNK threads derive the chunk's per-block leaf-folded seeds and
// stage its scalars in shared memory, then CHUNK * TILE_R threads hoist
// the chain's row rounds for (client, row), so each element pays one
// mixer round per client.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int TILE_C = 32;
constexpr int TILE_R = 8;
constexpr int CHUNK = 32;   // CLIENT_CHUNK of the reference

template <typename T, int DIST, bool MASKED>
__global__ void __launch_bounds__(TILE_C * TILE_R)
rec_apply_kernel(const T* __restrict__ x, const uint32_t* __restrict__ seeds,
                 const float* __restrict__ rs, float scale,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 T* __restrict__ y, int n, int k, int rows, int cols,
                 uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
                 int orig_cols) {
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
    for (int base = 0; base < n; base += CHUNK) {
      const int m = min(CHUNK, n - base);
      __syncthreads();   // the previous chunk's shared reads are done
      if (tid < m) {
        const size_t i = (size_t)base + tid;
        s_seed[tid] = fs::block_leaf_seed(seeds[i], (uint32_t)b, leaf_tag);
        s_r[tid] = rs[i * k + b];
      }
      __syncthreads();
      if (tid < m * TILE_R) {
        const int i = tid / TILE_R;
        const int rr = tid % TILE_R;
        s_state[i][rr] = fs::row_state<DIST>(
            s_seed[i], row_offset + (uint32_t)(blockIdx.y * TILE_R + rr));
      }
      __syncthreads();
      if (valid) {
        for (int i = 0; i < m; ++i) {
          float v = fs::value_from_state<DIST>(s_state[i][threadIdx.y], col);
          if (MASKED) v = __fmul_rn(v, mask);
          acc = __fadd_rn(acc, __fmul_rn(s_r[i], v));
        }
      }
    }
  }
  if (valid) {
    const size_t idx = (size_t)r * cols + c;
    fs::store_rn(y + idx, __fadd_rn(fs::load_f32(x + idx), __fmul_rn(scale, acc)));
  }
}

template <typename T, int DIST>
void launch(bool masked, dim3 grid, cudaStream_t st, const T* x,
            const uint32_t* seeds, const float* rs, float scale, const float* lo,
            const float* hi, T* y, int n, int k, int rows, int cols,
            uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
            int orig_cols) {
  const dim3 block(TILE_C, TILE_R);
  if (masked)
    rec_apply_kernel<T, DIST, true><<<grid, block, 0, st>>>(
        x, seeds, rs, scale, lo, hi, y, n, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
  else
    rec_apply_kernel<T, DIST, false><<<grid, block, 0, st>>>(
        x, seeds, rs, scale, lo, hi, y, n, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
}

template <typename T>
bool launch_dist(int dist, bool masked, dim3 grid, cudaStream_t st,
                 const void* xv, const uint32_t* seeds, const float* rs,
                 float scale, const float* lo, const float* hi, void* yv, int n,
                 int k, int rows, int cols, uint32_t leaf_tag,
                 uint32_t row_offset, uint32_t col_offset, int orig_cols) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  switch (dist) {
    case fs::RADEMACHER:
      launch<T, fs::RADEMACHER>(masked, grid, st, x, seeds, rs, scale, lo, hi, y,
                                n, k, rows, cols, leaf_tag, row_offset,
                                col_offset, orig_cols);
      return true;
    case fs::GAUSSIAN:
      launch<T, fs::GAUSSIAN>(masked, grid, st, x, seeds, rs, scale, lo, hi, y,
                              n, k, rows, cols, leaf_tag, row_offset, col_offset,
                              orig_cols);
      return true;
    case fs::SPARSE_RADEMACHER:
      launch<T, fs::SPARSE_RADEMACHER>(masked, grid, st, x, seeds, rs, scale, lo,
                                       hi, y, n, k, rows, cols, leaf_tag,
                                       row_offset, col_offset, orig_cols);
      return true;
    case fs::HADAMARD:
      launch<T, fs::HADAMARD>(masked, grid, st, x, seeds, rs, scale, lo, hi, y,
                              n, k, rows, cols, leaf_tag, row_offset, col_offset,
                              orig_cols);
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int fs_rec_chunk() { return CHUNK; }

extern "C" int fs_rec_max_rows() { return 65535 * TILE_R; }

// x, y: (rows, cols) of dtype (fs::F32 or fs::BF16); seeds: (n,) uint32
// round seeds (unfolded); rs: (n, k) float32 with every aggregation weight
// folded in; lo/hi: (k,) leaf-local flat bounds.  Returns
// cudaGetLastError() after the launch.
extern "C" int fs_rec_apply(const void* x, const uint32_t* seeds,
                            const float* rs, float scale, const float* lo,
                            const float* hi, void* y, int n, int k, int rows,
                            int cols, uint32_t leaf_tag, uint32_t row_offset,
                            uint32_t col_offset, int orig_cols, int masked,
                            int dist, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (n < 0 || k <= 0 || (rows + TILE_R - 1) / TILE_R > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((cols + TILE_C - 1) / TILE_C, (rows + TILE_R - 1) / TILE_R);
  bool ok;
  if (dtype == fs::F32)
    ok = launch_dist<float>(dist, masked, grid, st, x, seeds, rs, scale, lo, hi,
                            y, n, k, rows, cols, leaf_tag, row_offset,
                            col_offset, orig_cols);
  else if (dtype == fs::BF16)
    ok = launch_dist<__nv_bfloat16>(dist, masked, grid, st, x, seeds, rs, scale,
                                    lo, hi, y, n, k, rows, cols, leaf_tag,
                                    row_offset, col_offset, orig_cols);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
