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
// Per-client rounding (modes ROUND_ONE for k = 1 and ROUND_ANY; the LLM
// train step's close): the reference's server_aggregate rounds each
// client's reconstruction to the leaf dtype before its float32 sum, and
// divides by N after it.  In this mode the clients come first, one by
// one, and within a client the blocks b = 0..k-1:
//
//   part = 0;  part = part + r[n,b] * (v[n,b] * mask_b)  for each b
//   acc  = acc + round_to_leaf_dtype(part)
//   y    = x + scale * (acc / div)     (scale = server_lr; div = N, or 1
//                                       with aggregation weights)
//
// bit for bit the port's core/fedscalar.server_aggregate for the +-1/+-2
// families (on a float32 leaf the rounding is the identity).
//
// Design.  One thread per output element; a thread block is a tile of
// TILE_R rows by TILE_C columns, and the blocks walk the row tiles with a
// grid-stride loop (gridDim.y is at most 65 535; a leaf may have more row
// tiles).  Clients are staged CHUNK at a time: the
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

// MODE: PLAIN, ROUND_ONE (per-client rounding, k = 1: a client's
// reconstruction is its one product, so no per-client partial is kept)
// or ROUND_ANY (per-client rounding, any k).
enum Mode : int { PLAIN = 0, ROUND_ONE = 1, ROUND_ANY = 2 };

template <typename T, int DIST, bool MASKED, int MODE>
__global__ void __launch_bounds__(TILE_C * TILE_R)
rec_apply_kernel(const T* __restrict__ x, const int64_t* __restrict__ seeds,
                 const float* __restrict__ rs, float scale, float div,
                 const float* __restrict__ lo, const float* __restrict__ hi,
                 T* __restrict__ y, int n, int k, int rows, int cols,
                 uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
                 int orig_cols) {
  __shared__ uint32_t s_seed[CHUNK];
  __shared__ float s_r[CHUNK];
  __shared__ fs::RowState s_state[CHUNK][TILE_R];

  const int c = blockIdx.x * TILE_C + threadIdx.x;
  const int tid = threadIdx.y * TILE_C + threadIdx.x;
  const uint32_t col = col_offset + (uint32_t)c;
  const int row_tiles = (rows + TILE_R - 1) / TILE_R;
  for (int tr = blockIdx.y; tr < row_tiles; tr += gridDim.y) {
    const int r = tr * TILE_R + threadIdx.y;
    const bool valid = r < rows && c < cols;
    const uint32_t row = row_offset + (uint32_t)r;
    const float flat = __fadd_rn(
        __fmul_rn(__uint2float_rn(row), __int2float_rn(orig_cols)), __uint2float_rn(col));

    // Stage chunk [base, base + m) of block b: per-block leaf-folded seeds,
    // scalars, and the row rounds of the chain for (client, row).
    auto stage = [&](int base, int m, int b) {
      __syncthreads();   // the previous chunk's shared reads are done
      if (tid < m) {
        const size_t i = (size_t)base + tid;
        s_seed[tid] = fs::block_leaf_seed((uint32_t)seeds[i], (uint32_t)b, leaf_tag);
        s_r[tid] = rs[i * k + b];
      }
      __syncthreads();
      if (tid < m * TILE_R) {
        const int i = tid / TILE_R;
        const int rr = tid % TILE_R;
        s_state[i][rr] = fs::row_state<DIST>(
            s_seed[i], row_offset + (uint32_t)(tr * TILE_R + rr));
      }
      __syncthreads();
    };
    // False when no element of this tile lies in block b (uniform per tile).
    auto meets = [&](int b, float& mask) {
      if (!MASKED) return true;
      const bool in_block = flat >= lo[b] && flat < hi[b];
      mask = in_block ? 1.0f : 0.0f;
      return __syncthreads_or(valid && in_block) != 0;
    };

    float acc = 0.0f;
    if (MODE != ROUND_ANY) {
      // ROUND_ONE: part = 0 + r * v differs from r * v only for -0, whose
      // rounding adds +-0 to an acc that is never -0: the same sum.
      for (int b = 0; b < k; ++b) {
        float mask = 1.0f;
        if (!meets(b, mask)) continue;
        for (int base = 0; base < n; base += CHUNK) {
          const int m = min(CHUNK, n - base);
          stage(base, m, b);
          if (valid) {
            for (int i = 0; i < m; ++i) {
              float v = fs::value_from_state<DIST>(s_state[i][threadIdx.y], col);
              if (MASKED) v = __fmul_rn(v, mask);
              const float p = __fmul_rn(s_r[i], v);
              acc = __fadd_rn(acc, MODE == ROUND_ONE ? fs::round_as(p, x) : p);
            }
          }
        }
      }
    } else {
      for (int base = 0; base < n; base += CHUNK) {
        const int m = min(CHUNK, n - base);
        float part[CHUNK];
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) part[i] = 0.0f;
        for (int b = 0; b < k; ++b) {
          float mask = 1.0f;
          if (!meets(b, mask)) continue;
          stage(base, m, b);
          if (valid) {
#pragma unroll
            for (int i = 0; i < CHUNK; ++i) {
              if (i < m) {
                float v = fs::value_from_state<DIST>(s_state[i][threadIdx.y], col);
                if (MASKED) v = __fmul_rn(v, mask);
                part[i] = __fadd_rn(part[i], __fmul_rn(s_r[i], v));
              }
            }
          }
        }
        if (valid) {
#pragma unroll
          for (int i = 0; i < CHUNK; ++i)
            if (i < m) acc = __fadd_rn(acc, fs::round_as(part[i], x));
        }
      }
    }
    if (valid) {
      const size_t idx = (size_t)r * cols + c;
      const float upd = MODE != PLAIN ? __fmul_rn(scale, __fdiv_rn(acc, div))
                                      : __fmul_rn(scale, acc);
      fs::store_rn(y + idx, __fadd_rn(fs::load_f32(x + idx), upd));
    }
  }
}

template <typename T, int DIST, int MODE>
void launch(bool masked, dim3 grid, cudaStream_t st, const T* x,
            const int64_t* seeds, const float* rs, float scale, float div,
            const float* lo, const float* hi, T* y, int n, int k, int rows, int cols,
            uint32_t leaf_tag, uint32_t row_offset, uint32_t col_offset,
            int orig_cols) {
  const dim3 block(TILE_C, TILE_R);
  if (masked)
    rec_apply_kernel<T, DIST, true, MODE><<<grid, block, 0, st>>>(
        x, seeds, rs, scale, div, lo, hi, y, n, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
  else
    rec_apply_kernel<T, DIST, false, MODE><<<grid, block, 0, st>>>(
        x, seeds, rs, scale, div, lo, hi, y, n, k, rows, cols, leaf_tag, row_offset,
        col_offset, orig_cols);
}

template <typename T, int DIST>
void launch_round(bool round, bool masked, dim3 grid, cudaStream_t st, const T* x,
                  const int64_t* seeds, const float* rs, float scale, float div,
                  const float* lo, const float* hi, T* y, int n, int k, int rows,
                  int cols, uint32_t leaf_tag, uint32_t row_offset,
                  uint32_t col_offset, int orig_cols) {
  if (round && k == 1)
    launch<T, DIST, ROUND_ONE>(masked, grid, st, x, seeds, rs, scale, div, lo, hi, y,
                               n, k, rows, cols, leaf_tag, row_offset, col_offset,
                               orig_cols);
  else if (round)
    launch<T, DIST, ROUND_ANY>(masked, grid, st, x, seeds, rs, scale, div, lo, hi, y,
                               n, k, rows, cols, leaf_tag, row_offset, col_offset,
                               orig_cols);
  else
    launch<T, DIST, PLAIN>(masked, grid, st, x, seeds, rs, scale, div, lo, hi, y, n,
                           k, rows, cols, leaf_tag, row_offset, col_offset, orig_cols);
}

template <typename T>
bool launch_dist(int dist, bool round, bool masked, dim3 grid, cudaStream_t st,
                 const void* xv, const int64_t* seeds, const float* rs, float scale,
                 float div, const float* lo, const float* hi, void* yv, int n, int k,
                 int rows, int cols, uint32_t leaf_tag, uint32_t row_offset,
                 uint32_t col_offset, int orig_cols) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
#define FS_REC_CASE(D)                                                            \
  case D:                                                                         \
    launch_round<T, D>(round, masked, grid, st, x, seeds, rs, scale, div, lo, hi, \
                       y, n, k, rows, cols, leaf_tag, row_offset, col_offset,     \
                       orig_cols);                                                \
    return true;
  switch (dist) {
    FS_REC_CASE(fs::RADEMACHER)
    FS_REC_CASE(fs::GAUSSIAN)
    FS_REC_CASE(fs::SPARSE_RADEMACHER)
    FS_REC_CASE(fs::HADAMARD)
    default:
      return false;
  }
#undef FS_REC_CASE
}

}  // namespace

extern "C" int fs_rec_chunk() { return CHUNK; }

// x, y: (rows, cols) of dtype (fs::F32 or fs::BF16); seeds: (n,) int64
// round seeds (unfolded; low 32 bits used); rs: (n, k) float32 with every
// aggregation weight folded in; lo/hi: (k,) leaf-local flat bounds, read
// only when masked (may be null otherwise); round selects per-client
// rounding, with div the divisor of its final sum.  Returns
// cudaGetLastError() after the launch.
extern "C" int fs_rec_apply(const void* x, const int64_t* seeds, const float* rs,
                            float scale, float div, const float* lo, const float* hi,
                            void* y, int n, int k, int rows, int cols,
                            uint32_t leaf_tag, uint32_t row_offset,
                            uint32_t col_offset, int orig_cols, int masked,
                            int round, int dist, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (n < 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_tiles = (rows + TILE_R - 1) / TILE_R;
  const dim3 grid((cols + TILE_C - 1) / TILE_C, row_tiles < 65535 ? row_tiles : 65535);
  bool ok;
  if (dtype == fs::F32)
    ok = launch_dist<float>(dist, round, masked, grid, st, x, seeds, rs, scale, div,
                            lo, hi, y, n, k, rows, cols, leaf_tag, row_offset,
                            col_offset, orig_cols);
  else if (dtype == fs::BF16)
    ok = launch_dist<__nv_bfloat16>(dist, round, masked, grid, st, x, seeds, rs,
                                    scale, div, lo, hi, y, n, k, rows, cols,
                                    leaf_tag, row_offset, col_offset, orig_cols);
  else
    ok = false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
