// QSGD stochastic quantize -> dequantize for every client of a cohort, one leaf.
//
// Replaces the TPU kernel repro/kernels/qsgd_quant.py::_qsgd_kernel.  The
// numeric spec is the reference's (qsgd_quant.py, core/qsgd.py), in its op
// order, float32 throughout:
//
//   u      = (f32(hash_u32(seed, row, col, QSGD_TAG)) + 1) * 2^-32
//   scaled = (|x| / norm) * L
//   level  = floor(scaled) + (u < scaled - floor(scaled))
//   signed = sign(x) * level                       (the wire's level code)
//   q      = ((norm * sign(x)) * level) / L
//
// x is float32 or bf16 (widened exactly on load); q is written in x's
// dtype (rounded once, as the TPU kernel's q.astype(o_ref.dtype)) and
// the levels in float32.  With seed the leaf-folded client seed and (row, col) the coordinates of
// the leaf's 2-D view.  The norm is computed outside the kernel, as in the
// reference, and arrives with a zero norm already replaced by 1.  Every
// float op is an _rn intrinsic (IEEE division, no fast math) and the file
// is built with -fmad=false, so the result equals the plain version bit
// for bit.
//
// Bound on this card: per element the kernel reads 4 bytes of x (bf16: 2)
// and writes 4 bytes of q (bf16: 2) and/or 4 bytes of levels, against one SplitMix32 round (the
// seed and row rounds are hoisted) and about ten float ops.  That is a few
// integer ops per byte, below the card's ops-to-bytes ratio, so it is bound
// by HBM: the design keeps to one pass that reads x once and writes both
// outputs from registers, with coalesced rows.
//
// Design.  Grid (column tiles, row tiles, clients); a thread block is
// TILE_R rows by TILE_C columns, one thread per element, and the blocks
// walk the row tiles with a grid-stride loop (gridDim.y is at most
// 65 535; a leaf may have more row tiles).  The first TILE_R
// threads hoist the chain's seed and row rounds for the tile's rows into
// shared memory, so each element pays one mixer round.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int TILE_C = 128;
constexpr int TILE_R = 4;
constexpr uint32_t QSGD_TAG = 0x7FEB352Du;   // repro.core.qsgd.QSGD_TAG

template <typename T>
__global__ void __launch_bounds__(TILE_C * TILE_R)
qsgd_kernel(const T* __restrict__ x, const uint32_t* __restrict__ seeds,
            const float* __restrict__ norms, T* __restrict__ q,
            float* __restrict__ lv, int rows, int cols, int levels,
            uint32_t row_offset, uint32_t col_offset) {
  __shared__ uint32_t s_state[TILE_R];
  const int n = blockIdx.z;
  const int c = blockIdx.x * TILE_C + threadIdx.x;
  const int tid = threadIdx.y * TILE_C + threadIdx.x;
  const int row_tiles = (rows + TILE_R - 1) / TILE_R;
  const float norm = norms[n];
  const float fl = (float)levels;
  for (int tr = blockIdx.y; tr < row_tiles; tr += gridDim.y) {
    __syncthreads();   // the previous row tile's reads of s_state are done
    if (tid < TILE_R) {
      const uint32_t row = row_offset + (uint32_t)(tr * TILE_R + tid);
      // hash_u32(seed, row, col, tag): the first two of its three rounds.
      s_state[tid] = fs::splitmix32(fs::splitmix32(seeds[n] ^ QSGD_TAG) ^ row);
    }
    __syncthreads();
    const int r = tr * TILE_R + threadIdx.y;
    if (r >= rows || c >= cols) continue;

    const size_t idx = ((size_t)n * rows + r) * cols + c;
    const float xv = fs::load_f32(x + idx);
    const float u = fs::uniform01(
        fs::splitmix32(s_state[threadIdx.y] ^ (col_offset + (uint32_t)c)));
    const float scaled = __fmul_rn(__fdiv_rn(fabsf(xv), norm), fl);
    const float lo = floorf(scaled);
    const float level = __fadd_rn(lo, (u < __fsub_rn(scaled, lo)) ? 1.0f : 0.0f);
    const float sign = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : 0.0f);
    if (lv != nullptr) lv[idx] = __fmul_rn(sign, level);
    if (q != nullptr)
      fs::store_rn(q + idx, __fdiv_rn(__fmul_rn(__fmul_rn(norm, sign), level), fl));
  }
}

template <typename T>
int launch(const void* x, const uint32_t* seeds, const float* norms, void* q,
           float* lv, int n, int rows, int cols, int levels,
           uint32_t row_offset, uint32_t col_offset, cudaStream_t st) {
  const int row_tiles = (rows + TILE_R - 1) / TILE_R;
  const dim3 grid((cols + TILE_C - 1) / TILE_C, row_tiles < 65535 ? row_tiles : 65535,
                  n);
  const dim3 block(TILE_C, TILE_R);
  qsgd_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(x), seeds, norms, static_cast<T*>(q), lv, rows, cols,
      levels, row_offset, col_offset);
  return (int)cudaGetLastError();
}

}  // namespace

// x, q: (n, rows, cols) of dtype (fs::F32 or fs::BF16), lv: the same
// shape in float32 (q or lv may be null); seeds: (n,) leaf-folded uint32;
// norms: (n,) float32, nonzero.  Returns cudaGetLastError() after the
// launch.
extern "C" int fs_qsgd(const void* x, const uint32_t* seeds, const float* norms,
                       void* q, float* lv, int n, int rows, int cols, int levels,
                       uint32_t row_offset, uint32_t col_offset, int dtype,
                       void* stream) {
  if (n <= 0 || rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (n > 65535 || (q == nullptr && lv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == fs::F32)
    return launch<float>(x, seeds, norms, q, lv, n, rows, cols, levels,
                         row_offset, col_offset, st);
  if (dtype == fs::BF16)
    return launch<__nv_bfloat16>(x, seeds, norms, q, lv, n, rows, cols, levels,
                                 row_offset, col_offset, st);
  return (int)cudaErrorInvalidValue;
}
