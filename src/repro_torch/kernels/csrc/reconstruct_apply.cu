// Fused server close: y = x + sum_b sum_chunks leftfold16((r[n,b] * v[n,b]) * mask_b).
//
// Replaces the TPU kernel repro/kernels/reconstruct_apply.py::_fused_kernel.
// The numeric spec is the reference's (reconstruct_apply.py docstring):
// the scale is folded into rs (f32(scale) * r, one rounding, here at
// staging), the cohort is zero-padded to a multiple of CHUNK = 16, and
// for each block b and each chunk c, in order, the 16 products
// (r * v) * mask are summed left to right from the first product, that
// sum is added to a float32 accumulator, and the result is a bare
// y = x + acc (x widened to float32, y rounded once to x's dtype, float32
// or bf16).  Every float op is an _rn intrinsic and the file is built
// with -fmad=false, so nothing is contracted into an FMA: the result
// equals the plain version bit for bit for the +-1/+-2 families.
//
// The padded slots are not computed.  A padded slot has r = +0, so its
// product is +-0 and leaves a nonzero partial sum unchanged; a partial
// sum that is +-0 may change sign, but acc starts at +0 and a
// round-to-nearest sum is -0 only when both terms are, so acc never
// holds -0 and acc + (+0) = acc + (-0).  The bits are those of the
// padded spec.
//
// Bound on this card: the kernel reads x and writes y, 8 bytes per
// element (8*d; 4*d for bf16), but does about N*k*d*(one SplitMix32
// round + value map + mul + add) integer and float ops.  From a cohort
// of a few clients up it is bound by the ALUs, not by HBM: that is the
// point of regenerating v from seeds instead of reading it (the TPU
// kernel's design, seeded_reconstruct.py).
//
// Design.  One launch covers every leaf of a tree (the leaf table of
// tree.cuh); blocks walk the flat tile space of all leaves with a
// grid-stride loop, which also leaves no limit on a leaf's rows.  A
// tile is TILE_R rows by TILE_C * V columns of one leaf, V = 16 bytes of
// the leaf's type (4 float32, 8 bf16) or, in the narrow tiles, 1; each
// thread owns V consecutive columns of one row and reads x and writes y
// with one 16-byte access where the leaf's rows are 16-byte aligned (else
// V scalar accesses).
//
// The tile is a knob (the TPU kernel's (br, bc), which its autotuner
// sweeps): TILES below lists the instantiations, fs_fused_tree takes one
// by its index, and kernels/tune.py picks one per workload.  The default
// (8, 32, V = 16 bytes) fits wide leaves; the paper MLP's widest leaf has
// 24 columns, so there a 128-column tile idles 13 lanes in 16 and the
// narrow tile (V = 1) idles 1 in 4.  Every tile gives the same bits: an
// element's sum order is fixed by the chunk spec (a left fold of 16, then
// acc +=, block by block, chunk by chunk), and the tile only decides which
// thread computes which element.  Constraints: TILE_C >= CHUNK (CHUNK *
// TILE_R threads stage the row states), TILE_R * TILE_C <= 1024 threads,
// and Staging within the 48 KB of static shared memory.
// For each (block, chunk) the first threads derive the chunk's per-block
// leaf-folded seeds fold_seed(splitmix32(seed ^ (PROJ_SALT + b)),
// leaf_tag) and stage its scaled scalars in shared memory, then
// CHUNK * TILE_R threads hoist the row rounds of the chain for (client,
// row), so each element pays one mixer round per client, and the staging
// is shared by the V columns of a thread.  In BLOCK mode a tile none of
// whose elements lies in block b skips that block, as the TPU kernel
// skips a tile that cannot meet the block; inside a tile the float32
// flat-index mask multiplies each product, as in the reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tree.cuh"

namespace {

constexpr int CHUNK = 16;   // FUSED_CHUNK: part of the numeric spec

// The tiles, in kernels/tree.py's CLOSE_TILES order: rows, threads across
// a row, and whether a thread owns a 16-byte vector (else one column).
struct TileShape {
  int rows, threads, vec;
};
constexpr TileShape TILES[] = {{8, 32, 1}, {16, 16, 1}, {32, 16, 1}, {4, 64, 1},
                               {8, 32, 0}};
constexpr int NUM_TILES = sizeof(TILES) / sizeof(TILES[0]);

template <int TILE_R>
struct Staging {
  uint32_t seed[CHUNK];
  float r[CHUNK];
  fs::RowState state[CHUNK][TILE_R];
};

template <typename T, int TILE_R, int TILE_C, bool VEC, int DIST, bool MASKED>
__device__ void close_tile(const fs::TreeLeaf& L, int tr, int tc,
                           const int64_t* __restrict__ seeds,
                           const float* __restrict__ rs, float scale,
                           const float* __restrict__ lo, const float* __restrict__ hi,
                           int n, int k, Staging<TILE_R>& sh) {
  static_assert(TILE_C >= CHUNK && TILE_R * TILE_C <= 1024, "tile shape");
  static_assert(sizeof(Staging<TILE_R>) <= 48 * 1024, "static shared memory");
  constexpr int V = VEC ? fs::VecOf<T>::V : 1;
  const int tx = threadIdx.x % TILE_C;
  const int ty = threadIdx.x / TILE_C;
  const int tid = threadIdx.x;
  const int r = tr * TILE_R + ty;
  const int c0 = (tc * TILE_C + tx) * V;
  const bool live = r < L.rows && c0 < L.cols;
  const uint32_t row = L.row_offset + (uint32_t)r;
  const float rowf = __fmul_rn(__uint2float_rn(row), __int2float_rn(L.orig_cols));

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (int b = 0; b < k; ++b) {
    float mask[V];
    if (MASKED) {
      const float lo_b = lo[b], hi_b = hi[b];
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float flat = __fadd_rn(rowf, __uint2float_rn(L.col_offset + (uint32_t)(c0 + j)));
        const bool in_block = flat >= lo_b && flat < hi_b;
        mask[j] = in_block ? 1.0f : 0.0f;
        any = any || (live && c0 + j < L.cols && in_block);
      }
      if (!__syncthreads_or(any)) continue;   // uniform per tile
    }
    for (int base = 0; base < n; base += CHUNK) {
      const int m = min(CHUNK, n - base);
      __syncthreads();   // the previous chunk's shared reads are done
      if (tid < m) {
        const size_t i = (size_t)base + tid;
        sh.seed[tid] = fs::block_leaf_seed((uint32_t)seeds[i], (uint32_t)b, L.tag);
        sh.r[tid] = __fmul_rn(scale, rs[i * k + b]);
      }
      __syncthreads();
      if (tid < m * TILE_R) {
        const int i = tid / TILE_R;
        const int rr = tid % TILE_R;
        sh.state[i][rr] = fs::row_state<DIST>(
            sh.seed[i], L.row_offset + (uint32_t)(tr * TILE_R + rr));
      }
      __syncthreads();
      if (live) {
        float s[V] = {};
#pragma unroll 4
        for (int i = 0; i < m; ++i) {
          const fs::RowState st = sh.state[i][ty];
          const float ri = sh.r[i];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            float p = __fmul_rn(ri, fs::value_from_state<DIST>(
                                        st, L.col_offset + (uint32_t)(c0 + j)));
            if (MASKED) p = __fmul_rn(p, mask[j]);
            s[j] = i == 0 ? p : __fadd_rn(s[j], p);
          }
        }
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], s[j]);
      }
    }
  }
  if (!live) return;
  const size_t idx = (size_t)r * L.cols + c0;
  const T* x = static_cast<const T*>(L.x) + idx;
  T* y = static_cast<T*>(L.y) + idx;
  if constexpr (VEC) {
    if (L.vec) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(x));
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = __fadd_rn(fs::vec_f32<T>(w, j), acc[j]);
      *reinterpret_cast<uint4*>(y) = fs::vec_pack<T>(out);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c0 + j < L.cols) fs::store_rn(y + j, __fadd_rn(fs::load_f32(x + j), acc[j]));
}

template <int TILE_R, int TILE_C, bool VEC, int DIST, bool MASKED>
__global__ void __launch_bounds__(TILE_C * TILE_R)
fused_tree_kernel(const __grid_constant__ fs::TreeTable table,
                  const int64_t* __restrict__ seeds, const float* __restrict__ rs,
                  float scale, const float* __restrict__ lo,
                  const float* __restrict__ hi, int n, int k) {
  __shared__ Staging<TILE_R> sh;
  for (long long t = blockIdx.x; t < table.num_tiles; t += gridDim.x) {
    const int l = fs::find_leaf(table, t);
    const fs::TreeLeaf& L = table.leaf[l];
    const long long local = t - L.tile0;
    const int tr = (int)(local / L.col_tiles);
    const int tc = (int)(local % L.col_tiles);
    const float* lo_l = MASKED ? lo + (size_t)l * k : nullptr;
    const float* hi_l = MASKED ? hi + (size_t)l * k : nullptr;
    if (L.dtype == fs::BF16)
      close_tile<__nv_bfloat16, TILE_R, TILE_C, VEC, DIST, MASKED>(
          L, tr, tc, seeds, rs, scale, lo_l, hi_l, n, k, sh);
    else
      close_tile<float, TILE_R, TILE_C, VEC, DIST, MASKED>(
          L, tr, tc, seeds, rs, scale, lo_l, hi_l, n, k, sh);
    __syncthreads();   // the next tile's staging waits for this tile's reads
  }
}

template <int TILE_R, int TILE_C, bool VEC, int DIST>
void launch(bool masked, int blocks, cudaStream_t st, const fs::TreeTable& table,
            const int64_t* seeds, const float* rs, float scale, const float* lo,
            const float* hi, int n, int k) {
  if (masked)
    fused_tree_kernel<TILE_R, TILE_C, VEC, DIST, true>
        <<<blocks, TILE_C * TILE_R, 0, st>>>(table, seeds, rs, scale, lo, hi, n, k);
  else
    fused_tree_kernel<TILE_R, TILE_C, VEC, DIST, false>
        <<<blocks, TILE_C * TILE_R, 0, st>>>(table, seeds, rs, scale, lo, hi, n, k);
}

// One tile's kernels for every family; false for an unknown family.
template <int I>
bool launch_tile(int dist, bool masked, int blocks, cudaStream_t st,
                 const fs::TreeTable& table, const int64_t* seeds, const float* rs,
                 float scale, const float* lo, const float* hi, int n, int k) {
  constexpr int R = TILES[I].rows, C = TILES[I].threads;
  constexpr bool VEC = TILES[I].vec != 0;
  switch (dist) {
    case fs::RADEMACHER:
      launch<R, C, VEC, fs::RADEMACHER>(masked, blocks, st, table, seeds, rs, scale, lo,
                                        hi, n, k);
      return true;
    case fs::GAUSSIAN:
      launch<R, C, VEC, fs::GAUSSIAN>(masked, blocks, st, table, seeds, rs, scale, lo,
                                      hi, n, k);
      return true;
    case fs::SPARSE_RADEMACHER:
      launch<R, C, VEC, fs::SPARSE_RADEMACHER>(masked, blocks, st, table, seeds, rs,
                                               scale, lo, hi, n, k);
      return true;
    case fs::HADAMARD:
      launch<R, C, VEC, fs::HADAMARD>(masked, blocks, st, table, seeds, rs, scale, lo,
                                      hi, n, k);
      return true;
    default:
      return false;
  }
}

}  // namespace

extern "C" int fs_fused_chunk() { return CHUNK; }

// The tiles for the wrapper's flat tile space: tile i is rows[i] rows by
// threads[i] * V columns (V = 16 / element bytes where vec[i], else 1).
extern "C" int fs_fused_num_tiles() { return NUM_TILES; }
extern "C" int fs_fused_tile(int i, int* rows, int* threads, int* vec) {
  if (i < 0 || i >= NUM_TILES) return -1;
  *rows = TILES[i].rows;
  *threads = TILES[i].threads;
  *vec = TILES[i].vec;
  return 0;
}

extern "C" int fs_fused_table_bytes() { return (int)sizeof(fs::TreeTable); }

// table: the leaves of this launch (x and y of each, host memory; copied
// into the launch by value); seeds: (n,) int64 round seeds (low 32 bits
// used); rs: (n, k) float32 with every weight folded in but the scale;
// lo, hi: (table.num_leaves, k) float32 leaf-local block bounds, read only
// when masked (may be null otherwise); tile: an index into TILES, the tile
// the table's tile space was laid out with.  The cohort is not padded: the
// kernel computes the padded spec's bits without the padded slots.
// Returns cudaGetLastError() after the launch.
extern "C" int fs_fused_tree(const fs::TreeTable* table, const int64_t* seeds,
                             const float* rs, float scale, const float* lo,
                             const float* hi, int n, int k, int masked, int dist,
                             int tile, void* stream) {
  if (n < 0 || k <= 0 || table->num_leaves <= 0
      || table->num_leaves > fs::MAX_TREE_LEAVES || tile < 0 || tile >= NUM_TILES)
    return (int)cudaErrorInvalidValue;
  if (table->num_tiles <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = fs::grid_blocks(table->num_tiles, 1);
  static_assert(NUM_TILES == 5, "one case per tile");
  bool known = false;
  switch (tile) {
    case 0:
      known = launch_tile<0>(dist, masked, blocks, st, *table, seeds, rs, scale, lo, hi,
                             n, k);
      break;
    case 1:
      known = launch_tile<1>(dist, masked, blocks, st, *table, seeds, rs, scale, lo, hi,
                             n, k);
      break;
    case 2:
      known = launch_tile<2>(dist, masked, blocks, st, *table, seeds, rs, scale, lo, hi,
                             n, k);
      break;
    case 3:
      known = launch_tile<3>(dist, masked, blocks, st, *table, seeds, rs, scale, lo, hi,
                             n, k);
      break;
    case 4:
      known = launch_tile<4>(dist, masked, blocks, st, *table, seeds, rs, scale, lo, hi,
                             n, k);
      break;
  }
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
