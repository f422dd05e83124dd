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
// families (on a float32 leaf the rounding is the identity).  ROUND_ONE
// adds round(r * v) directly: part = 0 + r * v differs from r * v only
// for -0, whose rounding adds +-0 to an acc that is never -0.
//
// Bound on this card: x is read and y written once (8 bytes per element,
// 4 for bf16), against N*k*(one SplitMix32 round + value map + multiply +
// add) integer and float ops per element.  From a few clients up it is
// bound by the ALUs, as the fused close (reconstruct_apply.cu) is: both
// do the same work per (element, client, block); only the order of the
// adds differs.
//
// Design.  One launch covers every leaf of a tree (the leaf table of
// tree.cuh, passed by value); blocks walk one flat tile space over all
// leaves with a grid-stride loop.  A tile is TILE_R rows by TILE_C * V
// columns of one leaf; each thread owns V consecutive columns of one row.
// V is chosen once per launch by the wrapper (kernels/tree.py's
// decode_vector): 16 bytes of the leaf's type (4 float32, 8 bf16, with
// 16-byte x/y accesses where the leaf's rows are aligned) when the launch
// has enough tiles to fill the card, else 1 (a small tree such as the
// paper MLP's, whose leaves are narrower than one vector tile).
//
// The tile's sum runs over a flat sequence of (client, block) pairs in the
// mode's order: block-major for PLAIN, client-major for the rounding
// modes, over the blocks the tile meets.  SLOTS pairs are staged at a time:
// their scalars, and the chain's row rounds for each (pair, row) of the
// tile, so an element pays one mixer round per pair and one staging serves
// the V columns of a thread.  Two barriers per SLOTS pairs.  A rounding
// mode keeps one partial sum per column, flushed into acc at each
// client's last pair: no per-client arrays, whatever k is.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tree.cuh"

namespace {

constexpr int TILE_C = 32;
constexpr int TILE_R = 8;
constexpr int THREADS = TILE_C * TILE_R;
constexpr int SLOTS = 128;        // (client, block) pairs staged at once
constexpr int MAX_LISTED = 64;    // blocks listed per tile; a larger k lists all

// MODE: PLAIN, ROUND_ONE (per-client rounding, k = 1) or ROUND_ANY
// (per-client rounding, any k).
enum Mode : int { PLAIN = 0, ROUND_ONE = 1, ROUND_ANY = 2 };

struct Staging {
  fs::RowState state[SLOTS][TILE_R];
  float r[SLOTS];
  float lo[SLOTS], hi[SLOTS];     // MASKED: the pair's block bounds
  int last[SLOTS];                // ROUND_ANY: the pair is its client's last
  int blocks[MAX_LISTED];         // MASKED: the blocks this tile meets
};

template <typename T, int DIST, bool MASKED, int MODE, bool VEC>
__device__ void decode_tile(const fs::TreeLeaf& L, int tr, int tc,
                            const int64_t* __restrict__ seeds,
                            const float* __restrict__ rs, float scale, float div,
                            const float* __restrict__ lo, const float* __restrict__ hi,
                            int n, int k, Staging& sh) {
  constexpr int V = VEC ? fs::VecOf<T>::V : 1;
  const int tx = threadIdx.x % TILE_C;
  const int ty = threadIdx.x / TILE_C;
  const int tid = threadIdx.x;
  const int r = tr * TILE_R + ty;
  const int c0 = (tc * TILE_C + tx) * V;
  const bool live = r < L.rows && c0 < L.cols;
  const uint32_t row = L.row_offset + (uint32_t)r;
  const uint32_t tagmix = fs::splitmix32(L.tag);   // fold_seed's leaf half

  uint32_t col[V];
  float flat[V];
  const float rowf =
      MASKED ? __fmul_rn(__uint2float_rn(row), __int2float_rn(L.orig_cols)) : 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    col[j] = L.col_offset + (uint32_t)(c0 + j);
    flat[j] = MASKED ? __fadd_rn(rowf, __uint2float_rn(col[j])) : 0.0f;
  }

  // The blocks this tile meets, in order: the others add only +-0.
  const bool listed = MASKED && k <= MAX_LISTED;
  int nb = k;
  if (listed) {
    nb = 0;
    for (int b = 0; b < k; ++b) {
      const float lo_b = lo[b], hi_b = hi[b];
      bool any = false;
#pragma unroll
      for (int j = 0; j < V; ++j)
        any = any || (live && c0 + j < L.cols && flat[j] >= lo_b && flat[j] < hi_b);
      if (__syncthreads_or(any)) {   // uniform per tile
        if (tid == 0) sh.blocks[nb] = b;
        ++nb;
      }
    }
  }

  float acc[V], part[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = part[j] = 0.0f;
  const int pairs = n * nb;
  for (int p0 = 0; p0 < pairs; p0 += SLOTS) {
    const int m = min(SLOTS, pairs - p0);
    __syncthreads();   // the previous stage's reads are done; sh.blocks is visible
    for (int s = tid; s < m * TILE_R; s += THREADS) {
      const int slot = s / TILE_R;
      const int rr = s % TILE_R;
      const int p = p0 + slot;
      int i, j;
      if (MODE == ROUND_ANY) { i = p / nb; j = p % nb; }
      else                   { j = p / n;  i = p % n;  }
      const int b = listed ? sh.blocks[j] : j;
      const uint32_t seed = fs::splitmix32(
          fs::splitmix32((uint32_t)seeds[i] ^ (fs::PROJ_SALT + (uint32_t)b)) ^ tagmix);
      sh.state[slot][rr] =
          fs::row_state<DIST>(seed, L.row_offset + (uint32_t)(tr * TILE_R + rr));
      if (rr == 0) {
        sh.r[slot] = rs[(size_t)i * k + b];
        if (MASKED) {
          sh.lo[slot] = lo[b];
          sh.hi[slot] = hi[b];
        }
        if (MODE == ROUND_ANY) sh.last[slot] = j == nb - 1;
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int s = 0; s < m; ++s) {
        const fs::RowState st = sh.state[s][ty];
        const float ri = sh.r[s];
        const float lo_s = MASKED ? sh.lo[s] : 0.0f;
        const float hi_s = MASKED ? sh.hi[s] : 0.0f;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float v = fs::value_from_state<DIST>(st, col[j]);
          if (MASKED) v = __fmul_rn(v, flat[j] >= lo_s && flat[j] < hi_s ? 1.0f : 0.0f);
          const float prod = __fmul_rn(ri, v);
          if (MODE == PLAIN)
            acc[j] = __fadd_rn(acc[j], prod);
          else if (MODE == ROUND_ONE)
            acc[j] = __fadd_rn(acc[j], fs::round_as(prod, (const T*)nullptr));
          else
            part[j] = __fadd_rn(part[j], prod);
        }
        if (MODE == ROUND_ANY && sh.last[s]) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            acc[j] = __fadd_rn(acc[j], fs::round_as(part[j], (const T*)nullptr));
            part[j] = 0.0f;
          }
        }
      }
    }
  }
  if (!live) return;
  const size_t idx = (size_t)r * L.cols + c0;
  const T* x = static_cast<const T*>(L.x) + idx;
  T* y = static_cast<T*>(L.y) + idx;
  float upd[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    upd[j] = MODE != PLAIN ? __fmul_rn(scale, __fdiv_rn(acc[j], div))
                           : __fmul_rn(scale, acc[j]);
  if constexpr (VEC) {
    if (L.vec) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(x));
      float out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = __fadd_rn(fs::vec_f32<T>(w, j), upd[j]);
      *reinterpret_cast<uint4*>(y) = fs::vec_pack<T>(out);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c0 + j < L.cols) fs::store_rn(y + j, __fadd_rn(fs::load_f32(x + j), upd[j]));
}

template <int DIST, bool MASKED, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
decode_tree_kernel(const __grid_constant__ fs::TreeTable table,
                   const int64_t* __restrict__ seeds, const float* __restrict__ rs,
                   float scale, float div, const float* __restrict__ lo,
                   const float* __restrict__ hi, int n, int k) {
  __shared__ Staging sh;
  for (long long t = blockIdx.x; t < table.num_tiles; t += gridDim.x) {
    const int l = fs::find_leaf(table, t);
    const fs::TreeLeaf& L = table.leaf[l];
    const long long local = t - L.tile0;
    const int tr = (int)(local / L.col_tiles);
    const int tc = (int)(local % L.col_tiles);
    const float* lo_l = MASKED ? lo + (size_t)l * k : nullptr;
    const float* hi_l = MASKED ? hi + (size_t)l * k : nullptr;
    if (L.dtype == fs::BF16)
      decode_tile<__nv_bfloat16, DIST, MASKED, MODE, VEC>(L, tr, tc, seeds, rs, scale,
                                                         div, lo_l, hi_l, n, k, sh);
    else
      decode_tile<float, DIST, MASKED, MODE, VEC>(L, tr, tc, seeds, rs, scale, div,
                                                 lo_l, hi_l, n, k, sh);
    __syncthreads();   // the next tile's listing and staging wait for this tile
  }
}

struct Args {
  const fs::TreeTable* table;
  const int64_t* seeds;
  const float* rs;
  float scale, div;
  const float* lo;
  const float* hi;
  int n, k;
  int blocks;
  cudaStream_t st;
};

template <int DIST, bool MASKED, int MODE, bool VEC>
void launch(const Args& a) {
  decode_tree_kernel<DIST, MASKED, MODE, VEC><<<a.blocks, THREADS, 0, a.st>>>(
      *a.table, a.seeds, a.rs, a.scale, a.div, a.lo, a.hi, a.n, a.k);
}

// ROUND_ONE takes no mask: it is the k = 1 mode, and one block spans the leaf.
template <int DIST, bool VEC>
void launch_mode(int mode, bool masked, const Args& a) {
  if (mode == PLAIN) {
    if (masked) launch<DIST, true, PLAIN, VEC>(a);
    else        launch<DIST, false, PLAIN, VEC>(a);
  } else if (mode == ROUND_ONE) {
    launch<DIST, false, ROUND_ONE, VEC>(a);
  } else {
    if (masked) launch<DIST, true, ROUND_ANY, VEC>(a);
    else        launch<DIST, false, ROUND_ANY, VEC>(a);
  }
}

template <int DIST>
void launch_vec(bool vec, int mode, bool masked, const Args& a) {
  if (vec) launch_mode<DIST, true>(mode, masked, a);
  else     launch_mode<DIST, false>(mode, masked, a);
}

}  // namespace

// Tile shape and staging for the wrapper's checks: TILE_R rows by TILE_C
// threads (each V columns); SLOTS pairs staged at once.
extern "C" int fs_rec_tile_rows() { return TILE_R; }
extern "C" int fs_rec_tile_threads() { return TILE_C; }
extern "C" int fs_rec_slots() { return SLOTS; }
extern "C" int fs_rec_table_bytes() { return (int)sizeof(fs::TreeTable); }

// table: the leaves of this launch (x and y of each, host memory; copied
// into the launch by value), tiled with V = 16 / element bytes columns a
// thread when vec, else 1; seeds: (n,) int64 round seeds (low 32 bits
// used); rs: (n, k) float32 with every aggregation weight folded in;
// lo, hi: (table.num_leaves, k) float32 leaf-local block bounds, read only
// when masked (may be null otherwise); round selects per-client rounding,
// with div the divisor of its final sum.  Returns cudaGetLastError()
// after the launch.
extern "C" int fs_rec_tree(const fs::TreeTable* table, const int64_t* seeds,
                           const float* rs, float scale, float div, const float* lo,
                           const float* hi, int n, int k, int masked, int round,
                           int vec, int dist, void* stream) {
  if (n < 0 || k <= 0 || table->num_leaves <= 0
      || table->num_leaves > fs::MAX_TREE_LEAVES)
    return (int)cudaErrorInvalidValue;
  if (masked && (lo == nullptr || hi == nullptr)) return (int)cudaErrorInvalidValue;
  if (table->num_tiles <= 0) return (int)cudaSuccess;
  // A masked k = 1 call with rounding takes ROUND_ANY, which equals ROUND_ONE.
  const int mode = !round ? PLAIN : (k == 1 && !masked ? ROUND_ONE : ROUND_ANY);
  const Args a{table, seeds, rs, scale, div, lo, hi, n, k,
               fs::grid_blocks(table->num_tiles, 1), (cudaStream_t)stream};
  switch (dist) {
    case fs::RADEMACHER:        launch_vec<fs::RADEMACHER>(vec, mode, masked, a); break;
    case fs::GAUSSIAN:          launch_vec<fs::GAUSSIAN>(vec, mode, masked, a); break;
    case fs::SPARSE_RADEMACHER: launch_vec<fs::SPARSE_RADEMACHER>(vec, mode, masked, a); break;
    case fs::HADAMARD:          launch_vec<fs::HADAMARD>(vec, mode, masked, a); break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
