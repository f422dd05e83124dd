// QSGD stochastic quantize -> dequantize of a parameter tree, every client of a cohort.
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
// with seed the client's seed folded with the leaf's tag, fold_seed(seed,
// tag) (here, per leaf; the one-leaf entry hands over folded seeds; the
// qsgd protocol hands over client ids, and the seeds are derived here as
// core/fedscalar.py's round_seeds_for(round, id, salt)), and
// (row, col) the coordinates of the leaf's 2-D view plus the table's
// offsets.  x is float32 or bf16 (widened exactly on load); q is written in
// x's dtype (rounded once, as the TPU kernel's q.astype(o_ref.dtype)) and
// the levels in float32.  Every float op is an _rn intrinsic (IEEE
// division, no fast math) and the file is built with -fmad=false, so given
// the same norms the result equals the plain version bit for bit.
//
// One call covers every leaf of a tree (the leaf table of tree.cuh, at
// most 64 leaves; a longer tree is split) for every client, in two
// launches of this source:
//
// 1. The norm pass (skipped when the caller gives the norms): each
//    (client, leaf) of s elements is cut into min(512, ceil(s / 512))
//    spans; one warp sums the squares of one span (lanes striding with
//    16-byte loads where the client's leaf is 16-byte aligned, two running
//    sums a lane, a fixed butterfly) and writes one float32 partial to
//    scratch.  No atomics.
// 2. The quantize pass: a tile is max(1, 256 / cols) whole rows of one
//    (client, leaf), worked by one warp, so a 24-column leaf puts 10 rows
//    in one warp's work where a 128-column block tile idled 4 threads in 5,
//    and a 256-client chunk of the paper MLP spreads over 3 328 warps.  Each
//    warp takes a contiguous run of tiles.  When its (client, leaf)
//    changes it finishes that norm from the partials in a fixed order (a
//    lane's running sum, a butterfly: every warp gets the same bits),
//    sqrt, zero -> 1, and folds the seed and hoists the chain's seed
//    round; the row round is hoisted once per row.  Lanes stride along
//    the tile's rows with 16-byte loads and stores where the table's vec
//    says x and q are aligned, and a coalesced scalar loop otherwise.  The
//    levels go straight into the caller's payload at column offset +
//    r*cols + c of the client's row (row stride lv_ld; the offset and that
//    index are 64-bit, so a leaf may start past payload column 2^31), 16
//    bytes at a time where that row is aligned and one float at a time
//    otherwise (a payload row of d + L floats is aligned only when d + L is
//    a multiple of 4).  The ragged edge is masked, never padded.  The first tile of
//    each (client, leaf) writes its norm (to the payload's norm column
//    when the caller asks for the payload).
//
// Bound on this card: the norm pass reads x once (4 bytes an element, bf16
// 2), the quantize pass reads it again and writes q (x's bytes) and/or 4
// bytes of levels, against one SplitMix32 round and about thirteen float
// ops an element: far below the card's ops-to-bytes ratio, so it is bound
// by HBM.  The design reads x twice only because a norm must be finished
// before its leaf can be rounded; everything else stays in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"
#include "tree.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;                  // loads in flight per lane
// Quantize blocks an SM must hold: caps the kernel at 64 registers (78
// uncapped), 32 warps an SM.
constexpr int MIN_BLOCKS = 4;
constexpr int TILE_ELEMS = 256;           // kernels/tree.py QSGD_TILE_ELEMS
constexpr int NORM_UNIT_ELEMS = 512;      // QSGD_NORM_UNIT_ELEMS
constexpr int NORM_UNITS_MAX = 512;        // QSGD_NORM_UNITS_MAX
constexpr uint32_t QSGD_TAG = 0x7FEB352Du; // repro.core.qsgd.QSGD_TAG
constexpr unsigned FULL_MASK = 0xffffffffu;
// A leaf's first norm partial (part0) is a 16-bit slot of the leaf table.
static_assert(fs::MAX_TREE_LEAVES * NORM_UNITS_MAX <= 0xffff + 1,
              "part0 must fit tree.cuh's 16-bit slot");

__device__ __forceinline__ int rows_per_tile(int cols) {
  const int r = TILE_ELEMS / (cols > 0 ? cols : 1);
  return r > 0 ? r : 1;
}

__device__ __forceinline__ int norm_units(long long size) {
  long long u = (size + NORM_UNIT_ELEMS - 1) / NORM_UNIT_ELEMS;
  u = u < 1 ? 1 : u;
  return (int)(u < NORM_UNITS_MAX ? u : NORM_UNITS_MAX);
}

// Elements of one span: ceil(size / units) rounded up to a multiple of 8.
__device__ __forceinline__ long long norm_span(long long size, int units) {
  const long long per = (size + units - 1) / units;
  return (per + 7) / 8 * 8;
}

// Fixed xor butterfly: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// The leaf that holds a client's norm partial u: the last leaf whose part0 <= u.
__device__ __forceinline__ int find_part_leaf(const fs::TreeTable& table, int u) {
  int lo = 0, hi = table.num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].part0 <= u) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// This lane's share of sum(x[e]^2) over e in [a, b) of one client's leaf.
template <typename T>
__device__ float span_sumsq(const T* __restrict__ xn, long long a, long long b, bool vec,
                            int lane) {
  constexpr int V = fs::VecOf<T>::V;
  float acc0 = 0.0f, acc1 = 0.0f;
  if (vec) {
    for (long long e0 = a + lane * V; e0 < b; e0 += 32LL * V * UNROLL) {
      uint4 buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long e = e0 + (long long)u * 32 * V;
        buf[u] = e < b ? __ldg(reinterpret_cast<const uint4*>(xn + e))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + (long long)u * 32 * V < b) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float v = fs::vec_f32<T>(buf[u], j);
            const float sq = __fmul_rn(v, v);
            if (j & 1) acc1 = __fadd_rn(acc1, sq); else acc0 = __fadd_rn(acc0, sq);
          }
        }
      }
    }
  } else {
    for (long long e0 = a + lane; e0 < b; e0 += 32LL * UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long e = e0 + (long long)u * 32;
        v[u] = e < b ? fs::load_f32(xn + e) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + (long long)u * 32 < b) {
          const float sq = __fmul_rn(v[u], v[u]);
          if (u & 1) acc1 = __fadd_rn(acc1, sq); else acc0 = __fadd_rn(acc0, sq);
        }
      }
    }
  }
  return __fadd_rn(acc0, acc1);
}

// The first `per_warp` of the (client, span) units from this warp's start:
// partials[c * parts + u] = sum of squares of span u of client c.
__global__ void __launch_bounds__(THREADS)
qsgd_norm_kernel(const __grid_constant__ fs::TreeTable table, float* __restrict__ partials,
                 int n, int parts, long long per_warp) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long total = (long long)n * parts;
  long long w = gw * per_warp;
  const long long w_end = w + per_warp < total ? w + per_warp : total;
  for (; w < w_end; ++w) {
    const long long c = w / parts;
    const int u = (int)(w - c * parts);
    const fs::TreeLeaf& L = table.leaf[find_part_leaf(table, u)];
    const long long size = (long long)L.rows * L.cols;
    const long long span = norm_span(size, norm_units(size));
    const long long a = (long long)(u - L.part0) * span;
    const long long b = a + span < size ? a + span : size;
    float s;
    if (L.dtype == fs::BF16) {
      const __nv_bfloat16* xn = static_cast<const __nv_bfloat16*>(L.x) + c * size;
      s = span_sumsq(xn, a, b, aligned16(L.x) && size % 8 == 0, lane);
    } else {
      const float* xn = static_cast<const float*>(L.x) + c * size;
      s = span_sumsq(xn, a, b, aligned16(L.x) && size % 4 == 0, lane);
    }
    s = warp_sum(s);
    if (lane == 0) partials[w] = s;
  }
}

// A client's norm of one leaf from its `units` partials, in a fixed order.
__device__ __forceinline__ float finish_norm(const float* __restrict__ p, int units,
                                             int lane) {
  float s = 0.0f;
  for (int j = lane; j < units; j += 32) s = __fadd_rn(s, p[j]);
  const float norm = __fsqrt_rn(warp_sum(s));
  return norm == 0.0f ? 1.0f : norm;
}

struct QuantArgs {
  const int64_t* seeds;     // (n,) int64 words; the low 32 bits are the seed,
                            // or, with derive, the client id it is derived from
  const float* norms_in;    // given norms at [c * norms_sn + l * norms_sl], or null
  long long norms_sn, norms_sl;
  const float* partials;    // the norm pass's (n, parts), when norms_in is null
  int parts;
  float* lv;                // levels at [c * lv_ld + offset + r * cols + col], or null
  long long lv_ld;
  float* norms_out;         // norms at [c * norms_ld + l], or null
  long long norms_ld;
  int n, levels, fold, derive;
  uint32_t round_word;      // derive: mul32(round, 0x9E3779B9) ^ salt
};

// core/fedscalar.py round_seeds_for(round, id, salt) from its round word:
// mul32(round, 0x9E3779B9) ^ mul32(id, 0x85EBCA6B) ^ salt, then half a
// SplitMix32 finalizer (uint32 products wrap as mul32's do).
__device__ __forceinline__ uint32_t round_seed(uint32_t round_word, uint32_t id) {
  uint32_t x = (id * 0x85EBCA6Bu) ^ round_word;
  x ^= x >> 16;
  x *= 0x21F0AAADu;
  return x ^ (x >> 15);
}

// (r, c) of the position `step` elements on in a row-major span of `cols`.
__device__ __forceinline__ void advance(int& r, int& c, int step, int cols) {
  c += step;
  if (c >= cols) {
    if (c < 2 * cols) {
      c -= cols;
      ++r;
    } else {
      r += c / cols;
      c %= cols;
    }
  }
}

struct Quantized {
  float level, q;
};

__device__ __forceinline__ Quantized quantize(float xv, float u, float norm, float fl) {
  const float scaled = __fmul_rn(__fdiv_rn(fabsf(xv), norm), fl);
  const float lo = floorf(scaled);
  const float level = __fadd_rn(lo, (u < __fsub_rn(scaled, lo)) ? 1.0f : 0.0f);
  const float sign = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : 0.0f);
  return {__fmul_rn(sign, level), __fdiv_rn(__fmul_rn(__fmul_rn(norm, sign), level), fl)};
}

// One tile: `count` elements from row r0 of a client's leaf; x, q, lv point
// at the tile's first element.  s0 is the chain's hoisted seed round.
template <typename T>
__device__ void quantize_tile(const T* __restrict__ x, T* __restrict__ q,
                              float* __restrict__ lv, int count, int cols,
                              uint32_t row0, uint32_t col0, uint32_t s0, float norm,
                              float fl, bool vec, bool lv_vec, int lane) {
  int rs_row = -1;
  uint32_t rs = 0u;
  if (vec) {
    constexpr int V = fs::VecOf<T>::V;
    constexpr int STEP = 32 * V;
    int r = 0, c = lane * V;
    if (c >= cols) { r = c / cols; c %= cols; }
    for (int e0 = lane * V; e0 < count; e0 += STEP * UNROLL) {
      uint4 buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * STEP;
        buf[u] = e < count ? __ldg(reinterpret_cast<const uint4*>(x + e))
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * STEP;
        if (e < count) {
          if (r != rs_row) {
            rs = fs::splitmix32(s0 ^ (row0 + (uint32_t)r));
            rs_row = r;
          }
          float lvv[V], qv[V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float uu = fs::uniform01(fs::splitmix32(rs ^ (col0 + (uint32_t)(c + j))));
            const Quantized z = quantize(fs::vec_f32<T>(buf[u], j), uu, norm, fl);
            lvv[j] = z.level;
            qv[j] = z.q;
          }
          if (q != nullptr)
            *reinterpret_cast<uint4*>(q + e) = fs::vec_pack<T>(qv);
          if (lv != nullptr && lv_vec) {
#pragma unroll
            for (int i = 0; i < V / 4; ++i)
              reinterpret_cast<float4*>(lv + e)[i] =
                  make_float4(lvv[4 * i], lvv[4 * i + 1], lvv[4 * i + 2], lvv[4 * i + 3]);
          } else if (lv != nullptr) {
#pragma unroll
            for (int j = 0; j < V; ++j) lv[e + j] = lvv[j];
          }
        }
        advance(r, c, STEP, cols);
      }
    }
  } else {
    int r = 0, c = lane;
    if (c >= cols) { r = c / cols; c %= cols; }
    for (int e0 = lane; e0 < count; e0 += 32 * UNROLL) {
      float xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * 32;
        xv[u] = e < count ? fs::load_f32(x + e) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = e0 + u * 32;
        if (e < count) {
          if (r != rs_row) {
            rs = fs::splitmix32(s0 ^ (row0 + (uint32_t)r));
            rs_row = r;
          }
          const float uu = fs::uniform01(fs::splitmix32(rs ^ (col0 + (uint32_t)c)));
          const Quantized z = quantize(xv[u], uu, norm, fl);
          if (lv != nullptr) lv[e] = z.level;
          if (q != nullptr) fs::store_rn(q + e, z.q);
        }
        advance(r, c, 32, cols);
      }
    }
  }
}

// The first `per_warp` (client, tile) pairs from this warp's start.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
qsgd_quant_kernel(const __grid_constant__ fs::TreeTable table, const QuantArgs a,
                  long long per_warp) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const long long total = (long long)a.n * table.num_tiles;
  const float fl = (float)a.levels;
  long long w = gw * per_warp;
  const long long w_end = w + per_warp < total ? w + per_warp : total;
  int memo_c = -1, memo_l = -1;
  float norm = 1.0f;
  uint32_t s0 = 0u;
  for (; w < w_end; ++w) {
    const int c = (int)(w / table.num_tiles);
    const long long t = w - (long long)c * table.num_tiles;
    const int l = fs::find_leaf(table, t);
    const fs::TreeLeaf& L = table.leaf[l];
    const long long size = (long long)L.rows * L.cols;
    if (c != memo_c || l != memo_l) {   // uniform across the warp
      memo_c = c;
      memo_l = l;
      norm = a.norms_in != nullptr
                 ? a.norms_in[c * a.norms_sn + l * a.norms_sl]
                 : finish_norm(a.partials + (long long)c * a.parts + L.part0,
                               norm_units(size), lane);
      uint32_t seed = (uint32_t)a.seeds[c];
      if (a.derive) seed = round_seed(a.round_word, seed);
      if (a.fold) seed = fs::fold_seed(seed, L.tag);
      // hash_u32(seed, row, col, tag): the first of its three rounds.
      s0 = fs::splitmix32(seed ^ QSGD_TAG);
    }
    const int tile = (int)(t - L.tile0);
    const int rpt = rows_per_tile(L.cols);
    const int r0 = tile * rpt;
    const int r1 = r0 + rpt < L.rows ? r0 + rpt : L.rows;
    if (tile == 0 && a.norms_out != nullptr && lane == 0)
      a.norms_out[c * a.norms_ld + l] = norm;
    const long long first = (long long)c * size + (long long)r0 * L.cols;
    float* lv = a.lv != nullptr
                    ? a.lv + (long long)c * a.lv_ld + L.offset + (long long)r0 * L.cols
                    : nullptr;
    const bool lv_vec = lv != nullptr && aligned16(lv);
    const int count = (r1 - r0) * L.cols;
    const uint32_t row0 = L.row_offset + (uint32_t)r0;
    if (L.dtype == fs::BF16) {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(L.x) + first;
      __nv_bfloat16* q = L.y != nullptr ? static_cast<__nv_bfloat16*>(L.y) + first : nullptr;
      quantize_tile(x, q, lv, count, L.cols, row0, L.col_offset, s0, norm, fl, L.vec,
                    lv_vec, lane);
    } else {
      const float* x = static_cast<const float*>(L.x) + first;
      float* q = L.y != nullptr ? static_cast<float*>(L.y) + first : nullptr;
      quantize_tile(x, q, lv, count, L.cols, row0, L.col_offset, s0, norm, fl, L.vec,
                    lv_vec, lane);
    }
  }
}

// Blocks for `work` warp units (enough to fill the card twice over), and
// the units each warp takes.
void split_work(long long work, int* blocks, long long* per_warp) {
  const long long want = (work + WARPS - 1) / WARPS;
  *blocks = fs::grid_blocks((int)(want < 0x7fffffff ? want : 0x7fffffff), 2);
  const long long warps = (long long)*blocks * WARPS;
  *per_warp = (work + warps - 1) / warps;
}

}  // namespace

extern "C" int fs_qsgd_tile_elems() { return TILE_ELEMS; }
extern "C" int fs_qsgd_norm_unit_elems() { return NORM_UNIT_ELEMS; }
extern "C" int fs_qsgd_norm_units_max() { return NORM_UNITS_MAX; }
extern "C" int fs_tree_table_bytes() { return (int)sizeof(fs::TreeTable); }

// table: the leaves of this launch (host memory; copied into the launch
// by value), each (n, rows, cols) with y its q or null; seeds: (n,)
// int64, or with derive the client ids whose seeds round_seed derives
// from round_word; fold: fold each seed with the leaf's tag (0: already
// folded).
// norms_in: given norms at [c * norms_sn + l * norms_sl], or null to run
// the norm pass into partials, (n, parts) float32 scratch.  lv: levels at
// [c * lv_ld + leaf offset + r * cols + col], or null; norms_out: norms at
// [c * norms_ld + l], or null.  Returns cudaGetLastError() after the
// launches (the norm pass, when it runs, and the quantize pass).
extern "C" int fs_qsgd_tree(const fs::TreeTable* table, const int64_t* seeds, int n,
                            int levels, int fold, int derive, uint32_t round_word,
                            const float* norms_in,
                            long long norms_sn, long long norms_sl, float* partials,
                            int parts, float* lv, long long lv_ld, float* norms_out,
                            long long norms_ld, void* stream) {
  if (n <= 0 || table->num_leaves <= 0 || table->num_leaves > fs::MAX_TREE_LEAVES
      || levels < 1 || levels > 127 || (norms_in == nullptr && (partials == nullptr
                                                                || parts <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int blocks;
  long long per_warp;
  if (norms_in == nullptr) {
    split_work((long long)n * parts, &blocks, &per_warp);
    qsgd_norm_kernel<<<blocks, THREADS, 0, st>>>(*table, partials, n, parts, per_warp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (table->num_tiles > 0) {
    const QuantArgs a{seeds, norms_in, norms_sn, norms_sl, partials, parts, lv, lv_ld,
                      norms_out, norms_ld, n, levels, fold, derive, round_word};
    split_work((long long)n * table->num_tiles, &blocks, &per_warp);
    qsgd_quant_kernel<<<blocks, THREADS, 0, st>>>(*table, a, per_warp);
  }
  return (int)cudaGetLastError();
}
