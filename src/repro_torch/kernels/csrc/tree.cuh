// The leaf table of a tree launch: one launch of the encode, the fused
// close, the per-client decode or QSGD covers every leaf of a parameter
// tree (up to MAX_TREE_LEAVES; a longer tree is split into several
// launches of the same kernel).
//
// The table travels by value as a __grid_constant__ kernel parameter
// (3 600 bytes, under the classic 4 KB limit), so a launch needs no
// host-to-device copy: the wrapper fills it on the host and the launch
// carries it.  Blocks walk one flat tile space over all leaves with a
// grid-stride loop; find_leaf maps a flat tile to its leaf.
//
// Index range: a leaf may hold any number of elements.  Its rows and its
// cols each stay below 2^31 (kernels/tree.py checks), its coordinates
// (row_offset + row, col_offset + col) below 2^32, as the reference's
// uint32 (tag, row, col) addressing; the flat tile space is 64-bit, and
// every product of rows and cols is taken in size_t.  QSGD's payload
// offset is 64-bit too: a leaf may start past column 2^31 of the payload.
//
// The struct layout is mirrored by kernels/tree.py (ctypes); both sides
// check sizeof(TreeTable) at load time.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fs {

constexpr int MAX_TREE_LEAVES = 64;

struct TreeLeaf {
  const void* x;      // input: the encode's and QSGD's (n, rows, cols), a close's (rows, cols)
  void* y;            // a close's output (rows, cols), QSGD's q (n, rows, cols) or null;
                      // unused by the encode
  long long tile0;    // the leaf's first tile in the launch's flat tile space
  union {
    struct {
      int orig_cols;  // row stride of the flat index that k-block masks use
      int col_tiles;  // tiles across one row (the closes; 1 for the encode)
    };
    long long offset; // QSGD: the leaf's first column in the flat payload
  };
  int rows, cols;     // the leaf's 2-D view
  uint32_t tag;       // leaf ordinal (sorted-key order), folded into every seed
  uint32_t row_offset, col_offset;   // coordinates of element (0, 0)
  uint16_t part0;     // QSGD: the leaf's first norm partial of a client (at most
                      // MAX_TREE_LEAVES * 512, qsgd_quant.cu checks)
  uint8_t dtype;      // fs::DType
  uint8_t vec;        // 1: every row is 16-byte aligned (vector loads)
};

static_assert(sizeof(TreeLeaf) == 56, "kernels/tree.py mirrors a 56-byte TreeLeaf");

struct TreeTable {
  long long num_tiles;   // tiles over all leaves of this launch
  int num_leaves;
  int pad_;
  TreeLeaf leaf[MAX_TREE_LEAVES];
};

// The leaf that holds flat tile t: the last leaf whose first tile is <= t.
__device__ __forceinline__ int find_leaf(const TreeTable& table, long long t) {
  int lo = 0, hi = table.num_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].tile0 <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Blocks for a grid-stride walk: enough to fill the card a few times over,
// never more than there are tiles.
inline int grid_blocks(long long num_tiles, int per_tile_blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || sms <= 0)
      sms = 132;
  }
  long cap = (long)sms * 32 / (per_tile_blocks > 0 ? per_tile_blocks : 1);
  if (cap < 1) cap = 1;
  return (int)(num_tiles < cap ? num_tiles : cap);
}

}  // namespace fs
