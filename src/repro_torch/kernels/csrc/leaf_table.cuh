// The table of leaves that one launch of a tree kernel takes (combine.cu,
// cw_reduce.cu): up to 32 leaves of a parameter tree, each an (m, d) stack
// with its outputs and the first block of the launch that works on it.
//
// The caller passes host arrays of the leaves' pointers, widths and first
// blocks (kernels/fused.py::tree_launches numbers the blocks: leaf l takes
// S * ceil(d_l / C) blocks of C columns, numbered on from the blocks of the
// leaves before it, where S is the number of (m, d_l) stacks a leaf holds
// one after another: 1, or one per lane of a sweep); fill_table checks
// them and copies them into a LeafTable, which goes to the kernel by value
// as a __grid_constant__ parameter. Nothing is copied to the card before
// the launch, so a launch can be captured in a CUDA graph and replays bit
// for bit.

#pragma once

#include <climits>

namespace leaftab {

constexpr int kMaxLeaves = 32;

struct Leaf {
  const void* x;  // (m, d) row-major
  float* y;       // (k, d) row-major, or null
  float* out;     // (d,), or null
  int d;
  int first_block;
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  int n;
};

// The leaf that block b works on: the last one whose first block is <= b.
__device__ __forceinline__ const Leaf& find_leaf(const LeafTable& tab,
                                                 int b) {
  int l = 0;
  while (l + 1 < tab.n && tab.leaf[l + 1].first_block <= b) ++l;
  return tab.leaf[l];
}

// Fill tab from n leaves: x[l] and d[l] >= 1 for every leaf, y[l] where y
// is not null, out[l] where out is not null, and first_block[l] the blocks
// of the leaves before l at cols columns a block and stacks stacks a leaf.
// Returns the launch's blocks, or -1 where an argument is out of range.
inline long long fill_table(LeafTable& tab, const void* const* x,
                            void* const* y, void* const* out, const int* d,
                            const int* first_block, int n, int cols,
                            int stacks = 1) {
  if (n < 1 || n > kMaxLeaves || x == nullptr || d == nullptr ||
      first_block == nullptr || cols < 1 || stacks < 1) {
    return -1;
  }
  tab = LeafTable{};
  tab.n = n;
  long long blocks = 0;
  for (int l = 0; l < n; ++l) {
    if (x[l] == nullptr || d[l] < 1 || first_block[l] != blocks ||
        (y != nullptr && y[l] == nullptr) ||
        (out != nullptr && out[l] == nullptr)) {
      return -1;
    }
    tab.leaf[l] = {x[l], y ? static_cast<float*>(y[l]) : nullptr,
                   out ? static_cast<float*>(out[l]) : nullptr, d[l],
                   first_block[l]};
    blocks += static_cast<long long>(stacks) * ((d[l] + cols - 1) / cols);
    if (blocks > INT_MAX) return -1;
  }
  return blocks;
}

}  // namespace leaftab
