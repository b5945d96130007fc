// Coordinate-wise sort-and-reduce of worker stacks: the median, trimmed mean
// or mean of every column of each leaf x (m, d_l) of a parameter tree,
// written as (d_l,) float32, for one stack or for the stacks of every lane
// of a sweep. One launch covers up to 32 leaves.
//
// Replaces the reduce stage of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel -> _reduce_tile ->
// _sorted_rows / _bitonic_sort_rows): its static-trim forms (cwtm, cwmed,
// reduce="mean") and its traced-trim form (cwtm_masked), which the JAX
// package's CoordinateWiseRule.tree calls one leaf at a time and its
// lane-batched sweep (core/aggregators.py's uniform CWTM under the lane
// vmap) calls as one batched pallas_call over the lanes.
//
// What bounds it: at the training path's shapes (17 x 9610 f32 over four
// leaves, 0.65 MB) the launch and one round trip to memory, not the bytes
// (0.2 us at 3.35 TB/s) and not the arithmetic. A call reads the m*d inputs
// once and writes d floats, and per column runs the sort network's
// NP2*log2(NP2)*(log2(NP2)+1)/2 min/max operations and the sum: 6.9
// operations a byte at m = 17 f32, under the 20 of the card's f32 rate over
// its memory rate. At 17 x 2^20 it reaches 45 % of its bytes bound in f32
// and 18 % in bf16 (PERF.md).
//
// Design.
//  * One launch per tree, through leaf_table.cuh's table (shared with
//    combine.cu): host arrays of the leaves' input and output pointers,
//    widths and first blocks (kernels/fused.py::tree_launches), passed by
//    value as a __grid_constant__ parameter. Nothing is copied to the card
//    before the launch, so a CUDA graph of tree calls replays bit for bit.
//  * A block is C columns of one leaf, so the main path's four leaves take
//    151 blocks at C = 64 (132 SMs), where one launch per leaf at 256
//    columns a block gave 32 + 5 + 1 + 1 blocks over four launches.
//  * A column is held by L = 1 or 2 adjacent lanes (sort_network.cuh): L =
//    1 runs the whole network in one thread; at L = 2 each lane holds NP2 /
//    2 rows and the passes that pair rows of the two lanes go through
//    __shfl_xor_sync. Lane j of column c reads rows j*K .. j*K + K-1 of it:
//    a warp reads 32 / L adjacent columns of L rows at a time, coalesced.
//  * Bits: the network, the 3.0e38 padding, the min.NaN / max.NaN rule and
//    the row-order sums (from -0.0 for the trimmed mean; the lanes hand the
//    running sum on in row order) are sort_network.cuh's, whatever C, L or
//    the tree, so every plan gives the bits of one thread per column and of
//    one launch per leaf. No atomics.
//  * The trim: a value (the host clips it), or, with trim_ptr, an int32 on
//    the card that every thread reads and clips to [0, (m-1)/2] itself, so
//    the call makes no host sync and a captured graph replays with the
//    trim changed in place. Either way the sum is divided by float(m - 2t).
//  * Lanes of a sweep: a leaf may hold S stacks (S, m, d) one after another,
//    one per lane, each reduced to its row of the (S, d) output. The leaf
//    then takes S * ceil(d / C) blocks, and a block finds its stack as
//    (b - first_block) / ceil(d / C), so one launch reduces every leaf of
//    every lane. With trim_ptr the trim of stack s is trim_ptr[s]: one
//    int32 a lane, on the card. S = 1 is the one-stack launch, bit for bit:
//    a stack's columns see the same network and sums whatever S is.
//  * Threads with no column (past d) still load nothing and store nothing,
//    but stay for the shuffles: every lane of a warp takes part.
//
// Tuned plans (kernels/fused.py::cw_reduce_plan): L = 1 up to 32 rows, L = 2
// above, C = 64. Device us per call by CUDA graph replay, the range of three
// runs, or one where one value stands (benchmarks_torch/time_kernels.py
// --sweep cw_reduce, NVIDIA H100 80GB HBM3, 700 W, trim 8, f32 unless
// marked), by (L, C); "tree" is the main path's four leaves (8192, 1280,
// 128, 10 columns):
//
//   tree, m = 17     (1,32) 2.21-2.27  (1,64) 2.33-2.36  (1,128) 2.32-2.36
//                    (1,256) 2.95-2.98  (2,32) 2.80-2.84  (2,64) 2.77-2.79
//   17 x 8192        (1,32) 2.20-2.24  (1,64) 2.20-2.23  (1,128) 2.15-2.19
//                    (1,256) 2.78-2.80  (2,32) 2.19-2.24
//   64 x 8192        (1,32) 3.60-3.64  (1,64) 3.57-3.60  (1,256) 5.33-5.35
//                    (2,32) 3.12-3.14  (2,64) 3.12-3.17  (2,128) 4.36-4.42
//   17 x 2^16        (1,32) 4.59  (1,64) 4.49  (1,256) 4.42  (2,64) 6.13
//   17 x 2^16 bf16   (1,32) 5.42  (1,64) 5.35  (1,256) 5.35  (2,64) 6.30
//   17 x 2^20        (1,32) 50.4-50.6  (1,64) 50.0-50.2  (1,256) 50.8-51.1
//                    (2,64) 74.4-75.4
//   17 x 2^20 bf16   (1,32) 67.5  (1,64) 63.2  (1,128) 63.1  (1,256) 63.7
//                    (2,64) 80.1
//
// Up to 32 rows one thread a column wins: the lanes add shuffles and
// selects to every thread, and 151 blocks already fill the card. At 64 rows
// one thread holds 64 values (80 registers, 60 at L = 2), fewer warps fit on
// an SM, and two lanes win by 0.4 us. C = 32 is 0.1 us faster over the tree
// but 4 us slower at 17 x 2^20 bf16 (a block of one warp caps an SM at 32
// warps, and 2-byte loads need more of them in flight), so C = 64 serves
// both. 256 columns a block (the first one-leaf kernel's layout, 32 blocks
// over 17 x 8192) costs 0.6-0.8 us at every shape of the path. L = 4 was
// built for the sweep and lost at every shape (3.07-3.42 us over the tree,
// 111 at 17 x 2^20): it is not built.
//
// The kernel allocates nothing; the caller passes the output buffers and the
// stream, and checks the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "leaf_table.cuh"
#include "sort_network.cuh"

namespace {

using leaftab::Leaf;
using leaftab::LeafTable;
using sortnet::kMaxLog2Rows;
using sortnet::kMean;
using sortnet::kTrimmed;
using sortnet::to_float;

constexpr int kMaxThreads = 256;  // threads a block: C * L
constexpr int kWarp = 32;

template <int LOG2_NP2, int LOG2_L, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    cw_reduce_kernel(const __grid_constant__ LeafTable tab, int m, int cols,
                     int mode, int trim, const int* __restrict__ trim_ptr,
                     int stacks) {
  constexpr int LOG2_K = LOG2_NP2 - LOG2_L;
  constexpr int K = 1 << LOG2_K;
  constexpr int L = 1 << LOG2_L;
  const int b = blockIdx.x;
  const Leaf& leaf = leaftab::find_leaf(tab, b);
  const int d = leaf.d;
  int block = b - leaf.first_block;
  int stack = 0;
  if (stacks > 1) {
    const int per_stack = (d + cols - 1) / cols;
    stack = block / per_stack;
    block -= stack * per_stack;
  }
  if (trim_ptr != nullptr) {
    trim = min(max(__ldg(trim_ptr + stack), 0), (m - 1) / 2);
  }
  const int lane = threadIdx.x & (L - 1);
  const int col = block * cols + (threadIdx.x >> LOG2_L);
  const bool live = col < d;
  const T* x = static_cast<const T*>(leaf.x) +
               static_cast<size_t>(stack) * m * d + col;
  float* out = leaf.out + static_cast<size_t>(stack) * d;

  float v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int row = lane * K + i;
    v[i] = (live && row < m) ? to_float(x[static_cast<size_t>(row) * d])
                             : 0.0f;
  }
  const float r =
      sortnet::reduce_column<LOG2_NP2, LOG2_L>(v, m, mode, trim, lane);
  if (live && lane == L - 1) out[col] = r;
}

template <int LOG2_NP2, int LOG2_L, typename T>
cudaError_t launch_one(const LeafTable& tab, int blocks, int threads,
                       cudaStream_t stream, int m, int cols, int mode,
                       int trim, const int* trim_ptr, int stacks) {
  if constexpr (LOG2_L > LOG2_NP2) {
    return cudaErrorInvalidValue;  // more lanes than rows
  } else {
    cw_reduce_kernel<LOG2_NP2, LOG2_L, T><<<blocks, threads, 0, stream>>>(
        tab, m, cols, mode, trim, trim_ptr, stacks);
    return cudaGetLastError();
  }
}

template <int LOG2_L, typename T>
cudaError_t launch_rows(int log2_np2, const LeafTable& tab, int blocks,
                        int threads, cudaStream_t stream, int m, int cols,
                        int mode, int trim, const int* trim_ptr, int stacks) {
  switch (log2_np2) {
#define CW_REDUCE_CASE(N)                                                 \
  case N:                                                                 \
    return launch_one<N, LOG2_L, T>(tab, blocks, threads, stream, m, cols, \
                                    mode, trim, trim_ptr, stacks);
    CW_REDUCE_CASE(0)
    CW_REDUCE_CASE(1)
    CW_REDUCE_CASE(2)
    CW_REDUCE_CASE(3)
    CW_REDUCE_CASE(4)
    CW_REDUCE_CASE(5)
    CW_REDUCE_CASE(6)
#undef CW_REDUCE_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_lanes(int lanes, int log2_np2, const LeafTable& tab,
                         int blocks, int threads, cudaStream_t stream, int m,
                         int cols, int mode, int trim, const int* trim_ptr,
                         int stacks) {
  switch (lanes) {
    case 1:
      return launch_rows<0, T>(log2_np2, tab, blocks, threads, stream, m,
                               cols, mode, trim, trim_ptr, stacks);
    case 2:
      return launch_rows<1, T>(log2_np2, tab, blocks, threads, stream, m,
                               cols, mode, trim, trim_ptr, stacks);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch over n <= 32 leaves of `stacks` stacks each. x[l]: (stacks, m,
// d[l]) row-major, every leaf float32 (is_bf16 == 0) or every leaf bfloat16
// (is_bf16 == 1); out[l]: its (stacks, d[l]) float32 result. first_block[l]:
// the blocks of the leaves before l, each leaf taking stacks *
// ceil(d / cols_per_block). mode 0: the trimmed mean over the sorted rows
// [t, m - t) (the median is t = (m-1)/2); mode 1: the mean. t is trim, in
// [0, (m-1)/2], or, where trim_ptr is not null, the int32 trim_ptr[s] on the
// card for stack s, clipped to that range by the kernel. lanes 1 or 2, at
// most next_pow2(m); lanes * cols_per_block a multiple of 32 and at most
// 256. Returns a cudaError_t.
extern "C" int cw_reduce_launch(const void* const* x, void* const* out,
                                const int* d, const int* first_block, int n,
                                int m, int is_bf16, int mode, int trim,
                                const void* trim_ptr, int stacks, int lanes,
                                int cols_per_block, void* stream) {
  int log2_np2 = 0;
  while ((1 << log2_np2) < m) ++log2_np2;
  const int threads = lanes * cols_per_block;
  if (out == nullptr || m < 1 || m > (1 << kMaxLog2Rows) ||
      (mode != kTrimmed && mode != kMean) ||
      (trim_ptr == nullptr &&
       (trim < 0 || (mode == kTrimmed && 2 * trim >= m))) ||
      stacks < 1 || lanes < 1 || lanes > (1 << log2_np2) ||
      cols_per_block < 1 || threads % kWarp != 0 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafTable tab;
  const long long blocks = leaftab::fill_table(
      tab, x, nullptr, out, d, first_block, n, cols_per_block, stacks);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* tp = static_cast<const int*>(trim_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  const cudaError_t err =
      is_bf16 ? launch_lanes<__nv_bfloat16>(lanes, log2_np2, tab, nb, threads,
                                            s, m, cols_per_block, mode, trim,
                                            tp, stacks)
              : launch_lanes<float>(lanes, log2_np2, tab, nb, threads, s, m,
                                    cols_per_block, mode, trim, tp, stacks);
  return static_cast<int>(err);
}

extern "C" const char* cw_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
