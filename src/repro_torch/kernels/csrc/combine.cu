// Weighted combine of worker stacks, y = w @ x for w (k, m) and each leaf
// x (m, d_l) of a parameter tree, and its mix-then-reduce form: the k rows
// of y sorted and reduced per column (median, trimmed mean or mean) to
// (d_l,) float32, optionally writing y too. One launch covers up to 32
// leaves.
//
// Replaces the combine and mix+reduce stages of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel with has_w: the
// `w @ x` dot, `combine` written to the (k, d) output, `reduce` over the rows
// of y through _reduce_tile): weighted_combine (fused.py:273) and the
// fused_op(w=..., reduce=..., combine=...) forms (ops.py:65) that
// agg_engine.combine_reduce uses for NNM with a coordinate-wise base; the
// JAX package streams the tree forms (core/agg_engine.py:205-231) one leaf
// at a time.
//
// What bounds it: at the training path's shapes (17 x 9610 f32 over four
// leaves, 0.65 MB) the launch and the latency of one round trip to memory,
// not the bytes (0.2 us at 3.35 TB/s) and not the arithmetic. A call reads
// the m*d inputs once and writes k*d (combine) and/or d (reduce) floats, and
// does 2*k*m flops per column plus, for a reduce, the sort network's
// NP2*log2(NP2)*(log2(NP2)+1)/2 min/max operations: 4.3 operations per byte
// for the combine at k = m = 17 f32 and 15 for the mix+reduce, under the 20
// of the card's f32 rate over its memory rate.
//
// Design.
//  * One launch per tree, through the leaf table of leaf_table.cuh (shared
//    with cw_reduce.cu): host arrays of the leaves' pointers, widths and
//    first blocks (kernels/fused.py::tree_launches) copied into a table that
//    goes to the kernel by value, as a __grid_constant__ parameter, so the
//    launch can be captured in a CUDA graph. Leaf l takes ceil(d_l / C)
//    blocks of C columns; a block finds its leaf by walking the table.
//  * Enough blocks to fill the card: C = 32 or 64 columns a block, so the
//    main path's four leaves take 151 blocks (k = 1) or 301 (k = 17) on 132
//    SMs, where the one-leaf kernel ran 32 blocks of 256 threads over
//    17 x 8192 and one block over 17 x 128.
//  * The k outputs of a column are split over S = ceil(k / R) threads, R
//    rows each (R a template parameter: 1, 3, 6 or 8), so a block is
//    S * C threads and each thread holds R accumulators. The block stages
//    its (m, C) tile of x once in shared memory as float32, and the k rows
//    of w that are used, padded to a multiple of 4 columns, beside it. All
//    of a thread's global loads go out before the first store to shared
//    memory (its rows of x in runs of four under one warp-uniform test, and
//    up to four weights located without a division each): one round trip
//    to memory before the barrier. A thread reads its column's m inputs
//    from the tile (consecutive lanes on consecutive columns: no bank
//    conflicts) and its rows of w four at a time as 16-byte loads that every
//    lane of the warp shares (the S groups are whole warps: C is a power of
//    two of at least 32).
//  * k <= R (k = 1 on GeoMed, Krum and MFM): a thread computes all k
//    outputs of its column from its x column in registers and w read where
//    it lies, the same address across the warp: no shared memory, no
//    barrier.
//  * Bits: each y[r, c] is one fmaf chain over i = 0 .. m-1 from 0.0f, as in
//    the one-leaf kernel it replaces, so the plan, the path, the tree and
//    the launch never change a bit, and no float atomics: reruns and CUDA
//    graph replays equal eager calls.
//  * Reduce: after the mix the block writes its k x C mixed values back into
//    the tile (after a barrier, since the tile held x; the tile has
//    max(m, NP2) rows), and one thread per column reads NP2 = next_pow2(k)
//    rows of it into a register array, unconditionally (a test per row made
//    the compiler branch around every load), and runs sort_network.cuh's
//    reduce_column (shared with cw_reduce.cu: the
//    same 3.0e38 padding, NaN rule and row-order sums). The network stays
//    at next_pow2(k) and in one thread: the sort costs what cw_reduce's does
//    per column at m = 17, and one thread keeps the row-order sum of the
//    kept values as it is. It is what K5 adds to K4 (about 0.8 us over the
//    tree at R = 6, the sweep below): splitting a column's sort over lanes
//    is the next step if K5 matters.
//  * Registers: the launch bound is 512 threads, 256 for NP2 = 64, so the
//    sort's NP2 values stay in registers; the plan keeps S * C within it.
//  * The reduce's trim: a value (the host clips it), or, with trim_ptr, an
//    int32 on the card that every thread reads and clips to [0, (k-1)/2]
//    itself, as cw_reduce.cu does (the traced trim of the JAX package's
//    _fused_kernel with has_t): no host sync, and a captured graph replays
//    with the trim changed in place. The same network and sums either way.
//
// Tuned plans (kernels/fused.py::combine_plan): R = 1 and C = 64 at k = 1;
// above it R = 3, C = 32 for the combine and R = 6, C = 32 for the
// mix+reduce, with a larger R where S * C would pass the launch bound. Device
// us per call by CUDA graph replay (benchmarks_torch/time_kernels.py --sweep
// combine, NVIDIA H100 80GB HBM3, 700 W, f32, m = 17), by (R, C); "tree" is
// the main path's four leaves (8192, 1280, 128, 10 columns) in one launch:
//
//   K4 k = 1,  tree      (1,32) 2.16  (1,64) 2.20  (1,128) 2.20  (3,64) 2.48
//   K4 k = 1,  17 x 8192 (1,32) 2.22  (1,64) 2.18  (1,128) 2.11  (3,64) 2.41
//   K4 k = 17, tree      (3,32) 3.16  (3,64) 3.46  (6,32) 3.21  (6,64) 3.28
//                        (8,32) 3.46  (8,64) 3.38  [(2,32) 3.67  (4,32) 3.20]
//   K4 k = 17, 17 x 8192 (3,32) 2.73  (3,64) 2.79  (6,32) 2.87  (6,64) 2.95
//                        (8,32) 3.17  (8,64) 3.00  [(2,32) 2.92  (4,32) 2.88]
//   K5 k = 17, tree      (3,32) 4.88  (3,64) 4.95  (6,32) 4.03  (6,64) 4.18
//                        (8,32) 4.53  (8,64) 4.20  [(2,32) 5.55  (4,32) 4.23]
//   K5 k = 17, 17 x 8192 (3,32) 3.49  (3,64) 3.57  (6,32) 3.79  (8,64) 3.73
//
// R = 2 and 4 (in brackets) were built for that sweep and lost to the kept
// instances at every shape (and R = 4 spilled): they are not built any more.
// At k = 1 the plans are within the spread of a repeat (0.1 us); at k = 17
// more rows a thread mean fewer threads to stage x and to sort, fewer mean
// shorter fmaf chains: the mix alone is fastest at 3 rows, the mix+reduce,
// whose sort runs on one thread per column, at 6 over the tree (at 3 on
// 17 x 8192 alone; the tree is what the rules launch). At these
// sizes a thread's instruction count before and after its one round trip
// to memory is what the launch pays above its fixed cost (about 2 us), so
// the staging makes no load it does not need and divides once.
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

constexpr int kMaxRows = 1 << kMaxLog2Rows;
constexpr int kWarp = 32;
constexpr int kMaxSmem = 48 * 1024;  // no opt-in to more dynamic shared memory
constexpr int kStageLoads = 32;      // rows of x a thread loads in one round
constexpr int kWLoads = 4;           // weights a thread loads in one round
constexpr int kNoReduce = -1;

// Threads a block may have when the sort holds 2^LOG2_NP2 values: 128
// registers a thread (the staged x, the accumulators, the sort), 255 for 64.
constexpr int max_threads(int log2_np2) { return log2_np2 >= 6 ? 256 : 512; }

// Rows i0, i0 + S, ... < m of column `col` of x, at most kStageLoads of
// them, as float32 (0 where the column is past d). Returns how many.
template <typename T>
__device__ __forceinline__ int load_x(const void* x, float (&v)[kStageLoads],
                                      int i0, int m, int d, int col,
                                      bool live, int groups) {
  const T* p = static_cast<const T*>(x) + static_cast<size_t>(i0) * d + col;
  const size_t step = static_cast<size_t>(groups) * d;
  int n = 0;
#pragma unroll
  for (int ub = 0; ub < kStageLoads; ub += 4) {
    if (i0 + ub * groups >= m) break;
#pragma unroll
    for (int u = ub; u < ub + 4; ++u) {
      v[u] = (live && i0 + u * groups < m) ? to_float(p[u * step]) : 0.0f;
    }
    n = ub + 4;
  }
  return n;
}

__device__ __forceinline__ void store_x(const float (&v)[kStageLoads], int n,
                                        float* xs, int i0, int m, int groups,
                                        int cols, int c) {
#pragma unroll
  for (int ub = 0; ub < kStageLoads; ub += 4) {
    if (ub >= n) break;
#pragma unroll
    for (int u = ub; u < ub + 4; ++u) {
      if (i0 + u * groups < m) xs[(i0 + u * groups) * cols + c] = v[u];
    }
  }
}

template <int R, int LOG2_NP2>
__global__ void __launch_bounds__(max_threads(LOG2_NP2))
    combine_kernel(const __grid_constant__ LeafTable tab,
                   const float* __restrict__ w, int m, int k, int cols,
                   int is_bf16, int mode, int trim,
                   const int* __restrict__ trim_ptr) {
  constexpr int NP2 = 1 << LOG2_NP2;
  if (trim_ptr != nullptr) trim = min(max(__ldg(trim_ptr), 0), (k - 1) / 2);
  extern __shared__ float4 smem[];
  const int groups = (k + R - 1) / R;
  const int m4 = (m + 3) & ~3;
  float* ws = reinterpret_cast<float*>(smem);  // groups*R rows of m4
  float* xs = ws + groups * R * m4;            // max(m, NP2) rows of cols

  const int b = blockIdx.x;
  const Leaf& leaf = leaftab::find_leaf(tab, b);
  const int d = leaf.d;
  const int t = threadIdx.x;
  const int c = t & (cols - 1);     // cols is a power of two
  const int s = t >> (__ffs(cols) - 1);  // this thread's rows: s*R .. s*R+R-1
  const int col = (b - leaf.first_block) * cols + c;
  const bool live = col < d;

  if (groups == 1 && m <= kStageLoads) {
    // k <= R: a thread computes all k outputs of its column from its x
    // column in registers and w read where it lies (one address across the
    // warp): no shared memory and no barrier.
    float xv[kStageLoads];
    if (is_bf16) {
      load_x<__nv_bfloat16>(leaf.x, xv, 0, m, d, col, live, 1);
    } else {
      load_x<float>(leaf.x, xv, 0, m, d, col, live, 1);
    }
    float acc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int ub = 0; ub < kStageLoads; ub += 4) {
      if (ub >= m) break;
#pragma unroll
      for (int i = ub; i < ub + 4; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (i < m && j < k) acc[j] = fmaf(__ldg(w + j * m + i), xv[i], acc[j]);
        }
      }
    }
    if (!live) return;
    if (leaf.y != nullptr) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j < k) leaf.y[static_cast<size_t>(j) * d + col] = acc[j];
      }
    }
    if (leaf.out != nullptr) {
      float v[NP2];
#pragma unroll
      for (int r = 0; r < NP2; ++r) v[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < R && j < NP2; ++j) {
        if (j < k) v[j] = acc[j];
      }
      leaf.out[col] = sortnet::reduce_column<LOG2_NP2>(v, k, mode, trim);
    }
    return;
  }

  // Every global load of the block in flight at once: a thread's rows of x
  // (up to kStageLoads of them) and kWLoads weights, then the stores to
  // shared memory; more in further rounds (m > kStageLoads * S, or a weight
  // tile over kWLoads * S * C). Weight e = t + u * nthr is (r, i) of the
  // padded tile, stepped without a division per element.
  const int nthr = blockDim.x;
  const int n_w = groups * R * m4;
  float xv[kStageLoads];
  const int nx = is_bf16
      ? load_x<__nv_bfloat16>(leaf.x, xv, s, m, d, col, live, groups)
      : load_x<float>(leaf.x, xv, s, m, d, col, live, groups);
  int wr_row = t / m4;
  int wr_col = t - wr_row * m4;
  const int dr = nthr / m4;
  const int di = nthr - dr * m4;
  float wv[kWLoads];
#pragma unroll
  for (int u = 0; u < kWLoads; ++u) {
    wv[u] = (t + u * nthr < n_w && wr_row < k && wr_col < m)
                ? w[wr_row * m + wr_col]
                : 0.0f;
    wr_row += dr;
    wr_col += di;
    if (wr_col >= m4) {
      wr_col -= m4;
      ++wr_row;
    }
  }
#pragma unroll
  for (int u = 0; u < kWLoads; ++u) {
    if (t + u * nthr < n_w) ws[t + u * nthr] = wv[u];
  }
  for (int e = t + kWLoads * nthr; e < n_w; e += nthr) {
    ws[e] = (wr_row < k && wr_col < m) ? w[wr_row * m + wr_col] : 0.0f;
    wr_row += dr;
    wr_col += di;
    if (wr_col >= m4) {
      wr_col -= m4;
      ++wr_row;
    }
  }
  store_x(xv, nx, xs, s, m, groups, cols, c);
  for (int i0 = s + kStageLoads * groups; i0 < m; i0 += kStageLoads * groups) {
    const int n = is_bf16
        ? load_x<__nv_bfloat16>(leaf.x, xv, i0, m, d, col, live, groups)
        : load_x<float>(leaf.x, xv, i0, m, d, col, live, groups);
    store_x(xv, n, xs, i0, m, groups, cols, c);
  }
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.0f;
  const float* wr = ws + s * R * m4;
  const float* xc = xs + c;
  int i = 0;
  for (; i + 4 <= m; i += 4) {
    const float x0 = xc[i * cols];
    const float x1 = xc[(i + 1) * cols];
    const float x2 = xc[(i + 2) * cols];
    const float x3 = xc[(i + 3) * cols];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(wr + j * m4 + i);
      acc[j] = fmaf(w4.x, x0, acc[j]);
      acc[j] = fmaf(w4.y, x1, acc[j]);
      acc[j] = fmaf(w4.z, x2, acc[j]);
      acc[j] = fmaf(w4.w, x3, acc[j]);
    }
  }
  for (; i < m; ++i) {
    const float xi = xc[i * cols];
#pragma unroll
    for (int j = 0; j < R; ++j) acc[j] = fmaf(wr[j * m4 + i], xi, acc[j]);
  }

  if (leaf.y != nullptr && live) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = s * R + j;
      if (r < k) leaf.y[static_cast<size_t>(r) * d + col] = acc[j];
    }
  }
  if (leaf.out != nullptr) {  // every leaf of the table, or none
    __syncthreads();          // the tile held x until here
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = s * R + j;
      if (r < k) xs[r * cols + c] = acc[j];
    }
    __syncthreads();
    if (s == 0 && live) {
      // NP2 rows, read without a test each: reduce_column pads the rows
      // from k on and the mean never reads them
      float v[NP2];
      const float* yc = xs + c;
#pragma unroll
      for (int r = 0; r < NP2; ++r) v[r] = yc[r * cols];
      leaf.out[col] = sortnet::reduce_column<LOG2_NP2>(v, k, mode, trim);
    }
  }
}

template <int R>
cudaError_t launch_rows(int log2_np2, const LeafTable& tab, int blocks,
                        int threads, size_t smem, cudaStream_t stream,
                        const float* w, int m, int k, int cols, int is_bf16,
                        int mode, int trim, const int* trim_ptr) {
  switch (log2_np2) {
#define COMBINE_CASE(L)                                                  \
  case L:                                                                \
    combine_kernel<R, L><<<blocks, threads, smem, stream>>>(             \
        tab, w, m, k, cols, is_bf16, mode, trim, trim_ptr);              \
    break;
    COMBINE_CASE(0)
    COMBINE_CASE(1)
    COMBINE_CASE(2)
    COMBINE_CASE(3)
    COMBINE_CASE(4)
    COMBINE_CASE(5)
    COMBINE_CASE(6)
#undef COMBINE_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One launch over n <= 32 leaves. x[l]: (m, d[l]) row-major, every leaf
// float32 (is_bf16 == 0) or every leaf bfloat16 (is_bf16 == 1); w: (k, m)
// row-major float32. y: null, or y[l] the (k, d[l]) float32 output of leaf
// l; out: null, or out[l] its (d[l],) float32 reduction. first_block[l]: the
// blocks of the leaves before l, each leaf taking ceil(d / cols_per_block).
// mode -1: write y = w @ x only (y not null); mode 0: the trimmed mean over
// the sorted rows [t, k - t) of y (the median is t = (k-1)/2), t being
// trim, in [0, (k-1)/2], or, where trim_ptr is not null, the int32 it points
// to on the card, clipped to that range by the kernel; mode 1: the mean of
// the rows of y (out not null for both; y too when not null).
// rows_per_thread in {1, 3, 6, 8}; cols_per_block a power of two of at least
// 32, ceil(k / rows_per_thread) * cols_per_block within the launch bound of
// next_pow2(k). Returns a cudaError_t.
extern "C" int combine_launch(const void* const* x, void* const* y,
                              void* const* out, const int* d,
                              const int* first_block, int n, const void* w,
                              int m, int k, int is_bf16, int mode, int trim,
                              const void* trim_ptr, int rows_per_thread,
                              int cols_per_block, void* stream) {
  const bool reduce = mode != kNoReduce;
  if (w == nullptr || m < 1 || m > kMaxRows || k < 1 || k > kMaxRows ||
      (mode != kNoReduce && mode != kTrimmed && mode != kMean) ||
      (reduce ? out == nullptr : y == nullptr) ||
      (trim_ptr == nullptr &&
       (trim < 0 || (mode == kTrimmed && 2 * trim >= k))) ||
      rows_per_thread < 1 || cols_per_block < kWarp ||
      (cols_per_block & (cols_per_block - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int log2_np2 = 0;
  while ((1 << log2_np2) < k) ++log2_np2;
  const int r = rows_per_thread;
  const int groups = (k + r - 1) / r;
  const int m4 = (m + 3) & ~3;
  const int np2 = 1 << log2_np2;
  const size_t smem = sizeof(float) * (static_cast<size_t>(groups) * r * m4 +
                                       static_cast<size_t>(m > np2 ? m : np2) *
                                           cols_per_block);
  if (groups > max_threads(log2_np2) / cols_per_block ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LeafTable tab;
  const long long blocks = leaftab::fill_table(
      tab, x, y, reduce ? out : nullptr, d, first_block, n, cols_per_block);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* wf = static_cast<const float*>(w);
  const int* tp = static_cast<const int*>(trim_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  const int threads = groups * cols_per_block;
  cudaError_t err;
  switch (r) {
#define ROWS_CASE(R)                                                         \
  case R:                                                                    \
    err = launch_rows<R>(log2_np2, tab, nb, threads, smem, s, wf, m, k,      \
                         cols_per_block, is_bf16, mode, trim, tp);           \
    break;
    ROWS_CASE(1)
    ROWS_CASE(3)
    ROWS_CASE(6)
    ROWS_CASE(8)
#undef ROWS_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
