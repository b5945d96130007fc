// Weighted combine of an (m, d) worker stack, y = w @ x for w (k, m), and
// its mix-then-reduce form: the k rows of y sorted and reduced per column
// (median, trimmed mean or mean) to (d,) float32, optionally writing y too.
//
// Replaces the combine and mix+reduce stages of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel with has_w: the
// `w @ x` dot, `combine` written to the (k, d) output, `reduce` over the rows
// of y through _reduce_tile): weighted_combine (fused.py:273) and the
// fused_op(w=..., reduce=..., combine=...) forms (ops.py:388) that
// agg_engine.combine_reduce uses for NNM with a coordinate-wise base.
//
// What bounds it: memory, up to large k. A call reads the m*d inputs once
// and writes k*d (combine) and/or d (reduce) floats, and does 2*k*m flops per
// column plus, for a reduce, the sort network's NP2*log2(NP2)*(log2(NP2)+1)/2
// min/max operations. That is 4.3 operations per byte for the combine at
// k = m = 17 f32 and 15 for the mix+reduce, under the 20 of the card's f32
// rate over its memory rate; the mix+reduce at k = m = 64 (37 per byte) is
// bound by operations. At the training path's shapes (17 x <= 9610 f32,
// under 1.4 MB) the launch itself takes longer than either.
//
// Design: the layout of cw_reduce.cu. One thread per column, 256 threads a
// block over d, w (at most 64 x 64 float32, 16 KB) in shared memory, read by
// every thread of a warp at one address (a broadcast). x is read row by row,
// coalesced, and never held: each of the k outputs y_r = sum_i w[r,i]*x_i is
// one register, accumulated by fmaf in row order i = 0 .. m-1, so k = m = 64
// needs 64 accumulators and no more. The accumulators live in an array sized
// by the compile-time NP2 = next_pow2(k), indexed by constants only, so it
// stays in registers. Template flags pick the outputs: WRITE_Y writes y,
// REDUCE sorts the k values with sort_network.cuh (shared with cw_reduce.cu:
// the same padding, NaN rule and row-order sums) and writes the reduction.
//
// The kernel allocates nothing; the caller passes the output buffers and the
// stream, and checks the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "sort_network.cuh"

namespace {

using sortnet::kMaxLog2Rows;
using sortnet::kMean;
using sortnet::kTrimmed;
using sortnet::to_float;

constexpr int kThreads = 256;
constexpr int kMaxRows = 1 << kMaxLog2Rows;
constexpr int kNoReduce = -1;

template <int LOG2_NP2, typename T, bool WRITE_Y, bool REDUCE>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, float* __restrict__ out, int m,
                   int k, int d, int mode, int trim) {
  constexpr int NP2 = 1 << LOG2_NP2;
  __shared__ float ws[kMaxRows * kMaxRows];
  for (int t = threadIdx.x; t < k * m; t += kThreads) ws[t] = w[t];
  __syncthreads();
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;

  float acc[NP2];
#pragma unroll
  for (int r = 0; r < NP2; ++r) acc[r] = 0.0f;
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    const float xi = to_float(x[static_cast<size_t>(i) * d + col]);
#pragma unroll
    for (int r = 0; r < NP2; ++r) {
      if (r < k) acc[r] = fmaf(ws[r * m + i], xi, acc[r]);
    }
  }
  if (WRITE_Y) {
#pragma unroll
    for (int r = 0; r < NP2; ++r) {
      if (r < k) y[static_cast<size_t>(r) * d + col] = acc[r];
    }
  }
  if (REDUCE) out[col] = sortnet::reduce_column<LOG2_NP2>(acc, k, mode, trim);
}

template <typename T, bool WRITE_Y, bool REDUCE>
cudaError_t launch(const void* x, const float* w, float* y, float* out, int m,
                   int k, int d, int mode, int trim, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid((d + kThreads - 1) / kThreads);
  int log2_np2 = 0;
  while ((1 << log2_np2) < k) ++log2_np2;
  switch (log2_np2) {
#define COMBINE_CASE(L)                                                     \
  case L:                                                                   \
    combine_kernel<L, T, WRITE_Y, REDUCE>                                   \
        <<<grid, kThreads, 0, stream>>>(xt, w, y, out, m, k, d, mode, trim); \
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

template <typename T>
cudaError_t launch_outputs(const void* x, const float* w, float* y,
                           float* out, int m, int k, int d, int mode,
                           int trim, cudaStream_t stream) {
  if (mode == kNoReduce) {
    return launch<T, true, false>(x, w, y, out, m, k, d, mode, trim, stream);
  }
  if (y == nullptr) {
    return launch<T, false, true>(x, w, y, out, m, k, d, mode, trim, stream);
  }
  return launch<T, true, true>(x, w, y, out, m, k, d, mode, trim, stream);
}

}  // namespace

// x: (m, d) row-major, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1);
// w: (k, m) row-major float32. y: (k, d) float32 or null; out: (d,) float32
// or null. mode -1: write y = w @ x only; mode 0: the trimmed mean over the
// sorted rows [trim, k - trim) of y (the median is trim = (k-1)/2); mode 1:
// the mean of the rows of y. Returns a cudaError_t.
extern "C" int combine_launch(const void* x, const void* w, void* y, void* out,
                              int m, int k, int d, int is_bf16, int mode,
                              int trim, void* stream) {
  const bool reduce = mode != kNoReduce;
  if (m < 1 || m > kMaxRows || k < 1 || k > kMaxRows || d < 1 ||
      (mode != kNoReduce && mode != kTrimmed && mode != kMean) ||
      (reduce ? out == nullptr : y == nullptr) || trim < 0 ||
      (mode == kTrimmed && 2 * trim >= k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_outputs<__nv_bfloat16>(x, wf, yf, of, m, k, d, mode,
                                              trim, s)
              : launch_outputs<float>(x, wf, yf, of, m, k, d, mode, trim, s);
  return static_cast<int>(err);
}

extern "C" const char* combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
