// Coordinate-wise sort-and-reduce of an (m, d) worker stack: the median,
// trimmed mean or mean of every column, written as (d,) float32.
//
// Replaces the reduce stage of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel -> _reduce_tile ->
// _sorted_rows / _bitonic_sort_rows): its static-trim forms (cwtm, cwmed,
// reduce="mean") and its traced-trim form (cwtm_masked). The trim count is a
// runtime argument here, so one kernel serves both.
//
// What bounds it: memory. A call reads each of the m*d inputs once and writes
// d floats, m*d*(4 or 2) + 4*d bytes. The sorting network costs about
// NP2*log2(NP2)^2/2 min/max pairs per column, far below the card's compute
// rate for m <= 64. At the training path's shapes (17 x <= 9610 f32, under
// 0.7 MB) the launch itself takes longer than the bytes.
//
// Design: one thread per column, 256 threads a block over d. Thread c reads
// x[i, c] for every row i, so the 32 threads of a warp read 32 adjacent values
// of one row: coalesced. The m values are cast to float and held in a
// register array; the sort network, the padding, the NaN rule and the
// summation order are those of sort_network.cuh, shared with combine.cu. The
// runtime m and trim only predicate which sorted rows are summed.
//
// The kernel allocates nothing; the caller passes the output buffer and the
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

template <int LOG2_NP2, typename T>
__global__ void __launch_bounds__(kThreads)
    cw_reduce_kernel(const T* __restrict__ x, float* __restrict__ out, int m,
                     int d, int mode, int trim) {
  constexpr int NP2 = 1 << LOG2_NP2;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;

  float v[NP2];
#pragma unroll
  for (int i = 0; i < NP2; ++i) {
    v[i] = i < m ? to_float(x[static_cast<size_t>(i) * d + col]) : 0.0f;
  }
  out[col] = sortnet::reduce_column<LOG2_NP2>(v, m, mode, trim);
}

template <typename T>
cudaError_t launch(const void* x, float* out, int m, int d, int mode,
                   int trim, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid((d + kThreads - 1) / kThreads);
  int log2_np2 = 0;
  while ((1 << log2_np2) < m) ++log2_np2;
  switch (log2_np2) {
#define CW_REDUCE_CASE(L)                                                \
  case L:                                                                \
    cw_reduce_kernel<L, T><<<grid, kThreads, 0, stream>>>(xt, out, m, d, \
                                                          mode, trim);   \
    break;
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
  return cudaGetLastError();
}

}  // namespace

// x: (m, d) row-major, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1);
// out: (d,) float32. mode 0: trimmed mean over sorted rows [trim, m - trim)
// (the median is trim = (m-1)/2); mode 1: mean. Returns a cudaError_t.
extern "C" int cw_reduce_launch(const void* x, void* out, int m, int d,
                                int is_bf16, int mode, int trim,
                                void* stream) {
  if (m < 1 || m > (1 << kMaxLog2Rows) || d < 1 || trim < 0 ||
      2 * trim >= m || (mode != kTrimmed && mode != kMean)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, o, m, d, mode, trim, s)
              : launch<float>(x, o, m, d, mode, trim, s);
  return static_cast<int>(err);
}

extern "C" const char* cw_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
