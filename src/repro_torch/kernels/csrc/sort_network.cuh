// The per-column sort-and-reduce shared by cw_reduce.cu and combine.cu.
//
// A thread holds one column of up to 64 rows in a register array padded to
// NP2 = next_pow2(rows) with 3.0e38f, the TPU kernel's pad value, so that
// +-inf and NaN behave as they do there. A bitonic network fully unrolled
// over the compile-time NP2 sorts it: every array index is a constant, so the
// array stays in registers. min/max propagate NaN (PTX min.NaN / max.NaN), as
// jnp.minimum / jnp.maximum do and fminf does not: a NaN anywhere in a column
// makes that column's result NaN.
//
// The trimmed sum adds srt[trim] .. srt[n-trim-1] in row order, starting
// from -0.0f so that the first addition returns srt[trim] exactly, and
// divides by float(n - 2*trim): the TPU kernel's static-slice sum, and its
// masked sum up to the sign of zero. The median is the trimmed mean at
// trim = (n-1)/2 (one row for odd n; (a+b)/2 == 0.5*(a+b) for even n). The
// mean sums the unsorted rows in order and divides by float(n).

#pragma once

#include <cuda_bf16.h>

namespace sortnet {

constexpr float kPad = 3.0e38f;
constexpr int kMaxLog2Rows = 6;  // rows <= 64

enum Reduce { kTrimmed = 0, kMean = 1 };

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sort v ascending. Stage s merges runs of 2^s; pass r compares rows i and
// i ^ 2^r. All bounds are compile-time, so it unrolls fully.
template <int LOG2_NP2>
__device__ __forceinline__ void bitonic_sort(float (&v)[1 << LOG2_NP2]) {
  constexpr int NP2 = 1 << LOG2_NP2;
#pragma unroll
  for (int s = 1; s <= LOG2_NP2; ++s) {
#pragma unroll
    for (int r = s - 1; r >= 0; --r) {
#pragma unroll
      for (int i = 0; i < NP2; ++i) {
        const int l = i ^ (1 << r);
        if (l > i) {
          const float lo = min_nan(v[i], v[l]);
          const float hi = max_nan(v[i], v[l]);
          const bool up = (i & (1 << s)) == 0;
          v[i] = up ? lo : hi;
          v[l] = up ? hi : lo;
        }
      }
    }
  }
}

// Mean of the first n (unsorted) rows, summed in row order.
template <int NP2>
__device__ __forceinline__ float row_mean(const float (&v)[NP2], int n) {
  float acc = v[0];
#pragma unroll
  for (int i = 1; i < NP2; ++i) {
    if (i < n) acc += v[i];
  }
  return acc / static_cast<float>(n);
}

// Mean of sorted rows [trim, n - trim), summed in row order.
template <int NP2>
__device__ __forceinline__ float trimmed_mean(const float (&v)[NP2], int n,
                                              int trim) {
  float acc = -0.0f;
#pragma unroll
  for (int i = 0; i < NP2; ++i) {
    if (i >= trim && i < n - trim) acc += v[i];
  }
  return acc / static_cast<float>(n - 2 * trim);
}

// Pad the first n rows of v to NP2 with kPad, sort, and reduce: the
// trimmed mean (the median is trim = (n-1)/2) or the mean.
template <int LOG2_NP2>
__device__ __forceinline__ float reduce_column(float (&v)[1 << LOG2_NP2],
                                               int n, int mode, int trim) {
  constexpr int NP2 = 1 << LOG2_NP2;
  if (mode == kMean) return row_mean<NP2>(v, n);
#pragma unroll
  for (int i = 0; i < NP2; ++i) {
    if (i >= n) v[i] = kPad;
  }
  bitonic_sort<LOG2_NP2>(v);
  return trimmed_mean<NP2>(v, n, trim);
}

}  // namespace sortnet
