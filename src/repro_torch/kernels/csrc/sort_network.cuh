// The per-column sort-and-reduce shared by cw_reduce.cu and combine.cu.
//
// A thread (or L lanes, below) holds one column of up to 64 rows in a
// register array padded to NP2 = next_pow2(rows) with 3.0e38f, the TPU
// kernel's pad value, so that +-inf and NaN behave as they do there. A
// bitonic network fully unrolled over the compile-time NP2 sorts it: every
// array index is a constant, so the array stays in registers. min/max
// propagate NaN (PTX min.NaN / max.NaN), as jnp.minimum / jnp.maximum do and
// fminf does not: a NaN anywhere in a column makes that column's result NaN.
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

// A column of NP2 = 2^LOG2_NP2 rows may be split over L = 2^LOG2_L
// adjacent threads of a warp, its lanes: lane j holds rows j*K .. j*K + K-1
// in v[0 .. K-1] (K = NP2 / L), and every lane of the warp takes part in the
// calls below (they shuffle). At L = 1 (lane 0) nothing is shuffled and the
// network and sums are those of one thread per column.

// Sort the column ascending. Stage s merges runs of 2^s; pass r compares
// rows i and i ^ 2^r, in registers where both lie in one lane and by
// __shfl_xor_sync across lanes, always with the lower row's value as the
// first operand of min and max. Every lane runs the same compare-exchanges
// as one thread would, so the split changes no bit. All bounds are
// compile-time, so it unrolls fully.
template <int LOG2_NP2, int LOG2_L = 0>
__device__ __forceinline__ void bitonic_sort(
    float (&v)[1 << (LOG2_NP2 - LOG2_L)], int lane = 0) {
  constexpr int LOG2_K = LOG2_NP2 - LOG2_L;
  constexpr int K = 1 << LOG2_K;
#pragma unroll
  for (int s = 1; s <= LOG2_NP2; ++s) {
    // a merge runs downward where bit s of its rows is set; from bit LOG2_K
    // on that bit is the lane's, and above the last stage it is 0
    const bool lane_down = s >= LOG2_K && s < LOG2_NP2 &&
                           ((lane >> (s >= LOG2_K ? s - LOG2_K : 0)) & 1);
#pragma unroll
    for (int r = s - 1; r >= 0; --r) {
      if (r >= LOG2_K) {  // the partner row lies in lane ^ 2^(r - LOG2_K)
        const int bit = 1 << (r >= LOG2_K ? r - LOG2_K : 0);
        const bool high = (lane & bit) != 0;  // this lane holds the upper row
        const bool keep_lo = lane_down == high;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const float p = __shfl_xor_sync(0xffffffffu, v[i], bit);
          const float a = high ? p : v[i];
          const float b = high ? v[i] : p;
          v[i] = keep_lo ? min_nan(a, b) : max_nan(a, b);
        }
      } else {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int l = i ^ (1 << r);
          if (l > i) {
            const float lo = min_nan(v[i], v[l]);
            const float hi = max_nan(v[i], v[l]);
            const bool up = s < LOG2_K ? (i & (1 << s)) == 0 : !lane_down;
            v[i] = up ? lo : hi;
            v[l] = up ? hi : lo;
          }
        }
      }
    }
  }
}

// acc plus rows [lo, hi) of the column, added one at a time in row order:
// lane 0 adds its rows and hands the sum to lane 1, which adds its own, and
// so on. The last lane returns the whole sum.
template <int LOG2_K, int LOG2_L>
__device__ __forceinline__ float row_sum(const float (&v)[1 << LOG2_K],
                                         float acc, int lo, int hi,
                                         int lane) {
  constexpr int K = 1 << LOG2_K;
  constexpr int L = 1 << LOG2_L;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (lane == j) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (j * K + i >= lo && j * K + i < hi) acc += v[i];
      }
    }
    if (j + 1 < L) {
      const float prev = __shfl_up_sync(0xffffffffu, acc, 1, L);
      if (lane == j + 1) acc = prev;
    }
  }
  return acc;
}

// Pad the first n rows of the column to NP2 with kPad, sort, and reduce:
// the trimmed mean over sorted rows [trim, n - trim), summed from -0.0f
// (the median is trim = (n-1)/2), or the mean of the unsorted rows, summed
// from row 0. The last lane holds the result.
template <int LOG2_NP2, int LOG2_L = 0>
__device__ __forceinline__ float reduce_column(
    float (&v)[1 << (LOG2_NP2 - LOG2_L)], int n, int mode, int trim,
    int lane = 0) {
  constexpr int LOG2_K = LOG2_NP2 - LOG2_L;
  constexpr int K = 1 << LOG2_K;
  if (mode == kMean) {
    return row_sum<LOG2_K, LOG2_L>(v, v[0], 1, n, lane) /
           static_cast<float>(n);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (lane * K + i >= n) v[i] = kPad;
  }
  bitonic_sort<LOG2_NP2, LOG2_L>(v, lane);
  return row_sum<LOG2_K, LOG2_L>(v, -0.0f, trim, n - trim, lane) /
         static_cast<float>(n - 2 * trim);
}

}  // namespace sortnet
