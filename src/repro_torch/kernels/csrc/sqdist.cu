// Squared L2 distances between the rows of worker stacks: all pairs of one
// (m, d) stack by the Gram expansion, written as (m, m) float32, and every
// row of x (m, d) against every row of y (k, d) by direct subtraction,
// written as (m, k) float32. Both are clamped at 0; NaN stays NaN.
//
// Replaces the pairwise stage of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel with pairwise=True,
// the public pairwise_sqdist, fused.py:266) and the cross-distance kernel
// src/repro/kernels/fused.py::cross_sqdist (_cross_kernel, fused.py:286).
//
// What bounds it: memory. The Gram product does 2 flops per pair and column
// over m*(m+1)/2 pairs i <= j: m/4 flops per byte of f32 read (4.3 at the
// training path's m = 17, 16 at m = 64), under the 20 of the card's f32
// rate over its memory rate; the cross distances do 3*k/(m+k) per byte.
// Tensor cores would buy nothing, and TF32 would break float32 parity. At
// the training path's shapes (17 x <= 9610 f32, under 0.7 MB) the launch
// itself takes longer than the bytes.
//
// Design: a split-K reduction in a fixed order, so that a rerun gives the
// same bits (no float atomics). Launch 1 (pair_partials_kernel): B blocks of
// 256 threads; block b takes the 64-column chunks b, b+B, b+2B, ... of d,
// stages each chunk of both row sets in shared memory as float32 (row stride
// 65, so threads reading different rows at one column hit different banks),
// and accumulates its partial sum for every pair (i, j): x_i . x_j for i <= j
// (the Gram matrix), or sum_c (x_ic - y_jc)^2 (the cross distances). A pair
// belongs to S consecutive threads of a warp (S = 1 when there are 256 pairs
// or more, up to 32 when there are few), each summing every S-th column of
// the chunk by fmaf; an xor-shuffle butterfly adds the S sums at the end, and
// the block writes its partial to scratch laid out pair-major, (pairs, B).
// Launch 2 (pair_finish_kernel, one block of 1024 threads): a warp per pair
// adds the B partials, lane l taking blocks l, l+32, ..., then a butterfly,
// all in a fixed order. For the Gram matrix the epilogue then forms
// (sq_i + sq_j) - 2*g_ij once over all of d, with sq_i = g_ii, rounding each
// operation on its own (no contraction into an fma) as the plain version's
// separate tensor operations do, and mirrors it to j < i. This is the plain
// version's formula and nothing forces the diagonal: it comes out exactly 0
// here, where the plain version, whose sq_i and g_ii are two different sums,
// leaves a rounding residue of the size of ulp(sq_i).
//
// The kernels allocate nothing; the caller passes the scratch, of
// rows_a * rows_b * sqdist_num_blocks(d) floats, the output and the stream,
// and checks the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "sort_network.cuh"

namespace {

using sortnet::max_nan;
using sortnet::to_float;

constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kChunk = 64;  // columns of d per shared-memory tile
constexpr int kStride = kChunk + 1;
constexpr int kMaxRows = 64;
constexpr int kMaxPairsPerThread = kMaxRows * kMaxRows / kThreads;
constexpr int kMaxBlocks = 264;  // two blocks on each of the H100's 132 SMs

enum Kind { kGram = 0, kSqDiff = 1 };

template <typename T>
__device__ __forceinline__ void stage_rows(float (*dst)[kStride],
                                           const T* __restrict__ src,
                                           int rows, int d, int c0,
                                           int width) {
  for (int t = threadIdx.x; t < rows * kChunk; t += kThreads) {
    const int r = t / kChunk;
    const int c = t % kChunk;
    dst[r][c] =
        c < width ? to_float(src[static_cast<size_t>(r) * d + c0 + c]) : 0.0f;
  }
}

// a: (na, d); b: (nb, d), unused for kGram (b is a there and nb == na).
// partial: (na * nb, gridDim.x), pair q = i * nb + j.
template <int KIND, typename T>
__global__ void __launch_bounds__(kThreads)
    pair_partials_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         float* __restrict__ partial, int na, int nb, int d,
                         int log2_sub) {
  __shared__ float sa[kMaxRows][kStride];
  __shared__ float sb[KIND == kSqDiff ? kMaxRows : 1][kStride];
  const int sub = 1 << log2_sub;
  const int groups = kThreads >> log2_sub;
  const int g = threadIdx.x >> log2_sub;
  const int s = threadIdx.x & (sub - 1);
  const int n_pairs = na * nb;
  const int n_chunks = (d + kChunk - 1) / kChunk;

  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int u = 0; u < kMaxPairsPerThread; ++u) acc[u] = 0.0f;

  for (int ch = blockIdx.x; ch < n_chunks; ch += gridDim.x) {
    const int c0 = ch * kChunk;
    const int width = min(kChunk, d - c0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_rows<T>(sa, a, na, d, c0, width);
    if (KIND == kSqDiff) stage_rows<T>(sb, b, nb, d, c0, width);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMaxPairsPerThread; ++u) {
      const int q = g + u * groups;
      const int i = q / nb;
      const int j = q % nb;
      if (q < n_pairs && (KIND == kSqDiff || i <= j)) {
        float t = acc[u];
        for (int c = s; c < width; c += sub) {
          if (KIND == kGram) {
            t = fmaf(sa[i][c], sa[j][c], t);
          } else {
            const float diff = sa[i][c] - sb[j][c];
            t = fmaf(diff, diff, t);
          }
        }
        acc[u] = t;
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kMaxPairsPerThread; ++u) {
    for (int off = sub >> 1; off > 0; off >>= 1) {
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
    }
    const int q = g + u * groups;
    if (s == 0 && q < n_pairs) {
      partial[static_cast<size_t>(q) * gridDim.x + blockIdx.x] = acc[u];
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(kFinishThreads)
    pair_finish_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int na, int nb,
                       int n_blocks) {
  __shared__ float total[kMaxRows * kMaxRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_pairs = na * nb;
  for (int q = warp; q < n_pairs; q += kFinishThreads >> 5) {
    if (KIND == kGram && q % nb < q / nb) continue;  // the same for the warp
    const float* row = partial + static_cast<size_t>(q) * n_blocks;
    float t = 0.0f;
    for (int blk = lane; blk < n_blocks; blk += 32) t += row[blk];
    for (int off = 16; off > 0; off >>= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, off);
    }
    if (lane == 0) total[q] = t;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n_pairs; q += kFinishThreads) {
    if (KIND == kGram) {
      const int i = q / nb;
      const int j = q % nb;
      const float g = total[min(i, j) * nb + max(i, j)];
      const float sq = __fadd_rn(total[i * nb + i], total[j * nb + j]);
      out[q] = max_nan(__fsub_rn(sq, __fmul_rn(2.0f, g)), 0.0f);
    } else {
      out[q] = max_nan(total[q], 0.0f);
    }
  }
}

int num_blocks(int d) {
  const int n_chunks = (d + kChunk - 1) / kChunk;
  return n_chunks < kMaxBlocks ? n_chunks : kMaxBlocks;
}

template <int KIND, typename T>
cudaError_t launch(const void* a, const void* b, float* partial, float* out,
                   int na, int nb, int d, cudaStream_t stream) {
  int log2_sub = 0;  // the most threads a pair can have, up to a warp
  while (log2_sub < 5 && (na * nb << (log2_sub + 1)) <= kThreads) ++log2_sub;
  const int blocks = num_blocks(d);
  pair_partials_kernel<KIND, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), partial, na, nb, d,
      log2_sub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pair_finish_kernel<KIND><<<1, kFinishThreads, 0, stream>>>(partial, out, na,
                                                             nb, blocks);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch per pair that the launches below need for a given d.
extern "C" int sqdist_num_blocks(int d) { return d < 1 ? 0 : num_blocks(d); }

// x: (m, d) row-major, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1);
// partial: m * m * sqdist_num_blocks(d) float32; out: (m, m) float32.
extern "C" int pairwise_sqdist_launch(const void* x, void* partial, void* out,
                                      int m, int d, int is_bf16,
                                      void* stream) {
  if (m < 1 || m > kMaxRows || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<kGram, __nv_bfloat16>(x, x, p, o, m, m, d, s)
              : launch<kGram, float>(x, x, p, o, m, m, d, s);
  return static_cast<int>(err);
}

// x: (m, d), y: (k, d) row-major, both float32 or both bfloat16; partial:
// m * k * sqdist_num_blocks(d) float32; out: (m, k) float32.
extern "C" int cross_sqdist_launch(const void* x, const void* y, void* partial,
                                   void* out, int m, int k, int d, int is_bf16,
                                   void* stream) {
  if (m < 1 || m > kMaxRows || k < 1 || k > kMaxRows || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<kSqDiff, __nv_bfloat16>(x, y, p, o, m, k, d, s)
              : launch<kSqDiff, float>(x, y, p, o, m, k, d, s);
  return static_cast<int>(err);
}

extern "C" const char* sqdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
