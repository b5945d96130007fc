// Squared L2 distances between the rows of worker stacks, in one launch per
// call: all pairs of one (m, d) stack by the Gram expansion, written as
// (m, m) float32, and every row of x (m, d) against every row of y (k, d) by
// direct subtraction, written as (m, k) float32. Both are clamped at 0; NaN
// stays NaN.
//
// Replaces the pairwise stage of the Pallas TPU kernel
// src/repro/kernels/fused.py::fused_pass (_fused_kernel with pairwise=True,
// the public pairwise_sqdist, fused.py:266) and the cross-distance kernel
// src/repro/kernels/fused.py::cross_sqdist (_cross_kernel, fused.py:286).
//
// What bounds it: at the training path's shapes (17 x <= 9610 f32, under
// 0.7 MB) the launch and the latency of the loads, not the bytes (0.2 us at
// 3.35 TB/s) and not the arithmetic. The Gram product does 2 flops per pair
// and column over the m(m+1)/2 pairs i <= j, m/4 flops per byte of f32 read
// (4.3 at m = 17, 16 at m = 64), under the 20 of the card's f32 rate over
// its memory rate; the cross distances do 3k/(m+k) per byte. Tensor cores
// would buy nothing, and TF32 would break float32 parity. Inside one block
// the Gram pairs are bound by shared-memory reads: two 16-byte loads for
// every four fmaf of a pair.
//
// Design. One launch of B blocks of 256 threads, B from the plan the caller
// passes (kernels/fused.py::sqdist_plan: at most two 64-column units a
// block, at most one block per SM). Block b takes the contiguous columns
// [b*span, (b+1)*span) of d, span a whole number of units.
//  * Loads in flight: the block stages its span in chunks of 64, 128 or 256
//    columns (the widest whose ring fits 96 KB, never wider than the span)
//    in a ring of 2 to 4 shared-memory stages, by cp.async, the next chunks
//    in flight while one is summed; one barrier a chunk. Rows that are
//    16-byte aligned (base pointer aligned and d a multiple of 4 f32 or 8
//    bf16) go by 16-byte copies; other rows (d = 10, d = 9610, slices) by
//    4-byte cp.async for f32 and plain loads for bf16, and their ragged last
//    vector is zero-filled. A tile row is the chunk plus 16 bytes: 16-byte
//    aligned, and rows sit 4 banks apart, so the 16-byte shared loads of 8
//    lanes on 8 consecutive rows, or on one row's consecutive vectors, hit
//    different banks.
//  * Only the pairs that are computed: the Gram pairs i <= j are enumerated
//    directly (153 at m = 17), the cross pairs are all m*k. A pair belongs to
//    S lanes of a warp (S the largest power of two, up to 32 and a chunk's
//    16-byte vectors, that keeps pairs*S <= 256), lane s taking the vectors
//    s, s+S, ... of each chunk, four at a time in flight, into 4
//    accumulators (vector element e into e % 4) by fmaf in a fixed order. A
//    thread holds U pairs, U = ceil(pairs / (256/S)) rounded up to 1, 2, 4,
//    9 or 16, so its accumulators stay in registers.
//  * The sum is a tree in a fixed order: each chunk's 4 accumulators are
//    added to the span's 4, so no fmaf chain is longer than a chunk's
//    columns over 4S whatever d (at the tuned plan 32 terms for the Gram
//    pairs at m = 17 and 4 for the cross pairs at k = 1), then
//    ((a0 + a1) + (a2 + a3)), then an xor butterfly over the S lanes.
//  * One block (d within one span) writes the totals to shared memory and
//    goes on to the epilogue: no scratch, no step across blocks. With B > 1
//    each block writes its partial per pair to the caller's scratch, laid
//    out (B, pairs), then __threadfence(); one thread takes a ticket with
//    atomicAdd on the caller's int32 counter, and the block that draws the
//    last ticket adds every pair's B partials, lane s of the pair taking the
//    blocks s, s+S, ... in block-index order (16 loads in flight, then their
//    sums) and then the butterfly, so the bits depend on the plan alone and
//    never on which block finished last. It sets the counter back to 0 for
//    the next call and every replay of a captured CUDA graph. No float
//    atomics: a rerun gives the same bits.
//  * Epilogue: for the Gram matrix (sq_i + sq_j) - 2*g_ij with sq_i = g_ii,
//    each operation rounded on its own (no contraction into an fma) as the
//    plain version's separate tensor operations round them, clamped with
//    max.NaN and mirrored to j < i. The diagonal comes out exactly 0, where
//    the plain version, whose sq_i and g_ii are two different sums, leaves a
//    residue of the size of ulp(sq_i). Cross distances are the sums, clamped.
//
// Tuned plan: two units (128 columns) a block, one where a block's 64
// columns hold more than 256 pairs. Device us per call by CUDA graph replay
// (benchmarks_torch/time_kernels.py --sweep, NVIDIA H100 80GB HBM3, 700 W,
// f32, m = 17; K6 at k = 1), by units a block:
//
//   shape         kernel  1 unit  2 units  3 units  4 units  one block
//   17 x 8192     K3      8.80    6.92     7.14     6.63     68.3
//   17 x 8192     K6      4.30    4.05     5.04     4.25     27.3
//   17 x 1280     K3      5.22    5.08     5.93     5.78     12.2
//   17 x 1280     K6      4.08    4.09     4.95     4.17     5.60
//   17 x 9610     K3      -       8.01     8.56     8.31     -
//   17 x 9610     K6      -       4.93     6.09     5.62     -
//
// Two units is the best or within 5 % of it at every shape; three lose to
// both neighbours (a 192-column span is a 128-column chunk and a ragged
// 64-column one). One block is bound by the Gram's shared-memory reads, so
// wide spans lose: the step across blocks (partials, fence, ticket, the
// last block's loads) costs about 1.7 us at 17 x 1280, and a block of 10
// times the columns costs more.
//
// The kernels allocate nothing. The caller passes the inputs, the scratch
// (B * pairs float32, unused and may be null when B == 1), the counter (one
// int32 that is 0 between calls and that no other call running at the same
// time uses; may be null when B == 1), the output and the stream, and checks
// the returned cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sort_network.cuh"

namespace {

using sortnet::max_nan;

constexpr int kThreads = 256;
constexpr int kUnit = 64;      // columns: spans are whole units of the plan
constexpr int kPadBytes = 16;  // per tile row: 16-byte aligned, 4 banks on
constexpr int kMaxRows = 64;
constexpr int kMaxBlocks = 132;  // one block per SM of the H100
constexpr int kAcc = 4;          // accumulators per pair and lane
constexpr int kStepVecs = 4;     // 16-byte vectors a lane loads per step
constexpr int kMaxStages = 4;    // chunks in the shared-memory ring
constexpr int kRingBudget = 96 * 1024;  // shared bytes the ring may fill
constexpr int kFinishLoads = 16;  // partials a lane has in flight
constexpr int kStaticSmemLimit = 48 * 1024;
// The most dynamic shared memory a launch asks for: the ring and 4096 pair
// totals (cross distances at m = k = 64).
constexpr int kMaxSmem = kRingBudget + kMaxRows * kMaxRows * 4;

enum Kind { kGram = 0, kSqDiff = 1 };

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `newer` committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int newer) {
  switch (newer) {  // the count is an immediate operand
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// Copy the columns [c0, c0 + width) of rows [0, rows) of src (row stride d
// elements) into tile (row stride `row` bytes). A full chunk of 16-byte
// aligned rows (nv = 1 << log2_nv vectors a row) goes by 16-byte cp.async
// with no division; the scalar path also zeroes the columns
// [width, round_up(width, kN)) that its last vector reads.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* tile,
                                      const T* __restrict__ src, int rows,
                                      int row, int d, int c0, int width,
                                      int log2_nv, bool vec) {
  constexpr int kN = Vec<T>::kN;
  if (vec && width == (kN << log2_nv)) {
    const int nv = 1 << log2_nv;
    for (int t = threadIdx.x; t < rows << log2_nv; t += kThreads) {
      const int r = t >> log2_nv;
      const int v = t & (nv - 1);
      cp_async16(tile + r * row + v * 16,
                 src + static_cast<size_t>(r) * d + c0 + v * kN);
    }
    return;
  }
  if (vec) {  // the ragged last chunk of a span: width % kN == 0
    const int nv = width / kN;
    for (int t = threadIdx.x; t < rows * nv; t += kThreads) {
      const int r = t / nv;
      const int v = t - r * nv;
      cp_async16(tile + r * row + v * 16,
                 src + static_cast<size_t>(r) * d + c0 + v * kN);
    }
    return;
  }
  const int wp = (width + kN - 1) / kN * kN;
  for (int t = threadIdx.x; t < rows * wp; t += kThreads) {
    const int r = t / wp;
    const int c = t - r * wp;
    T* dst = reinterpret_cast<T*>(tile + r * row) + c;
    const T* s = src + static_cast<size_t>(r) * d + c0 + c;
    if (c >= width) {
      if (sizeof(T) == 4) {
        *reinterpret_cast<float*>(dst) = 0.0f;
      } else {
        *reinterpret_cast<unsigned short*>(dst) = 0;
      }
    } else if (sizeof(T) == 4) {
      cp_async4(dst, s);
    } else {
      *dst = *s;  // cp.async copies 4, 8 or 16 bytes, not one bf16
    }
  }
}

// One 16-byte vector of the tile as float32.
__device__ __forceinline__ void unpack(const unsigned char* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void unpack(const unsigned char* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k is the low half of word k
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int KIND, int N>
__device__ __forceinline__ void accumulate(float (&acc)[kAcc],
                                           const float (&x)[N],
                                           const float (&y)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (KIND == kGram) {
      acc[e % kAcc] = fmaf(x[e], y[e], acc[e % kAcc]);
    } else {
      const float diff = __fsub_rn(x[e], y[e]);
      acc[e % kAcc] = fmaf(diff, diff, acc[e % kAcc]);
    }
  }
}

// Index of the Gram pair (i, j), i <= j, in the row-by-row enumeration.
__device__ __forceinline__ int gram_pair(int i, int j, int m) {
  return i * m - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ float butterfly(float t, int sub) {
  for (int off = sub >> 1; off > 0; off >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  return t;
}

// a: (na, d); b: (nb, d), unused for kGram (b is a there and nb == na).
// partial: (gridDim.x, pairs); out: (na, nb). A chunk is kN << log2_nv
// columns, a tile row `row` bytes, the ring `stages` chunks.
template <int KIND, typename T, int U>
__global__ void __launch_bounds__(kThreads)
    sqdist_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ partial, unsigned* __restrict__ counter,
                  float* __restrict__ out, int na, int nb, int d, int span,
                  int log2_sub, int log2_nv, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned ticket;
  constexpr int kN = Vec<T>::kN;
  const int chunk = kN << log2_nv;
  const int row = chunk * static_cast<int>(sizeof(T)) + kPadBytes;
  const int stage_bytes = (KIND == kGram ? na : na + nb) * row;
  float* total = reinterpret_cast<float*>(smem + stages * stage_bytes);
  const int n_pairs = KIND == kGram ? na * (na + 1) / 2 : na * nb;
  const int sub = 1 << log2_sub;
  const int groups = kThreads >> log2_sub;
  const int g = threadIdx.x >> log2_sub;
  const int s = threadIdx.x & (sub - 1);

  // this thread's pairs q = g + u * groups, as byte offsets of their two
  // rows in a stage (b's rows follow a's there)
  int off_i[U], off_j[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int q = g + u * groups;
    int i = 0, j = 0;
    if (q < n_pairs) {
      if (KIND == kGram) {
        int r = q;
        while (r >= na - i) {
          r -= na - i;
          ++i;
        }
        j = i + r;
      } else {
        i = q / nb;
        j = q - i * nb;
      }
    }
    off_i[u] = i * row;
    off_j[u] = (KIND == kGram ? j : na + j) * row;
  }

  // acc sums one chunk; span_acc adds the chunks' sums in order, so that no
  // fmaf chain outgrows a chunk however wide the span
  float acc[U][kAcc], span_acc[U][kAcc];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) span_acc[u][e] = 0.0f;
  }

  const int c_begin = blockIdx.x * span;
  const int c_end = min(d, c_begin + span);
  const int n_local = (c_end - c_begin + chunk - 1) / chunk;
  auto stage_chunk = [&](int n) {
    unsigned char* tile = smem + (n % stages) * stage_bytes;
    const int c0 = c_begin + n * chunk;
    const int width = min(chunk, c_end - c0);
    stage<T>(tile, a, na, row, d, c0, width, log2_nv, vec);
    if (KIND == kSqDiff) {
      stage<T>(tile + na * row, b, nb, row, d, c0, width, log2_nv, vec);
    }
  };

  // a ring of `stages` chunks: chunk n + stages - 1 is issued as soon as
  // every thread is done with chunk n - 1, whose buffer it takes, so that
  // stages - 1 chunks are in flight while chunk n is summed. Every step
  // commits one group, empty past the end, so chunk n's group always has
  // stages - 2 groups after it when it is waited for.
  for (int p = 0; p < stages - 1; ++p) {
    if (p < n_local) stage_chunk(p);
    cp_async_commit();
  }
  for (int n = 0; n < n_local; ++n) {
    cp_async_wait(stages - 2);
    __syncthreads();  // chunk n has landed; chunk n - 1 is summed by all
    if (n + stages - 1 < n_local) stage_chunk(n + stages - 1);
    cp_async_commit();
    const unsigned char* tile = smem + (n % stages) * stage_bytes;
    const int width = min(chunk, c_end - (c_begin + n * chunk));
    const int nv = (width + kN - 1) / kN;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[u][e] = 0.0f;
      if (g + u * groups < n_pairs) {
        const unsigned char* ri = tile + off_i[u];
        const unsigned char* rj = tile + off_j[u];
        int v = s;
        // kStepVecs vectors of both rows in flight, then their sums in the
        // order of v, as the one-vector tail below adds them
        for (; v + (kStepVecs - 1) * sub < nv; v += kStepVecs * sub) {
          float x[kStepVecs][kN], y[kStepVecs][kN];
#pragma unroll
          for (int k = 0; k < kStepVecs; ++k) {
            unpack(ri + (v + k * sub) * 16, x[k]);
            unpack(rj + (v + k * sub) * 16, y[k]);
          }
#pragma unroll
          for (int k = 0; k < kStepVecs; ++k) {
            accumulate<KIND, kN>(acc[u], x[k], y[k]);
          }
        }
        for (; v < nv; v += sub) {
          float x[kN], y[kN];
          unpack(ri + v * 16, x);
          unpack(rj + v * 16, y);
          accumulate<KIND, kN>(acc[u], x, y);
        }
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) span_acc[u][e] += acc[u][e];
    }
  }

  float sums[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    sums[u] = butterfly((span_acc[u][0] + span_acc[u][1]) +
                            (span_acc[u][2] + span_acc[u][3]),
                        sub);
  }

  if (gridDim.x == 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = g + u * groups;
      if (s == 0 && q < n_pairs) total[q] = sums[u];
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = g + u * groups;
      if (s == 0 && q < n_pairs) {
        partial[static_cast<size_t>(blockIdx.x) * n_pairs + q] = sums[u];
      }
    }
    __threadfence();  // the partials are visible before the ticket is taken
    __syncthreads();
    if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
    __syncthreads();
    if (ticket != gridDim.x - 1) return;  // the same for the whole block
    __threadfence();
    if (threadIdx.x == 0) *counter = 0u;  // every other block has drawn
    const int n_blocks = static_cast<int>(gridDim.x);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = g + u * groups;
      float t = 0.0f;
      if (q < n_pairs) {  // kFinishLoads loads in flight, then their sums
        for (int b0 = s; b0 < n_blocks; b0 += kFinishLoads * sub) {
          float v[kFinishLoads];
#pragma unroll
          for (int k = 0; k < kFinishLoads; ++k) {
            const int blk = b0 + k * sub;
            v[k] = blk < n_blocks
                       ? __ldcg(partial + static_cast<size_t>(blk) * n_pairs + q)
                       : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < kFinishLoads; ++k) {
            if (b0 + k * sub < n_blocks) t += v[k];
          }
        }
      }
      t = butterfly(t, sub);
      if (s == 0 && q < n_pairs) total[q] = t;
    }
  }
  __syncthreads();

  for (int o = threadIdx.x; o < na * nb; o += kThreads) {
    if (KIND == kGram) {
      const int i = o / nb;
      const int j = o - i * nb;
      const float gij = total[gram_pair(min(i, j), max(i, j), na)];
      const float sq =
          __fadd_rn(total[gram_pair(i, i, na)], total[gram_pair(j, j, na)]);
      out[o] = max_nan(__fsub_rn(sq, __fmul_rn(2.0f, gij)), 0.0f);
    } else {
      out[o] = max_nan(total[o], 0.0f);
    }
  }
}

template <int KIND, typename T, int U>
cudaError_t launch_u(const T* a, const T* b, float* partial, unsigned* counter,
                     float* out, int na, int nb, int d, int blocks, int span,
                     int log2_sub, int log2_nv, int stages, int vec,
                     int smem_bytes, cudaStream_t stream) {
  auto kernel = sqdist_kernel<KIND, T, U>;
  static bool opted_in = false;  // above 48 KB only after opting in, once
  if (smem_bytes > kStaticSmemLimit && !opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kernel<<<blocks, kThreads, smem_bytes, stream>>>(
      a, b, partial, counter, out, na, nb, d, span, log2_sub, log2_nv, stages,
      vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <int KIND, typename T>
cudaError_t launch(const void* a_, const void* b_, void* partial_,
                   void* counter_, void* out_, int na, int nb, int d,
                   int blocks, int units_per_block, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  float* partial = static_cast<float*>(partial_);
  unsigned* counter = static_cast<unsigned*>(counter_);
  float* out = static_cast<float*>(out_);
  const long long span = static_cast<long long>(units_per_block) * kUnit;
  if (blocks < 1 || blocks > kMaxBlocks || units_per_block < 1 ||
      span * blocks < d || span * (blocks - 1) >= d || span > (1 << 30) ||
      (blocks > 1 && (partial == nullptr || counter == nullptr))) {
    return cudaErrorInvalidValue;  // a plan that leaves columns or blocks idle
  }
  const int rows = KIND == kGram ? na : na + nb;
  const int n_pairs = KIND == kGram ? na * (na + 1) / 2 : na * nb;
  const int totals = n_pairs * static_cast<int>(sizeof(float));
  // The widest chunk of 64, 128 or 256 columns whose ring fits the budget
  // (three stages for 256, two otherwise), never wider than the span, and
  // as many stages of it as fit, up to kMaxStages.
  int log2_nv = 0;  // chunk = kN << log2_nv columns
  while ((kN << log2_nv) < kUnit) ++log2_nv;
  for (int want = 256; want > kUnit; want >>= 1) {
    const int row = want * static_cast<int>(sizeof(T)) + kPadBytes;
    if (want <= span && (want == 256 ? 3 : 2) * rows * row <= kRingBudget) {
      while ((kN << log2_nv) < want) ++log2_nv;
      break;
    }
  }
  const int chunk = kN << log2_nv;
  const int stage_bytes =
      rows * (chunk * static_cast<int>(sizeof(T)) + kPadBytes);
  const int stages = max(2, min(kMaxStages, kRingBudget / stage_bytes));
  const int smem_bytes = stages * stage_bytes + totals;
  int log2_sub = 0;  // lanes a pair: up to a warp and a chunk's vectors
  while (log2_sub < 5 && (2 << log2_sub) <= (chunk / kN) &&
         (n_pairs << (log2_sub + 1)) <= kThreads) {
    ++log2_sub;
  }
  const int groups = kThreads >> log2_sub;
  const int per_thread = (n_pairs + groups - 1) / groups;
  const int vec = d % kN == 0 && aligned16(a) && aligned16(b);
  const int sp = static_cast<int>(span);
#define SQDIST_LAUNCH(U)                                                    \
  launch_u<KIND, T, U>(a, b, partial, counter, out, na, nb, d, blocks, sp, \
                       log2_sub, log2_nv, stages, vec, smem_bytes, stream)
  if (per_thread <= 1) return SQDIST_LAUNCH(1);
  if (per_thread <= 2) return SQDIST_LAUNCH(2);
  if (per_thread <= 4) return SQDIST_LAUNCH(4);
  if (per_thread <= 9) return SQDIST_LAUNCH(9);
  return SQDIST_LAUNCH(16);
#undef SQDIST_LAUNCH
}

}  // namespace

// x: (m, d) row-major, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1);
// the plan: blocks, and 64-column units per block; partial: blocks *
// m(m+1)/2 float32 (null when blocks == 1); counter: one int32, 0 between
// calls (null when blocks == 1); out: (m, m) float32.
extern "C" int pairwise_sqdist_launch(const void* x, void* partial,
                                      void* counter, void* out, int m, int d,
                                      int blocks, int units_per_block,
                                      int is_bf16, void* stream) {
  if (m < 1 || m > kMaxRows || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<kGram, __nv_bfloat16>(x, x, partial, counter, out, m,
                                             m, d, blocks, units_per_block, s)
              : launch<kGram, float>(x, x, partial, counter, out, m, m, d,
                                     blocks, units_per_block, s);
  return static_cast<int>(err);
}

// x: (m, d), y: (k, d) row-major, both float32 or both bfloat16; the plan as
// above; partial: blocks * m * k float32 (null when blocks == 1); counter as
// above; out: (m, k) float32.
extern "C" int cross_sqdist_launch(const void* x, const void* y, void* partial,
                                   void* counter, void* out, int m, int k,
                                   int d, int blocks, int units_per_block,
                                   int is_bf16, void* stream) {
  if (m < 1 || m > kMaxRows || k < 1 || k > kMaxRows || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<kSqDiff, __nv_bfloat16>(x, y, partial, counter, out, m,
                                               k, d, blocks, units_per_block,
                                               s)
              : launch<kSqDiff, float>(x, y, partial, counter, out, m, k, d,
                                       blocks, units_per_block, s);
  return static_cast<int>(err);
}

extern "C" const char* sqdist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
