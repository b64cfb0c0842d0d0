// Shared pieces of the Hamming top-2 kernels (hamming_top2.cu, guided_top2.cu).
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace vslam {

constexpr int kWords = 8;         // 256-bit descriptor = 8 words of 32 bits
constexpr int kBigD = 1 << 20;    // distance of an invalid pair (> any Hamming distance)
constexpr float kBigF = 1e9f;     // the JAX package's BIG, what kBigD reads as in float

// Running (best, second, argbest) over columns of one row, where `second` is
// the minimum over every column other than argbest. Visiting columns in
// increasing order with a strict `<` keeps the first column on ties, and a
// later column equal to best becomes second, as `min over cols != argbest`
// in ops/matching.min2 gives.
struct Top2 {
  int best;
  int second;
  int arg;

  __device__ __forceinline__ void init(int first_col) {
    best = kBigD;
    second = kBigD;
    arg = first_col;
  }

  __device__ __forceinline__ void push(int d, int col) {
    if (d < best) {
      second = best;
      best = d;
      arg = col;
    } else if (d < second) {
      second = d;
    }
  }

  // Merge a partial over a disjoint set of columns: the lower distance wins,
  // equal distances go to the lower column, and the loser's best competes
  // for second.
  __device__ __forceinline__ void merge(int b, int s, int a) {
    if (b < best || (b == best && a < arg)) {
      second = min(s, best);
      best = b;
      arg = a;
    } else {
      second = min(second, b);
    }
  }
};

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1, const uint4& b0, const uint4& b1) {
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
         __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

__device__ __forceinline__ float as_distance(int d) { return d >= kBigD ? kBigF : static_cast<float>(d); }

}  // namespace vslam
