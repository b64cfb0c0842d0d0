// K3: fused projection-guided matcher -- landmark arena against keypoints.
//
// Replaces visual_slam_tpu/ops/pallas_kernels.py::guided_top2_pallas
// (pallas_call at pallas_kernels.py:292), called from
// ops/guided_matching.py::guided_match inside the fused tracking step.
// Hamming distances between M landmarks and K keypoints, gated by
// |uv - xy|^2 <= r^2 with r dynamic; per landmark the best and second
// keypoint with the ratio test (best < ratio * second) and the absolute test
// (best <= max_distance); then the inversion to one landmark per keypoint,
// the minimum of enc = best * M + landmark (distance first, then the lower
// landmark).
//
// What bounds it: the M*K gate tests, 5 fp32 operations each (41 MFLOP at
// 4096 x 2000, 0.6 us at 67 TFLOP/s); only the few pairs inside the radius
// (about 0.3 % on the main path) read 32 B descriptors and pay 2*256 bit
// operations. The bytes are small (0.27 MB in). The loop over keypoints is
// latency-bound when every step loads a keypoint from L1/L2.
// What the design does about it:
// - A block of 16 warps, one landmark per warp, stages the keypoints'
//   positions in shared memory (2048 at a time, 16 KB), with an invalid
//   keypoint's position set to NaN so that its gate test fails by itself:
//   the inner loop reads one 8-byte shared word per keypoint (conflict-free,
//   the lanes on neighbouring keypoints) and touches device memory only for
//   the descriptors of pairs inside the radius.
// - The lanes' partial top-2 merge with shuffles, ties to the lower
//   keypoint; lane 0 applies both tests and does one atomicMin per surviving
//   landmark into an INT_MAX-initialised (K,) buffer.
// - The last block to finish (a ticket counter after a fence) decodes that
//   buffer into (lm_idx, valid): two launches per call, the fill and the
//   matcher, with no host sync.
// - B sequences in the same two launches (the batched VO step): blockIdx.y
//   is the sequence. Each has its own arena, keypoints and radius (the
//   radius follows its motion model), and its own (K + 1) minima and ticket,
//   so the last block of a sequence decodes that sequence alone.
// The TPU kernel's bf16 bit matmul over a full (tile, K) distance tile and
// its 128-lane padding are gone.

#include <cuda_runtime.h>

#include "top2.cuh"

namespace {

using vslam::kBigD;
using vslam::Top2;

constexpr int kWarps = 16;    // landmarks per block
constexpr int kChunk = 2048;  // keypoint positions staged in shared memory at a time

__global__ void fill_colenc(int* __restrict__ colenc, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  colenc += static_cast<size_t>(blockIdx.y) * (K + 1);
  if (i < K) colenc[i] = INT_MAX;
  if (i == K) colenc[i] = 0;  // blocks done
}

__global__ void __launch_bounds__(32 * kWarps) guided_top2_kernel(
    const int* __restrict__ lm_desc, const unsigned char* __restrict__ lm_ok,
    const float* __restrict__ lm_uv, int M, const int* __restrict__ kp_desc,
    const unsigned char* __restrict__ kp_valid, const float* __restrict__ kp_xy, int K,
    const float* __restrict__ r2_ptr, float ratio, float max_distance, int* __restrict__ colenc,
    int* __restrict__ lm_idx, unsigned char* __restrict__ valid) {
  __shared__ float2 s_xy[kChunk];
  __shared__ bool s_last;
  const size_t b = blockIdx.y;  // the sequence
  lm_desc += b * M * vslam::kWords;
  lm_ok += b * M;
  lm_uv += b * M * 2;
  kp_desc += b * K * vslam::kWords;
  kp_valid += b * K;
  kp_xy += b * K * 2;
  colenc += b * (K + 1);
  lm_idx += b * K;
  valid += b * K;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const bool live = m < M && lm_ok[m];  // uniform across the warp

  const float r2 = r2_ptr[b];
  float u = 0.f, v = 0.f;
  uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
  if (live) {
    u = lm_uv[2 * m];
    v = lm_uv[2 * m + 1];
    a0 = reinterpret_cast<const uint4*>(lm_desc)[2 * m];
    a1 = reinterpret_cast<const uint4*>(lm_desc)[2 * m + 1];
  }
  const uint4* kp4 = reinterpret_cast<const uint4*>(kp_desc);
  const float2* xy2 = reinterpret_cast<const float2*>(kp_xy);
  const float nan = __int_as_float(0x7fc00000);

  Top2 top;
  top.init(lane < K ? lane : INT_MAX);
  for (int base = 0; base < K; base += kChunk) {
    const int n = min(kChunk, K - base);
    __syncthreads();  // the previous chunk is read
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_xy[i] = kp_valid[base + i] ? xy2[base + i] : make_float2(nan, nan);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int i = lane; i < n; i += 32) {
        const float2 p = s_xy[i];
        const float du = u - p.x;
        const float dv = v - p.y;
        int d = kBigD;
        // Separate roundings, no FMA: the same value as torch's
        // du*du + dv*dv, so a keypoint on the radius falls on the same side.
        if (__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2) {
          const int k = base + i;
          d = vslam::hamming(a0, a1, kp4[2 * k], kp4[2 * k + 1]);
        }
        top.push(d, base + i);
      }
    }
  }
  if (live) {
    for (int o = 16; o > 0; o >>= 1) {
      const int b = __shfl_down_sync(0xffffffffu, top.best, o);
      const int s = __shfl_down_sync(0xffffffffu, top.second, o);
      const int a = __shfl_down_sync(0xffffffffu, top.arg, o);
      top.merge(b, s, a);
    }
    if (lane == 0 && top.best < kBigD) {
      const float fb = static_cast<float>(top.best);
      if (fb <= max_distance && fb < __fmul_rn(ratio, vslam::as_distance(top.second))) {
        atomicMin(&colenc[top.arg], top.best * M + m);
        __threadfence();
      }
    }
  }

  // The last block to finish decodes the per-keypoint minima.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&colenc[K], 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const int enc = __ldcg(&colenc[k]);
      const bool ok = enc != INT_MAX;
      valid[k] = ok;
      lm_idx[k] = ok ? enc % M : 0;
    }
  }
}

}  // namespace

// B sequences, each: lm_desc (M, 8) int32 words; lm_ok (M,) bool (valid and
// visible); lm_uv (M, 2) f32 projected pixels; kp_desc (K, 8); kp_valid
// (K,) bool; kp_xy (K, 2) f32; all stacked on a leading B. r2: (B,) f32
// device pointer, the squared radius of each sequence. Outputs: lm_idx
// (B, K) int32, valid (B, K) bool; colenc (B, K + 1) int32 scratch. Needs
// 257*M < 2^31 and B <= 65535. Returns cudaGetLastError() after the
// launches.
extern "C" int vslam_guided_top2(const int* lm_desc, const unsigned char* lm_ok, const float* lm_uv, int M,
                                 const int* kp_desc, const unsigned char* kp_valid, const float* kp_xy, int K, int B,
                                 const float* r2, float ratio, float max_distance, int* colenc, int* lm_idx,
                                 unsigned char* valid, void* stream) {
  if (B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fill_colenc<<<dim3((K + 256) / 256, B), 256, 0, s>>>(colenc, K);
  guided_top2_kernel<<<dim3((M + kWarps - 1) / kWarps, B), 32 * kWarps, 0, s>>>(
      lm_desc, lm_ok, lm_uv, M, kp_desc, kp_valid, kp_xy, K, r2, ratio, max_distance, colenc, lm_idx, valid);
  return static_cast<int>(cudaGetLastError());
}
