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
// What bounds it: M*K gate tests (8M at 4096 x 2000), each reading a
// keypoint's position (8 B) and validity (1 B); only pairs inside the radius
// read the 32 B descriptors and pay for the popcounts. About 74 MB of reads,
// nearly all served by L1/L2 since every warp walks the same keypoint arrays.
// What the design does about it: one warp per landmark; the lanes stride over
// the keypoints, so each load instruction is coalesced across the warp. The
// gate is tested before the descriptor is touched. The lanes' partial top-2
// merge with shuffles, ties to the lower keypoint, and lane 0 applies both
// tests and does one atomicMin per surviving landmark into an
// INT_MAX-initialised (K,) buffer. The TPU kernel's bf16 bit matmul over a
// full (tile, K) distance tile and its 128-lane padding are gone.

#include <cuda_runtime.h>

#include "top2.cuh"

namespace {

using vslam::kBigD;
using vslam::Top2;

constexpr int kWarps = 8;  // landmarks per block

__global__ void __launch_bounds__(32 * kWarps) guided_top2_kernel(
    const int* __restrict__ lm_desc, const unsigned char* __restrict__ lm_ok,
    const float* __restrict__ lm_uv, int M, const int* __restrict__ kp_desc,
    const unsigned char* __restrict__ kp_valid, const float* __restrict__ kp_xy, int K,
    const float* __restrict__ r2_ptr, float ratio, float max_distance, int* __restrict__ colenc) {
  const int lane = threadIdx.x;
  const int m = blockIdx.x * kWarps + threadIdx.y;
  if (m >= M || !lm_ok[m]) return;  // uniform across the warp

  const float r2 = *r2_ptr;
  const float u = lm_uv[2 * m], v = lm_uv[2 * m + 1];
  const uint4* lm4 = reinterpret_cast<const uint4*>(lm_desc);
  const uint4 a0 = lm4[2 * m], a1 = lm4[2 * m + 1];
  const uint4* kp4 = reinterpret_cast<const uint4*>(kp_desc);

  Top2 top;
  top.init(lane < K ? lane : INT_MAX);
  for (int k = lane; k < K; k += 32) {
    int d = kBigD;
    if (kp_valid[k]) {
      const float du = u - kp_xy[2 * k];
      const float dv = v - kp_xy[2 * k + 1];
      // Separate roundings, no FMA: the same value as torch's
      // du*du + dv*dv, so a keypoint on the radius falls on the same side.
      if (__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2) {
        d = vslam::hamming(a0, a1, kp4[2 * k], kp4[2 * k + 1]);
      }
    }
    top.push(d, k);
  }
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
    }
  }
}

__global__ void decode_lm(const int* __restrict__ colenc, int K, int M, int* __restrict__ lm_idx,
                          unsigned char* __restrict__ valid) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < K) {
    const bool ok = colenc[k] != INT_MAX;
    valid[k] = ok;
    lm_idx[k] = ok ? colenc[k] % M : 0;
  }
}

}  // namespace

// lm_desc: (M, 8) int32 words; lm_ok: (M,) bool (valid and visible);
// lm_uv: (M, 2) f32 projected pixels; kp_desc: (K, 8); kp_valid: (K,) bool;
// kp_xy: (K, 2) f32; r2: device pointer to the squared radius (f32).
// Outputs: lm_idx (K,) int32, valid (K,) bool; colenc (K,) int32 scratch.
// Needs 257*M < 2^31. Returns cudaGetLastError() after the launches.
extern "C" int vslam_guided_top2(const int* lm_desc, const unsigned char* lm_ok, const float* lm_uv, int M,
                                 const int* kp_desc, const unsigned char* kp_valid, const float* kp_xy, int K,
                                 const float* r2, float ratio, float max_distance, int* colenc, int* lm_idx,
                                 unsigned char* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vslam::fill_int<<<(K + 255) / 256, 256, 0, s>>>(colenc, K, INT_MAX);
  guided_top2_kernel<<<(M + kWarps - 1) / kWarps, dim3(32, kWarps), 0, s>>>(
      lm_desc, lm_ok, lm_uv, M, kp_desc, kp_valid, kp_xy, K, r2, ratio, max_distance, colenc);
  decode_lm<<<(K + 255) / 256, 256, 0, s>>>(colenc, K, M, lm_idx, valid);
  return static_cast<int>(cudaGetLastError());
}
