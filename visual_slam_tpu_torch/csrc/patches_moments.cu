// K1: fused detection tail -- intensity-centroid moments and descriptor patches.
//
// Replaces visual_slam_tpu/ops/pallas_patches.py::patches_and_moments_pallas
// (pallas_call at pallas_patches.py:167). Per keypoint (y, x) on one pyramid
// level, with edge-replicated borders: the moments (m10, m01) over the
// disk-masked 31x31 window of the RAW level, and the 31x31 window of the
// BLURRED level that feeds steered BRIEF.
//
// What bounds it: it is a gather. Each keypoint reads two 31x31 windows
// (7.7 KB) and writes one (3.8 KB); about 23 MB per frame at 2000 keypoints,
// a few microseconds of the card's bandwidth, so at these sizes the launch and
// the latency of the first loads dominate.
// What the design does about it: one block of 32x32 threads per keypoint, one
// thread per window pixel, so each warp reads and writes one contiguous window
// row (coalesced) and every load is in flight at once. The disk-masked weights
// come from the integer offsets in registers (no weight array is read), and
// the two sums are reduced by warp shuffles, then across the 32 warps in
// shared memory. The TPU kernel's (8, 128)-aligned bands, rolls and 32-wide
// padding existed only for Mosaic's tiling and are gone: the window is 31x31.
// The angle atan2(m01, m10) is taken by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 31;
constexpr int kRadius = 15;

__global__ void __launch_bounds__(1024) patches_moments_kernel(
    const float* __restrict__ raw, const float* __restrict__ blur, int H, int W,
    const int* __restrict__ yx, float* __restrict__ mom, float* __restrict__ patches) {
  const int k = blockIdx.x;
  const int j = threadIdx.x;  // window column, and lane
  const int i = threadIdx.y;  // window row, and warp
  // The JAX version slices a 16-pixel edge-padded level and dynamic_slice
  // clamps the window start: the centre is effectively clamped to [-1, H] x
  // [-1, W] (only the grid's invalid padding slots ever lie there).
  const int y = min(max(yx[2 * k], -1), H);
  const int x = min(max(yx[2 * k + 1], -1), W);

  float m10 = 0.f, m01 = 0.f;
  if (i < kPatch && j < kPatch) {
    const int r = min(max(y - kRadius + i, 0), H - 1);
    const int c = min(max(x - kRadius + j, 0), W - 1);
    const size_t src = static_cast<size_t>(r) * W + c;
    const int dy = i - kRadius, dx = j - kRadius;
    if (dy * dy + dx * dx <= kRadius * kRadius) {
      const float p = raw[src];
      m10 = static_cast<float>(dx) * p;
      m01 = static_cast<float>(dy) * p;
    }
    patches[(static_cast<size_t>(k) * kPatch + i) * kPatch + j] = blur[src];
  }

  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, o);
    m01 += __shfl_down_sync(0xffffffffu, m01, o);
  }
  __shared__ float s10[32], s01[32];
  if (j == 0) {
    s10[i] = m10;
    s01[i] = m01;
  }
  __syncthreads();
  if (i == 0) {
    m10 = s10[j];
    m01 = s01[j];
    for (int o = 16; o > 0; o >>= 1) {
      m10 += __shfl_down_sync(0xffffffffu, m10, o);
      m01 += __shfl_down_sync(0xffffffffu, m01, o);
    }
    if (j == 0) {
      mom[2 * k] = m10;
      mom[2 * k + 1] = m01;
    }
  }
}

}  // namespace

// raw, blur: (H, W) f32; yx: (K, 2) int32 (y, x); mom: (K, 2) f32 out;
// patches: (K, 31, 31) f32 out. Returns cudaGetLastError() after the launch.
extern "C" int vslam_patches_moments(const float* raw, const float* blur, int H, int W, const int* yx,
                                     int K, float* mom, float* patches, void* stream) {
  if (K > 0) {
    patches_moments_kernel<<<K, dim3(32, 32), 0, static_cast<cudaStream_t>(stream)>>>(
        raw, blur, H, W, yx, mom, patches);
  }
  return static_cast<int>(cudaGetLastError());
}
