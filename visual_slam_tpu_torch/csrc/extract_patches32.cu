// K5: 32x32 keypoint window gather with edge replication.
//
// Replaces visual_slam_tpu/ops/pallas_patches.py::extract_patches32_pallas
// (pallas_call at pallas_patches.py:87). Per keypoint (y, x): the 32x32
// window whose origin is (y+1, x+1) in the image edge-padded by R+1 = 16,
// i.e. rows y-15 .. y+16 and columns x-15 .. x+16 with every index clamped
// into the image. The top-left 31x31 is orb.extract_patches' window; row
// and column 31 hold the next pixels.
//
// What bounds it: it is a gather. Each keypoint reads and writes one 4 KB
// window, 8 MB each way at 2000 keypoints: a few microseconds of the card's
// bandwidth, so the launch and the latency of the first loads dominate.
// What the design does about it: one block of 32x8 threads per keypoint;
// each warp moves whole window rows, so every row is one 128-byte load (two
// where it straddles a cache line) and one 128-byte store. The clamps give
// the edge padding without materialising a padded image. The TPU kernel's
// aligned (40, 256) DMA bands and rolls existed only for Mosaic's tiling
// and are gone.

#include <cstddef>

#include <cuda_runtime.h>

namespace {

constexpr int kP32 = 32;
constexpr int kRadius = 15;
constexpr int kRowsPerPass = 8;

__global__ void __launch_bounds__(kP32 * kRowsPerPass) extract_patches32_kernel(
    const float* __restrict__ img, int H, int W, const int* __restrict__ yx, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int j = threadIdx.x;  // window column, and lane
  const int y = yx[2 * k];
  const int x = yx[2 * k + 1];
  const int c = min(max(x - kRadius + j, 0), W - 1);
  float* o = out + static_cast<size_t>(k) * kP32 * kP32;
  for (int i = threadIdx.y; i < kP32; i += kRowsPerPass) {
    const int r = min(max(y - kRadius + i, 0), H - 1);
    o[i * kP32 + j] = img[static_cast<size_t>(r) * W + c];
  }
}

}  // namespace

// img: (H, W) f32; yx: (K, 2) int32 (y, x); out: (K, 32, 32) f32.
// Returns cudaGetLastError() after the launch.
extern "C" int vslam_extract_patches32(const float* img, int H, int W, const int* yx, int K, float* out,
                                       void* stream) {
  if (K > 0) {
    extract_patches32_kernel<<<K, dim3(kP32, kRowsPerPass), 0, static_cast<cudaStream_t>(stream)>>>(img, H, W, yx,
                                                                                                   out);
  }
  return static_cast<int>(cudaGetLastError());
}
