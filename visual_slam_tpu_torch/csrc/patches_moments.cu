// K1: fused detection tail -- intensity-centroid moments and descriptor patches.
//
// Replaces visual_slam_tpu/ops/pallas_patches.py::patches_and_moments_pallas
// (pallas_call at pallas_patches.py:167). Per keypoint (y, x) on its pyramid
// level, with edge-replicated borders: the moments (m10, m01) over the
// disk-masked 31x31 window of the RAW level, and the 31x31 window of the
// BLURRED level that feeds steered BRIEF. One launch covers every level of a
// frame, or of B frames at once (the batched VO step); the outputs are the
// levels' keypoints in level-major order, per frame.
//
// What bounds it: device-memory bytes. Per keypoint it reads two 31x31
// windows and writes one: at 2000 keypoints over 4 levels about 12.5 MB, of
// which the 7.7 MB of f32 patches written dominate (3.7 us at 3.35 TB/s); the
// moments' 2 x 961 multiply-adds per keypoint are far below the fp32 peak.
// At these sizes the launch and the latency of the first loads dominate.
// What the design does about it:
// - One launch per frame: the level table (pointers, sizes, first keypoint)
//   is a kernel parameter, so no level is copied or packed and the host
//   adds no copy and no sync.
// - One launch per batch of B frames: blockIdx.y is the frame. Each level
//   holds the B frames' copies stacked, (B, H_l, W_l) pixels and (B, K_l, 2)
//   keypoints, and a block adds frame b's offsets to its level's pointers.
//   The table keeps n_levels entries whatever B is, so the level search
//   below stays a 16-entry unrolled scan in the parameter bank; a table of
//   B * n_levels entries would pass the 16-entry cap at B = 5 with 4 levels.
// - A warp per keypoint, kWarps keypoints per block (30.8 KB of static
//   shared memory, seven blocks an SM: 2000 keypoints are one wave). The
//   warp stages its raw and blurred windows in shared memory with 4-byte
//   cp.async at the clamped addresses (lane j takes column j of every row),
//   so all 62 loads of a lane are in flight before the one wait. TMA does
//   not fit: its out-of-bounds fill is zero, not an edge replica.
// - The moments: lane j sums column j of the raw window from shared memory,
//   with the disk-masked weights derived from the integer offsets (no weight
//   array is read), then the warp reduces by shuffles. No __syncthreads.
// - The windows sit in shared memory in the patch's own 961-float layout,
//   so the patch goes out as 961 contiguous floats in 31 coalesced passes of
//   all 32 lanes, and both the copies in and the reads out are free of bank
//   conflicts.
// The TPU kernel's (8, 128)-aligned bands, rolls and 32-wide padding existed
// only for Mosaic's tiling and are gone. The angle atan2(m01, m10) is taken
// by the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 31;
constexpr int kRadius = 15;
constexpr int kArea = kPatch * kPatch;
constexpr int kWarps = 4;  // keypoints per block
constexpr int kMaxLevels = 16;

struct Level {
  const float* raw;   // (B, H, W)
  const float* blur;  // (B, H, W)
  const int* yx;      // (B, K_l, 2) int32 (y, x)
  int H, W;
  int K;   // K_l, the level's keypoints per frame
  int k0;  // the level's first keypoint in a frame's outputs
};

struct LevelTable {
  Level l[kMaxLevels];
  int n;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__global__ void __launch_bounds__(32 * kWarps) patches_moments_kernel(const LevelTable tab, int K,
                                                                       float* __restrict__ mom,
                                                                       float* __restrict__ patches) {
  __shared__ float s_raw[kWarps][kArea];
  __shared__ float s_blur[kWarps][kArea];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;  // the whole warp; no block-wide barrier follows
  const size_t b = blockIdx.y;  // the frame

  // The keypoint's level: the last one that starts at or before k (a level
  // with no keypoints starts where the next one does). Constant indices
  // only, so the table stays in the parameter bank.
  Level L = tab.l[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < tab.n && k >= tab.l[i].k0) L = tab.l[i];
  }
  const int* yx = L.yx + 2 * (b * L.K + (k - L.k0));
  const float* raw = L.raw + b * L.H * L.W;
  const float* blur = L.blur + b * L.H * L.W;
  // The JAX version slices a 16-pixel edge-padded level and dynamic_slice
  // clamps the window start: the centre is effectively clamped to [-1, H] x
  // [-1, W] (only the grid's invalid padding slots ever lie there).
  const int y = min(max(yx[0], -1), L.H);
  const int x = min(max(yx[1], -1), L.W);

  float* sr = s_raw[warp];
  float* sb = s_blur[warp];
  if (lane < kPatch) {
    const int c = min(max(x - kRadius + lane, 0), L.W - 1);
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
      const int r = min(max(y - kRadius + i, 0), L.H - 1);
      const size_t src = static_cast<size_t>(r) * L.W + c;
      cp_async4(sr + i * kPatch + lane, raw + src);
      cp_async4(sb + i * kPatch + lane, blur + src);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Lane j's column of the raw window: its own copies, visible after the wait.
  float m10 = 0.f, m01 = 0.f;
  if (lane < kPatch) {
    const int dx = lane - kRadius;
#pragma unroll
    for (int i = 0; i < kPatch; ++i) {
      const int dy = i - kRadius;
      if (dy * dy + dx * dx <= kRadius * kRadius) {
        const float p = sr[i * kPatch + lane];
        m10 += static_cast<float>(dx) * p;
        m01 += static_cast<float>(dy) * p;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, o);
    m01 += __shfl_xor_sync(0xffffffffu, m01, o);
  }
  const size_t kb = b * K + k;  // the keypoint's row of the outputs
  if (lane == 0) {
    mom[2 * kb] = m10;
    mom[2 * kb + 1] = m01;
  }

  __syncwarp();  // every lane's blurred copies are in shared memory
  float* out = patches + kb * kArea;
#pragma unroll
  for (int idx = lane; idx < kArea; idx += 32) out[idx] = sb[idx];
}

}  // namespace

// B frames of n_levels levels; per level l: raw[l], blur[l] (B, H[l], W[l])
// f32 device pointers and yx[l] a (B, K[l], 2) int32 device pointer. The
// arrays themselves are host memory, read here into the kernel's parameter.
// mom: (B, sum K, 2) f32 out; patches: (B, sum K, 31, 31) f32 out,
// level-major within each frame. Needs n_levels <= 16 and B <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int vslam_patches_moments(int n_levels, int B, const float* const* raw, const float* const* blur,
                                     const int* const* yx, const int* H, const int* W, const int* K, float* mom,
                                     float* patches, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab{};
  int total = 0;
  for (int l = 0; l < n_levels; ++l) {
    tab.l[l] = Level{raw[l], blur[l], yx[l], H[l], W[l], K[l], total};
    total += K[l];
  }
  tab.n = n_levels;
  if (total > 0) {
    patches_moments_kernel<<<dim3((total + kWarps - 1) / kWarps, B), 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(tab, total, mom, patches);
  }
  return static_cast<int>(cudaGetLastError());
}
