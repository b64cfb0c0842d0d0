// K2: fused Hamming matcher -- per-query best/second/argbest and per-train argmin.
//
// Replaces visual_slam_tpu/ops/pallas_kernels.py::hamming_top2_batched with one
// candidate (pallas_call at pallas_kernels.py:126), reached through
// hamming_top2 and match_nn_pallas from ops/matching.py::match_descriptors.
// For K1 query x K2 train 256-bit descriptors with validity masks: per query
// row the best and second distance and the argbest (lowest column on ties);
// per train column the query row of its minimum (lowest row on ties), for the
// cross-check. Invalid pairs read as BIG = 1e9.
//
// What bounds it: integer work, K1*K2*8 XOR + popcount pairs (32M at
// 2000 x 2000), plus the top-2 bookkeeping per pair; the inputs are 128 KB and
// the outputs 32 KB, so memory traffic is negligible.
// What the design does about it: distances are exact in integers (XOR +
// __popc on the 8 packed words), instead of the TPU's bf16 bit matmul. A block
// holds 32 query rows, one per lane, and SPLIT warps that each scan a
// contiguous slice of the train columns, so the card sees K1/32 * SPLIT warps
// rather than K1/32. The whole train block sits in shared memory (32 B a
// column, 64 KB at K2 = 2000) and every lane of a warp reads the same column,
// a broadcast. The warps' partial top-2 merge in column order in shared
// memory. The column argmin reduces (d*K1 + row) over the warp's 32 rows with
// one __reduce_min_sync, keeps it per block in shared memory, and leaves the
// block with one atomicMin per column into an INT_MAX-initialised buffer; a
// column with no valid entry decodes to row 0, as argmin over all-BIG does.

#include <cuda_runtime.h>

#include "top2.cuh"

namespace {

using vslam::kBigD;
using vslam::Top2;

constexpr int kSplit = 8;  // warps per block, each over K2/kSplit train columns

__global__ void __launch_bounds__(32 * kSplit) hamming_top2_kernel(
    const int* __restrict__ q, const unsigned char* __restrict__ qv, int K1,
    const int* __restrict__ t, const unsigned char* __restrict__ tv, int K2,
    float* __restrict__ best_out, float* __restrict__ second_out, int* __restrict__ arg_out,
    int* __restrict__ colenc) {
  extern __shared__ uint4 smem[];
  uint4* s_desc = smem;                                          // (K2, 2) uint4
  int* s_enc = reinterpret_cast<int*>(s_desc + 2 * K2);          // (K2,)
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_enc + K2);  // (K2,)
  __shared__ int p_best[kSplit][32], p_second[kSplit][32], p_arg[kSplit][32];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int nthreads = 32 * kSplit;
  const uint4* t4 = reinterpret_cast<const uint4*>(t);
  for (int n = tid; n < 2 * K2; n += nthreads) s_desc[n] = t4[n];
  for (int c = tid; c < K2; c += nthreads) {
    s_valid[c] = tv[c];
    s_enc[c] = INT_MAX;
  }
  __syncthreads();

  const int row = blockIdx.x * 32 + lane;
  const bool row_ok = row < K1 && qv[row];
  uint4 q0 = make_uint4(0, 0, 0, 0), q1 = q0;
  if (row < K1) {
    q0 = reinterpret_cast<const uint4*>(q)[2 * row];
    q1 = reinterpret_cast<const uint4*>(q)[2 * row + 1];
  }

  const int chunk = (K2 + kSplit - 1) / kSplit;
  const int c0 = min(warp * chunk, K2);
  const int c1 = min(c0 + chunk, K2);
  Top2 top;
  top.init(c0);
  for (int c = c0; c < c1; ++c) {
    int d = kBigD;
    if (row_ok && s_valid[c]) d = vslam::hamming(q0, q1, s_desc[2 * c], s_desc[2 * c + 1]);
    top.push(d, c);
    // Only this warp scans column c in this block: a plain store suffices.
    const int wmin = __reduce_min_sync(0xffffffffu, d < kBigD ? d * K1 + row : INT_MAX);
    if (lane == 0) s_enc[c] = wmin;
  }
  p_best[warp][lane] = top.best;
  p_second[warp][lane] = top.second;
  p_arg[warp][lane] = top.arg;
  __syncthreads();

  if (warp == 0) {
    for (int w = 1; w < kSplit; ++w) top.merge(p_best[w][lane], p_second[w][lane], p_arg[w][lane]);
    if (row < K1) {
      best_out[row] = vslam::as_distance(top.best);
      second_out[row] = vslam::as_distance(top.second);
      arg_out[row] = top.arg;
    }
  }
  for (int c = tid; c < K2; c += nthreads) {
    if (s_enc[c] != INT_MAX) atomicMin(&colenc[c], s_enc[c]);
  }
}

__global__ void decode_colarg(const int* __restrict__ colenc, int K2, int K1, int* __restrict__ colarg) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < K2) colarg[c] = colenc[c] == INT_MAX ? 0 : colenc[c] % K1;
}

}  // namespace

// q: (K1, 8) int32 words, qv: (K1,) bool; t: (K2, 8), tv: (K2,) bool.
// Outputs: best, second (K1,) f32; arg (K1,) int32; colarg (K2,) int32.
// colenc: (K2,) int32 scratch. Needs K1*257 < 2^31 and 37*K2 bytes of shared
// memory (K2 <= 6000). Returns cudaGetLastError() after the launches.
extern "C" int vslam_hamming_top2(const int* q, const unsigned char* qv, int K1, const int* t,
                                  const unsigned char* tv, int K2, float* best, float* second, int* arg,
                                  int* colenc, int* colarg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(K2) * (2 * sizeof(uint4) + sizeof(int) + 1);
  cudaError_t err = cudaFuncSetAttribute(hamming_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vslam::fill_int<<<(K2 + 255) / 256, 256, 0, s>>>(colenc, K2, INT_MAX);
  hamming_top2_kernel<<<(K1 + 31) / 32, dim3(32, kSplit), smem, s>>>(q, qv, K1, t, tv, K2, best, second, arg,
                                                                      colenc);
  decode_colarg<<<(K2 + 255) / 256, 256, 0, s>>>(colenc, K2, K1, colarg);
  return static_cast<int>(cudaGetLastError());
}
