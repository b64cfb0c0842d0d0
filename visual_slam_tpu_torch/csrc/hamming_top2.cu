// K2 and K4: fused Hamming matcher -- per-query best/second/argbest and
// per-train argmin, for one query block against C candidate train blocks.
//
// Replaces visual_slam_tpu/ops/pallas_kernels.py::hamming_top2_batched
// (pallas_call at pallas_kernels.py:126). With C = 1 it is K2, reached
// through hamming_top2 from ops/matching.py::match_descriptors (tracking);
// with C > 1 it is K4, reached through match_descriptors_batched from loop
// closing's detect (C = 64 there: 8 shortlisted keyframes and 56 all-invalid
// padding blocks). Paired, candidate c brings its own query block c: that is
// K2 of the batched VO step, C = B sequences each matched against its own
// reference, through hamming_top2_paired. For K1 query x K2 train 256-bit
// descriptors with validity
// masks, per candidate: per query row the best and second distance and the
// argbest (lowest column on ties; a later equal column becomes second); per
// train column the query row of its minimum (lowest row on ties), for the
// cross-check. Invalid pairs read as BIG = 1e9; an all-invalid row gives
// best = second = BIG and argbest 0, an all-invalid column col_argmin 0, as
// argmin over all-BIG does.
//
// What bounds it: the bit product. As int8 work it is 2*K1*K2*256
// operations per candidate with a valid column, 2.05 G at 2000 x 2000:
// 1.04 us on the int8 tensor cores (1,979 TOP/s); the inputs are 66 KB per
// candidate and the outputs 24 KB, 0.03 us of HBM. The top-2 bookkeeping
// (K1*K2 compares) runs on the CUDA cores beside it.
// What the design does about it:
// - Distances on the tensor cores, exact in integers: a block unpacks its
//   64 query and 64 train descriptors into 0/1 int8 rows in shared memory
//   (the input stays the packed (K, 8) words), and each of its 4 warps takes
//   dot = popc(a & b) over a 32 x 32 sub-tile with
//   mma.sync.m16n8k32.s32.s8.s8.s32 (s32 accumulation, exact);
//   d = popc(a) + popc(b) - 2 dot, each popcount taken once at load.
// - A grid over (query tiles, train tiles, candidates) of 64 x 64 tiles:
//   1024 blocks at 2000 x 2000 with C = 1, on 132 SMs.
// - Each tile's epilogue reduces in registers and quad shuffles, then in
//   shared memory: per row the top-2 over the tile's 64 columns, per column
//   the minimum of d*K1 + row over its 64 rows. The block writes them to a
//   (C, train tiles, K1) and a (C, query tiles, K2) scratch; a finishing
//   kernel, up to a warp per row and per column, merges them across its
//   lanes (Top2::merge: ties keep the lower column, in any order) and
//   decodes the column argmin. Two launches, no host sync.
// - Paired or not, one launch pair serves all C candidates: the query
//   pointers step by K1 rows per candidate when paired and by 0 otherwise,
//   and the partials, the active flags and the outputs already carry the
//   candidate axis.
// - A tile whose query rows or train columns are all invalid computes
//   nothing: it marks itself inactive and the finisher leaves it out, which
//   yields BIG/BIG/0 and column argmin 0 where nothing else is valid. A
//   padding candidate (no valid column) costs its blocks a mask read each.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "top2.cuh"

namespace {

using vslam::kBigD;
using vslam::Top2;

constexpr int kTile = 64;                   // query rows and train columns of a block
constexpr int kThreads = 128;               // 4 warps, 2 x 2 over the tile, 32 x 32 each
constexpr int kRowWords = (256 + 16) / 4;   // one unpacked descriptor, padded: conflict-free fragment loads
constexpr int kPackBig = 257;               // kBigD in a packed row partial

// A row partial in 64 bits: best and second (9 bits each, kBigD as 257)
// above the argbest column in the low 32, so any train block the grid
// takes fits (a 32-bit packing held the column to 13 bits, K2 < 8192).
__device__ __forceinline__ long long pack_row(const Top2& t) {
  return (static_cast<long long>(min(t.best, kPackBig)) << 41) |
         (static_cast<long long>(min(t.second, kPackBig)) << 32) | static_cast<unsigned>(t.arg);
}

__device__ __forceinline__ int unpack_d(int v) { return v == kPackBig ? kBigD : v; }

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads) hamming_tile_kernel(
    const int* __restrict__ q, const unsigned char* __restrict__ qv, int K1,
    const int* __restrict__ t, const unsigned char* __restrict__ tv, int K2, int paired,
    long long* __restrict__ rowpart, int* __restrict__ colpart, unsigned char* __restrict__ active) {
  __shared__ __align__(16) uint32_t s_bits[2][kTile * kRowWords];  // query, train: byte b of a row = bit b
  __shared__ int s_pop[2][kTile];                                   // popcount, -1 where invalid
  __shared__ int s_rb[2][kTile], s_rs[2][kTile], s_ra[2][kTile];    // row partials of the two column halves
  __shared__ int s_col[2][kTile];                                   // column partials of the two row halves
  __shared__ bool s_ok[2][kTile];                                   // validity of the tile's rows and columns

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kTile, c0 = blockIdx.y * kTile;
  const size_t cand = blockIdx.z;
  t += cand * K2 * vslam::kWords;
  tv += cand * K2;
  if (paired) {
    q += cand * K1 * vslam::kWords;
    qv += cand * K1;
  }

  // Threads 0-63 read the tile's query validity, 64-127 its train validity.
  const bool side_t = tid >= kTile;
  const int idx = side_t ? c0 + tid - kTile : r0 + tid;
  const bool ok = side_t ? (idx < K2 && tv[idx]) : (idx < K1 && qv[idx]);
  s_ok[side_t][tid & (kTile - 1)] = ok;  // read after the barriers below
  const bool any_q = __syncthreads_or(!side_t && ok);
  const bool any_t = __syncthreads_or(side_t && ok);
  const bool act = any_q && any_t;
  if (tid == 0) active[(cand * gridDim.x + blockIdx.x) * gridDim.y + blockIdx.y] = act;
  if (!act) return;  // uniform across the block

  // Unpack: word w of descriptor d becomes 32 bytes, four bits per 32-bit
  // store; the 8 words of a descriptor are 8 neighbouring lanes, which sum
  // its popcount by shuffles.
#pragma unroll
  for (int n = tid; n < 2 * kTile * vslam::kWords; n += kThreads) {
    const int side = n / (kTile * vslam::kWords);
    const int d = (n / vslam::kWords) % kTile;
    const int w = n % vslam::kWords;
    const int row = (side ? c0 : r0) + d;
    const int lim = side ? K2 : K1;
    const int* src = side ? t : q;
    const uint32_t word = row < lim ? static_cast<uint32_t>(src[static_cast<size_t>(row) * vslam::kWords + w]) : 0u;
    uint32_t* dst = s_bits[side] + d * kRowWords + w * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = ((word >> (4 * j)) & 0xFu) * 0x00204081u & 0x01010101u;
    int pop = __popc(word);
    pop += __shfl_xor_sync(0xffffffffu, pop, 1);
    pop += __shfl_xor_sync(0xffffffffu, pop, 2);
    pop += __shfl_xor_sync(0xffffffffu, pop, 4);
    if (w == 0) s_pop[side][d] = s_ok[side][d] ? pop : -1;
  }
  __syncthreads();

  // dot = a . b over the warp's 32 x 32 sub-tile: 2 x 4 fragments of
  // m16n8k32, 8 steps over the 256 bits.
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, tq = lane & 3;
  int acc[2][4][4] = {};
  const uint32_t* A = s_bits[0] + (wm * 32 + g) * kRowWords + tq;
  const uint32_t* B = s_bits[1] + (wn * 32 + g) * kRowWords + tq;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t* p = A + mi * 16 * kRowWords + ks * 8;
      a[mi][0] = p[0];
      a[mi][1] = p[8 * kRowWords];
      a[mi][2] = p[4];
      a[mi][3] = p[8 * kRowWords + 4];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t* p = B + ni * 8 * kRowWords + ks * 8;
      b[ni][0] = p[0];
      b[ni][1] = p[4];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }

  // Epilogue. Lane (g, tq) holds rows wm*32 + mi*16 + g + 8h and columns
  // wn*32 + ni*8 + 2tq + e of the accumulator as acc[mi][ni][2h + e].
  int colmin[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) colmin[ni][0] = colmin[ni][1] = INT_MAX;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 32 + mi * 16 + g + 8 * h;
      const int pa = s_pop[0][rl];
      Top2 top;
      top.init(c0 + wn * 32 + 2 * tq);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = wn * 32 + ni * 8 + 2 * tq + e;
          const int pb = s_pop[1][cl];
          const int d = (pa >= 0 && pb >= 0) ? pa + pb - 2 * acc[mi][ni][2 * h + e] : kBigD;
          top.push(d, c0 + cl);  // columns in increasing order
          if (d < kBigD) colmin[ni][e] = min(colmin[ni][e], d * K1 + r0 + rl);
        }
      }
      // The quad's four lanes hold disjoint columns of the same row.
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const int b = __shfl_xor_sync(0xffffffffu, top.best, o);
        const int s = __shfl_xor_sync(0xffffffffu, top.second, o);
        const int a = __shfl_xor_sync(0xffffffffu, top.arg, o);
        top.merge(b, s, a);
      }
      if (tq == 0) {
        s_rb[wn][rl] = top.best;
        s_rs[wn][rl] = top.second;
        s_ra[wn][rl] = top.arg;
      }
    }
  }
  // The eight lanes of a column (g = 0..7) hold its 32 rows of this warp.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int v = colmin[ni][e];
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = min(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (g == 0) s_col[wm][wn * 32 + ni * 8 + 2 * tq + e] = v;
    }
  }
  __syncthreads();

  if (!side_t) {
    const int r = r0 + tid;
    if (r < K1) {
      Top2 top{s_rb[0][tid], s_rs[0][tid], s_ra[0][tid]};
      top.merge(s_rb[1][tid], s_rs[1][tid], s_ra[1][tid]);
      rowpart[(cand * gridDim.y + blockIdx.y) * K1 + r] = pack_row(top);
    }
  } else {
    const int c = c0 + tid - kTile;
    if (c < K2) colpart[(cand * gridDim.x + blockIdx.x) * K2 + c] = min(s_col[0][tid - kTile], s_col[1][tid - kTile]);
  }
}

// Merge the active tiles' partials and decode: a group of L lanes (a power
// of two up to 32, inside one warp) takes query row x and train column x of
// candidate blockIdx.y, its lanes over the tiles, then shuffles. Top2::merge
// of disjoint column sets is exact in any order (the lower distance wins,
// then the lower column), so this equals the merge in tile order. Each lane
// starts from (BIG, BIG, column 0), which yields BIG/BIG/0 for a row with no
// valid pair, as argmin over all-BIG does.
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kFinishThreads) hamming_finish_kernel(
    const long long* __restrict__ rowpart, const int* __restrict__ colpart, const unsigned char* __restrict__ active,
    int K1, int K2, int n_rt, int n_ct, int L, float* __restrict__ best, float* __restrict__ second,
    int* __restrict__ arg, int* __restrict__ colarg) {
  const int sub = threadIdx.x & (L - 1);
  const int x = (blockIdx.x * kFinishThreads + threadIdx.x) / L;
  const size_t cand = blockIdx.y;
  const unsigned char* act = active + cand * n_rt * n_ct;
  // Every lane of a warp reaches the shuffles: x past K1 or K2 merges nothing.
  Top2 top;
  top.init(0);
  if (x < K1) {
    const unsigned char* ai = act + (x / kTile) * n_ct;
    for (int j = sub; j < n_ct; j += L) {
      if (ai[j]) {
        const long long p = rowpart[(cand * n_ct + j) * K1 + x];
        top.merge(unpack_d(static_cast<int>(p >> 41)), unpack_d(static_cast<int>((p >> 32) & 511)),
                  static_cast<int>(p & 0xffffffffLL));
      }
    }
  }
  int m = INT_MAX;
  if (x < K2) {
    const unsigned char* aj = act + x / kTile;
    for (int i = sub; i < n_rt; i += L) {
      if (aj[i * n_ct]) m = min(m, colpart[(cand * n_rt + i) * K2 + x]);
    }
  }
  for (int o = L / 2; o > 0; o >>= 1) {
    const int b = __shfl_xor_sync(0xffffffffu, top.best, o);
    const int s = __shfl_xor_sync(0xffffffffu, top.second, o);
    const int a = __shfl_xor_sync(0xffffffffu, top.arg, o);
    top.merge(b, s, a);
    m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (sub == 0 && x < K1) {
    best[cand * K1 + x] = vslam::as_distance(top.best);
    // With one train column there is no second: +inf, as min2's masked re-min.
    second[cand * K1 + x] = K2 > 1 ? vslam::as_distance(top.second) : __int_as_float(0x7f800000);
    arg[cand * K1 + x] = top.arg;
  }
  if (sub == 0 && x < K2) colarg[cand * K2 + x] = m == INT_MAX ? 0 : m % K1;
}

}  // namespace

// q: (K1, 8) int32 words, qv: (K1,) bool, or (C, K1, 8) and (C, K1) when
// paired is nonzero; t: (C, K2, 8), tv: (C, K2) bool.
// Outputs: best, second (C, K1) f32; arg (C, K1) int32; colarg (C, K2) int32.
// Scratch: rowpart (C, ceil(K2/64), K1) int64, colpart (C, ceil(K1/64), K2)
// int32, active (C, ceil(K1/64), ceil(K2/64)) uint8. Needs K1*257 < 2^31
// (the column minimum's d*K1 + row), ceil(K2/64) <= 65535 (the grid's y:
// K2 up to 4,194,240 rows), C <= 65535 and C*K2 < 2^31. Returns
// cudaGetLastError() after the launches.
extern "C" int vslam_hamming_top2(const int* q, const unsigned char* qv, int K1, const int* t,
                                  const unsigned char* tv, int K2, int C, int paired, float* best, float* second,
                                  int* arg, int* colarg, long long* rowpart, int* colpart, unsigned char* active,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rt = (K1 + kTile - 1) / kTile, n_ct = (K2 + kTile - 1) / kTile;
  hamming_tile_kernel<<<dim3(n_rt, n_ct, C), kThreads, 0, s>>>(q, qv, K1, t, tv, K2, paired, rowpart, colpart,
                                                                active);
  // Lanes per row and column: as many as keep about 64K threads busy (all
  // 32 at C = 1, 2000 x 2000), one when the candidates alone fill the card.
  const int n = K1 > K2 ? K1 : K2;
  int L = 32;
  while (L > 1 && static_cast<long long>(C) * n * L > 65536) L >>= 1;
  const long long threads = static_cast<long long>(n) * L;
  hamming_finish_kernel<<<dim3(static_cast<unsigned>((threads + kFinishThreads - 1) / kFinishThreads), C),
                          kFinishThreads, 0, s>>>(rowpart, colpart, active, K1, K2, n_rt, n_ct, L, best, second, arg,
                                                  colarg);
  return static_cast<int>(cudaGetLastError());
}
