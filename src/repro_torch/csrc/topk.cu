// Tie-stable top-k selection for ORDER BY ... LIMIT: the row indices of the
// k smallest float32 keys, in ascending (key, row) order — exactly the first
// k entries of a stable ascending sort.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk.py::topk_select.
//
// Keys: each float32 key maps to an order-preserving uint32 (sign bit set on
// non-negative values, all bits flipped on negative ones), after -0.0 is
// made +0.0 (the TPU kernel's == treats them as equal).  The uint32 goes in
// the high half of a uint64 and the row index in the low half, so the k
// smallest packed values are the tie-stable answer: equal keys order by row.
// NaN keys sort after +inf (positive NaN) or before -inf (negative NaN);
// the engine never passes them (its keys are integer composites).
//
// Design: one block of 512 threads per 1024-key tile loads the tile into
// shared memory (8 KB; rows past the end become UINT64_MAX, which no real
// key packs to, so padding never wins), bitonic-sorts it, and writes its
// first k packed values.  The same kernel then runs over the blocks*k
// candidates, which carry their original rows, until one tile is left, whose
// first k give the int32 indices.  k <= 128 shrinks the candidates at least
// 8x a round; at the engine's main-path sizes (n <= 1024) it is one launch.
// The TPU kernel's k rounds of a tile-wide argmin are not carried over: a
// sort network does the tile in log2(1024)*(log2(1024)+1)/2 = 55 steps
// whatever k is.
//
// Bound on H100: bytes (n*4 read, k*4 written), but at the engine's sizes
// (a few hundred keys) the launch latency dominates.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kTileThreads = kTile / 2;  // one compare-exchange per thread per step

__device__ __forceinline__ uint64_t pack_key(float x, int64_t row) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) == 0) u = 0;  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(row);
}

// One round: sort each 1024-entry tile of the input and keep its first k.
// Round 1 reads float keys (keys != nullptr); later rounds read packed
// candidates.  The last round (idx_out != nullptr) writes row indices.
__global__ void __launch_bounds__(kTileThreads)
topk_tile_kernel(const float* __restrict__ keys, const uint64_t* __restrict__ cand,
                 int64_t m, int k, uint64_t* __restrict__ cand_out,
                 int32_t* __restrict__ idx_out) {
  __shared__ uint64_t s[kTile];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = t; j < kTile; j += kTileThreads) {
    const int64_t i = base + j;
    uint64_t v = UINT64_MAX;
    if (i < m) v = keys != nullptr ? pack_key(keys[i], i) : cand[i];
    s[j] = v;
  }
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      const int i = 2 * t - (t & (stride - 1));  // low element of the pair
      const int j = i + stride;
      const bool ascending = (i & size) == 0;
      const uint64_t a = s[i], b = s[j];
      if ((a > b) == ascending) {
        s[i] = b;
        s[j] = a;
      }
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += kTileThreads) {
    if (idx_out != nullptr) {
      idx_out[j] = static_cast<int32_t>(s[j] & 0xffffffffu);
    } else {
      cand_out[static_cast<int64_t>(blockIdx.x) * k + j] = s[j];
    }
  }
}

}  // namespace

// scratch holds ceil(n/1024)*k uint64 for the odd rounds' candidates, then
// the even rounds' (sized by kernels/topk.py::scratch_len); unused when
// n <= 1024.
extern "C" cudaError_t repro_topk_select(const float* keys, int64_t n, int k,
                                         uint64_t* scratch, int32_t* idx_out,
                                         cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  const int64_t first_len = (n + kTile - 1) / kTile * k;
  uint64_t* bufs[2] = {scratch, scratch + first_len};
  const uint64_t* src = nullptr;
  int64_t m = n;
  for (int round = 0;; ++round) {
    const int64_t blocks = (m + kTile - 1) / kTile;
    const bool last = blocks == 1;
    uint64_t* dst = last ? nullptr : bufs[round & 1];
    topk_tile_kernel<<<static_cast<unsigned>(blocks), kTileThreads, 0, stream>>>(
        round == 0 ? keys : nullptr, src, m, k, dst, last ? idx_out : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = dst;
    m = blocks * k;
  }
}
