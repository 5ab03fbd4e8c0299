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
// Design: one block of tile/2 threads per tile of keys loads the tile into
// shared memory (rows past the end become UINT64_MAX, which no real key
// packs to, so padding never wins), bitonic-sorts it, and writes its first
// k packed values.  For n <= 1024 keys, which covers the engine's main
// path (38-433 keys on ClickBench), one block sorts a tile sized to n: the
// next power of two >= max(n, 64), chosen by the wrapper (kernels/topk.py
// tile_for), so 433 keys take 512 slots and log2(512)*(log2(512)+1)/2 =
// 45 steps, 38 keys 64 slots and 21 steps.  Above 1024 keys every round
// sorts 1024-key tiles (55 steps) and the same kernel then runs over the
// blocks*k candidates, which carry their original rows, until one tile is
// left, whose first k give the int32 indices; k <= 128 shrinks the
// candidates at least 8x a round.  The TPU kernel's k rounds of a
// tile-wide argmin are not carried over: a sort network does the tile in
// the same steps whatever k is.
//
// Bound on H100: bytes (n*4 read, k*4 written), but at the engine's sizes
// (a few hundred keys) the launch latency dominates.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;         // the largest tile, and every round's above it
constexpr int kMinTile = 64;        // one warp

__device__ __forceinline__ uint64_t pack_key(float x, int64_t row) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) == 0) u = 0;  // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(row);
}

// One round: sort each kTileN-entry tile of the input (kTileN a power of
// two, kTileN/2 threads: one compare-exchange per thread per step) and keep
// its first k.  Round 1 reads float keys (keys != nullptr); later rounds
// read packed candidates.  The last round (idx_out != nullptr) writes row
// indices.  A step whose pairs lie 32 or fewer apart reads only what its
// own warp wrote in the step before (a warp's 32 threads own 64
// consecutive entries), so it waits on the warp, not the block.
template <int kTileN>
__global__ void __launch_bounds__(kTileN / 2)
topk_tile_kernel(const float* __restrict__ keys, const uint64_t* __restrict__ cand,
                 int64_t m, int k, uint64_t* __restrict__ cand_out,
                 int32_t* __restrict__ idx_out) {
  constexpr int kThreadsN = kTileN / 2;
  __shared__ uint64_t s[kTileN];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileN;
#pragma unroll
  for (int j = t; j < kTileN; j += kThreadsN) {
    const int64_t i = base + j;
    uint64_t v = UINT64_MAX;
    if (i < m) v = keys != nullptr ? pack_key(keys[i], i) : cand[i];
    s[j] = v;
  }
  __syncthreads();
#pragma unroll
  for (int size = 2; size <= kTileN; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        __syncthreads();
      } else {
        __syncwarp();
      }
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
  for (int j = t; j < k; j += kThreadsN) {
    if (idx_out != nullptr) {
      idx_out[j] = static_cast<int32_t>(s[j] & 0xffffffffu);
    } else {
      cand_out[static_cast<int64_t>(blockIdx.x) * k + j] = s[j];
    }
  }
}

// one block over the n <= kTile keys, in a tile of `tile` entries
cudaError_t one_tile(const float* keys, int64_t n, int k, int tile,
                     int32_t* idx_out, cudaStream_t stream) {
  switch (tile) {
    case 64:
      topk_tile_kernel<64><<<1, 32, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 128:
      topk_tile_kernel<128><<<1, 64, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 256:
      topk_tile_kernel<256><<<1, 128, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 512:
      topk_tile_kernel<512><<<1, 256, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    default:
      topk_tile_kernel<kTile><<<1, kTile / 2, 0, stream>>>(keys, nullptr, n, k,
                                                           nullptr, idx_out);
  }
  return cudaGetLastError();
}

}  // namespace

// For n <= 1024, one round sorts a tile of `tile` keys (a power of two in
// [64, 1024], >= n) and scratch is unused (null).  Above, scratch holds
// ceil(n/1024)*k uint64 for the odd rounds' candidates, then the even
// rounds' (sized by kernels/topk.py::scratch_len).
extern "C" cudaError_t repro_topk_select(const float* keys, int64_t n, int k,
                                         int tile, uint64_t* scratch,
                                         int32_t* idx_out, cudaStream_t stream) {
  if (n <= 0 || k <= 0) return cudaSuccess;
  if (n <= kTile) {
    if (tile < kMinTile || tile > kTile || (tile & (tile - 1)) || tile < n) {
      return cudaErrorInvalidValue;
    }
    return one_tile(keys, n, k, tile, idx_out, stream);
  }
  const int64_t first_len = (n + kTile - 1) / kTile * k;
  uint64_t* bufs[2] = {scratch, scratch + first_len};
  const uint64_t* src = nullptr;
  int64_t m = n;
  for (int round = 0;; ++round) {
    const int64_t blocks = (m + kTile - 1) / kTile;
    const bool last = blocks == 1;
    uint64_t* dst = last ? nullptr : bufs[round & 1];
    topk_tile_kernel<kTile><<<static_cast<unsigned>(blocks), kTile / 2, 0, stream>>>(
        round == 0 ? keys : nullptr, src, m, k, dst, last ? idx_out : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = dst;
    m = blocks * k;
  }
}
