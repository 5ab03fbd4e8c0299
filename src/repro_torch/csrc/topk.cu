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
// Int64 keys (repro_topk_select64): the engine's composite ranks that span
// more than float32 holds exactly.  An int64 key maps to an order-preserving
// uint64 (sign bit flipped) and travels beside its row as a 16-byte pair,
// compared by (key, row): the same tie-stable answer, by the same rounds,
// with twice the shared memory and scratch a candidate.
//
// Bound on H100: bytes (n*4 or n*8 read, k*4 written), but at the engine's
// sizes (a few hundred keys) the launch latency dominates.
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

// float32 keys: the order-preserving uint32 of the key and the row packed
// in one uint64, so a candidate compares as one integer
struct F32Rank {
  using Key = float;
  using Item = uint64_t;
  static __device__ __forceinline__ Item make(float x, int64_t row) {
    return pack_key(x, row);
  }
  static __device__ __forceinline__ Item pad() { return UINT64_MAX; }
  static __device__ __forceinline__ bool after(Item a, Item b) { return a > b; }
  static __device__ __forceinline__ int32_t row(Item a) {
    return static_cast<int32_t>(a & 0xffffffffu);
  }
};

// int64 keys: the order-preserving uint64 of the key beside the row.  Rows
// are below 2^31, so the padding's row UINT32_MAX loses every tie
struct I64Rank {
  using Key = int64_t;
  struct Item {
    uint64_t key;
    uint32_t row;
  };
  static __device__ __forceinline__ Item make(int64_t x, int64_t row) {
    return {static_cast<uint64_t>(x) ^ 0x8000000000000000ull,
            static_cast<uint32_t>(row)};
  }
  static __device__ __forceinline__ Item pad() { return {UINT64_MAX, UINT32_MAX}; }
  static __device__ __forceinline__ bool after(const Item& a, const Item& b) {
    return a.key > b.key || (a.key == b.key && a.row > b.row);
  }
  static __device__ __forceinline__ int32_t row(const Item& a) {
    return static_cast<int32_t>(a.row);
  }
};

// One round: sort each kTileN-entry tile of the input (kTileN a power of
// two, kTileN/2 threads: one compare-exchange per thread per step) and keep
// its first k.  Round 1 reads keys (keys != nullptr); later rounds read
// candidates.  The last round (idx_out != nullptr) writes row indices.  A
// step whose pairs lie 32 or fewer apart reads only what its own warp wrote
// in the step before (a warp's 32 threads own 64 consecutive entries), so
// it waits on the warp, not the block.
template <int kTileN, class R>
__global__ void __launch_bounds__(kTileN / 2)
topk_tile_kernel(const typename R::Key* __restrict__ keys,
                 const typename R::Item* __restrict__ cand, int64_t m, int k,
                 typename R::Item* __restrict__ cand_out,
                 int32_t* __restrict__ idx_out) {
  using Item = typename R::Item;
  constexpr int kThreadsN = kTileN / 2;
  __shared__ Item s[kTileN];
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTileN;
#pragma unroll
  for (int j = t; j < kTileN; j += kThreadsN) {
    const int64_t i = base + j;
    Item v = R::pad();
    if (i < m) v = keys != nullptr ? R::make(keys[i], i) : cand[i];
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
      const Item a = s[i], b = s[j];
      if (R::after(a, b) == ascending) {
        s[i] = b;
        s[j] = a;
      }
    }
  }
  __syncthreads();
  for (int j = t; j < k; j += kThreadsN) {
    if (idx_out != nullptr) {
      idx_out[j] = R::row(s[j]);
    } else {
      cand_out[static_cast<int64_t>(blockIdx.x) * k + j] = s[j];
    }
  }
}

// one block over the n <= kTile keys, in a tile of `tile` entries
template <class R>
cudaError_t one_tile(const typename R::Key* keys, int64_t n, int k, int tile,
                     int32_t* idx_out, cudaStream_t stream) {
  switch (tile) {
    case 64:
      topk_tile_kernel<64, R><<<1, 32, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 128:
      topk_tile_kernel<128, R><<<1, 64, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 256:
      topk_tile_kernel<256, R><<<1, 128, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    case 512:
      topk_tile_kernel<512, R><<<1, 256, 0, stream>>>(keys, nullptr, n, k, nullptr, idx_out);
      break;
    default:
      topk_tile_kernel<kTile, R><<<1, kTile / 2, 0, stream>>>(keys, nullptr, n, k,
                                                              nullptr, idx_out);
  }
  return cudaGetLastError();
}

template <class R>
cudaError_t select_topk(const typename R::Key* keys, int64_t n, int k, int tile,
                        void* scratch, int32_t* idx_out, cudaStream_t stream) {
  using Item = typename R::Item;
  if (n <= 0 || k <= 0) return cudaSuccess;
  if (n <= kTile) {
    if (tile < kMinTile || tile > kTile || (tile & (tile - 1)) || tile < n) {
      return cudaErrorInvalidValue;
    }
    return one_tile<R>(keys, n, k, tile, idx_out, stream);
  }
  const int64_t first_len = (n + kTile - 1) / kTile * k;
  Item* bufs[2] = {static_cast<Item*>(scratch), static_cast<Item*>(scratch) + first_len};
  const Item* src = nullptr;
  int64_t m = n;
  for (int round = 0;; ++round) {
    const int64_t blocks = (m + kTile - 1) / kTile;
    const bool last = blocks == 1;
    Item* dst = last ? nullptr : bufs[round & 1];
    topk_tile_kernel<kTile, R><<<static_cast<unsigned>(blocks), kTile / 2, 0, stream>>>(
        round == 0 ? keys : nullptr, src, m, k, dst, last ? idx_out : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = dst;
    m = blocks * k;
  }
}

}  // namespace

// For n <= 1024, one round sorts a tile of `tile` keys (a power of two in
// [64, 1024], >= n) and scratch is unused (null).  Above, scratch holds
// ceil(n/1024)*k candidates for the odd rounds, then the even rounds'
// (sized by kernels/topk.py::scratch_len): 8 bytes a candidate for float32
// keys, 16 for int64 keys.
extern "C" cudaError_t repro_topk_select(const float* keys, int64_t n, int k,
                                         int tile, void* scratch,
                                         int32_t* idx_out, cudaStream_t stream) {
  return select_topk<F32Rank>(keys, n, k, tile, scratch, idx_out, stream);
}

extern "C" cudaError_t repro_topk_select64(const int64_t* keys, int64_t n, int k,
                                           int tile, void* scratch,
                                           int32_t* idx_out, cudaStream_t stream) {
  return select_topk<I64Rank>(keys, n, k, tile, scratch, idx_out, stream);
}
