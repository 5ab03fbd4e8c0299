// Hash-join run expansion: output position j belongs to the probe row p
// whose run [start_p, start_p + counts_out[p]) covers j (start_p the
// exclusive prefix sum of counts_out); it gathers build row
// order[lo[p] + (j - start_p)], clipped to [0, nb - 1], where counts[p] > 0
// (a left join's unmatched row, counts_out 1 and counts 0, gathers order[0]
// and matched = false).  Positions past the true total (the bucket's
// filler) belong to the last run, as the plain version's padding does; a
// bucket shorter than the true total cuts the output.
//
// Replaces the Pallas TPU kernel src/repro/kernels/join_expand.py::join_expand
// (the device version of relational/join.py::_join_expand).
//
// Bound on H100: bytes.  The function must read counts_out once, write two
// int64 indices and a flag per output position (17 bytes), and read lo,
// counts and order once per real output.
//
// Design: one launch that scans the runs and writes their outputs (a
// single-pass scan with decoupled look-back, Merrill & Garland 2016).
//   * A tile of 2,048 runs per block.  The block takes its tile index from
//     a counter with atomicAdd, so every earlier tile belongs to a block
//     that is running or done; it loads the tile's counts_out with 16-byte
//     loads (8 runs a thread) and scans it in int64 into shared memory.
//   * The tile's offset by look-back.  The block publishes its tile's sum
//     in a status word (flag "aggregate"), then one warp reads the words of
//     the 32 tiles before it at once, waits until each is published, adds
//     the aggregates back to the nearest inclusive prefix and publishes its
//     own inclusive prefix (flag "prefix").  A status word packs an epoch
//     (20 bits), the flag (2 bits), an overflow bit (below) and the value
//     (41 bits, saturated: a bucket is below 2^40), so a word left by an
//     earlier launch never passes for this one's, and nothing is zeroed
//     between launches; the wrapper zeroes the words when its epoch wraps.
//     The counter is never reset either: the wrapper passes the counter's
//     value at this launch (the blocks of all earlier launches on the
//     stream), and the kernel subtracts it.
//   * Outputs spread over the block.  The block writes the first 8,192
//     outputs of its tile's range [X, X + sum), cut at the bucket: thread
//     i takes X + i, X + i + 256, ..., two at a time, each found by a
//     fixed 11-step search of the tile's scan in shared memory (so the two
//     searches interleave), then the loads of both (lo, counts and order,
//     gathered in place), then their stores, coalesced.
//   * Helper blocks.  The grid carries a few blocks past the tiles (their
//     tile index is >= the tile count, so every tile was taken before
//     them); each waits for the last tile's prefix word: the true total T,
//     and an overflow bit that every prefix carries forward from the
//     tiles it covers, set where a tile has more than 8,192 outputs.  Only
//     then (a skewed join: one run of 300,000) do the helpers split [0, T)
//     into equal shares and write the outputs past each tile's first
//     8,192 in their share, re-scanning such a tile into shared memory, so
//     a long run is spread over the grid and not left to one block.  Then
//     each writes its stride of the filler [T, total).
// So one grid a call, and no prefix sum of counts_out written to device
// memory and read back.
//
// ptxas (sm_90a, -O3; kernels/build.py's log on the H100): 40 registers
// under __launch_bounds__(256, 6), 44 bytes of spill stores and 48 of
// loads (a 40-byte stack frame), 16,476 bytes of static shared memory: 6
// blocks an SM.  Without the bound it takes 64 registers and no spill,
// but with 4 blocks an SM lineitem x orders ran slower in a trial.
#include "common.cuh"

namespace {

constexpr int kTileRuns = 2048;        // kernels/join_expand.py TILE_RUNS
constexpr int kPerThread = kTileRuns / repro::kThreads;   // 8
constexpr int kOutUnroll = 2;          // output positions a thread takes at once
constexpr int kOwnOutputs = 8192;      // a tile block writes at most these
constexpr int kWarps = repro::kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kValueBits = 41;
constexpr int kOverflowBit = kValueBits;         // a tile up to here left work
constexpr int kFlagShift = kValueBits + 1;
constexpr int kEpochShift = kFlagShift + 2;
constexpr long long kCap = (1LL << kValueBits) - 1;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long pack(unsigned epoch, unsigned long long flag,
                                                   long long value, bool overflow) {
  const long long v = value < kCap ? value : kCap;
  return (static_cast<unsigned long long>(epoch) << kEpochShift) | (flag << kFlagShift) |
         (static_cast<unsigned long long>(overflow) << kOverflowBit) |
         static_cast<unsigned long long>(v);
}

// a spin that outlasts any real wait (seconds) means a broken launch: trap,
// so that the call fails instead of hanging the card
__device__ __forceinline__ void spin_wait(unsigned& spins) {
  if (++spins > (1u << 26)) __trap();
  __nanosleep(32);
}

__device__ __forceinline__ unsigned long long flag_of(unsigned long long w, unsigned epoch) {
  return (w >> kEpochShift) == epoch ? (w >> kFlagShift) & 3 : 0;
}

__device__ __forceinline__ long long value_of(unsigned long long w) {
  return static_cast<long long>(w & static_cast<unsigned long long>(kCap));
}

__device__ __forceinline__ bool overflow_of(unsigned long long w) {
  return (w >> kOverflowBit) & 1;
}

// the build position of output `intra` of run p (0 where the run has no
// match), clipped to [0, nb - 1]
__device__ __forceinline__ int64_t build_pos(int64_t p, int64_t intra, bool m,
                                             const int64_t* __restrict__ lo, int64_t nb) {
  if (!m) return 0;
  const int64_t pos = __ldg(lo + p) + intra;
  return pos < 0 ? 0 : (pos > nb - 1 ? nb - 1 : pos);
}

// Wait for tile i's prefix word (published by a block that is running or
// done) and return it.
__device__ unsigned long long prefix_word(const unsigned long long* status, int64_t i,
                                          unsigned epoch) {
  unsigned long long w = load_status(status + i);
  for (unsigned spins = 0; flag_of(w, epoch) != kPrefix;) {
    spin_wait(spins);
    w = load_status(status + i);
  }
  return w;
}

__device__ __forceinline__ long long inclusive_prefix(const unsigned long long* status,
                                                      int64_t i, unsigned epoch) {
  return value_of(prefix_word(status, i, epoch));
}

// Load tile t's counts_out (8 consecutive runs a thread, 16-byte loads
// where aligned) and scan it into start[] (exclusive); every thread
// returns the tile's sum.  nr = the tile's runs.
__device__ long long scan_tile(const int64_t* __restrict__ counts_out, int64_t r0, int nr,
                               long long* start, long long* warp_sums) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = tid * kPerThread;
  long long c[kPerThread];
  const int64_t* src = counts_out + r0 + i0;
  if (i0 + kPerThread <= nr && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < kPerThread; k += 2) {
      const longlong2 pair = __ldg(reinterpret_cast<const longlong2*>(src + k));
      c[k] = pair.x;
      c[k + 1] = pair.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) c[k] = i0 + k < nr ? __ldg(src + k) : 0;
  }
  long long mine = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) mine += c[k];
  long long incl = mine;   // inclusive scan over the warp's threads
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFullWarp, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const long long y = __shfl_up_sync(kFullWarp, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  long long run = incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    start[i0 + k] = run;
    run += c[k];
  }
  const long long sum = warp_sums[kWarps - 1];
  __syncthreads();   // start[] is complete; warp_sums may be reused
  return sum;
}

// Write output positions [j_begin, j_end) of the tile whose runs start at
// r0 (nr of them, scanned into start[], first output at `offset`), with the
// whole block: thread i takes j_begin + i, + 256, ..., kOutUnroll at a
// time, each found by a fixed 11-step search of start[] (so the searches
// interleave), then their loads, then their stores.
__device__ void write_range(int64_t j_begin, int64_t j_end, int64_t offset, int64_t r0,
                            int nr, const long long* start,
                            const int64_t* __restrict__ lo,
                            const int64_t* __restrict__ counts,
                            const int64_t* __restrict__ order,
                            int64_t* __restrict__ probe_idx,
                            int64_t* __restrict__ build_idx,
                            bool* __restrict__ matched, int64_t nb) {
  for (int64_t j0 = j_begin + threadIdx.x; j0 < j_end; j0 += kOutUnroll * repro::kThreads) {
    int run[kOutUnroll];
    int64_t pos[kOutUnroll];
    bool m[kOutUnroll];
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      const long long q = j0 + u * repro::kThreads - offset;
      int low = 0;   // the last run of the tile that starts <= q
#pragma unroll
      for (int step = kTileRuns / 2; step > 0; step >>= 1) {
        if (low + step < nr && start[low + step] <= q) low += step;
      }
      run[u] = low;
      pos[u] = q - start[low];   // the output's place in its run
    }
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      m[u] = j0 + u * repro::kThreads < j_end && __ldg(counts + r0 + run[u]) > 0;
    }
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) pos[u] = build_pos(r0 + run[u], pos[u], m[u], lo, nb);
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) pos[u] = __ldg(order + pos[u]);
#pragma unroll
    for (int u = 0; u < kOutUnroll; ++u) {
      const int64_t j = j0 + u * repro::kThreads;
      if (j < j_end) {
        probe_idx[j] = r0 + run[u];
        build_idx[j] = pos[u];
        matched[j] = m[u];
      }
    }
  }
}

__global__ void __launch_bounds__(repro::kThreads, 6)
join_expand_kernel(const int64_t* __restrict__ counts_out, const int64_t* __restrict__ lo,
                   const int64_t* __restrict__ counts, const int64_t* __restrict__ order,
                   int64_t* __restrict__ probe_idx, int64_t* __restrict__ build_idx,
                   bool* __restrict__ matched, int64_t n, int64_t nb, int64_t total,
                   int64_t n_tiles, unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ counter, unsigned long long base,
                   unsigned epoch) {
  __shared__ long long start[kTileRuns];   // a tile's exclusive scan
  __shared__ long long warp_sums[kWarps];
  __shared__ long long tile_s, offset_s, bound_s;
  __shared__ int overflow_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_s = static_cast<long long>(atomicAdd(counter, 1ULL) - base);
  __syncthreads();
  const int64_t t = tile_s;

  if (t >= n_tiles) {   // a helper block, past the tiles
    const int64_t helper = t - n_tiles;
    const int64_t helpers = static_cast<int64_t>(gridDim.x) - n_tiles;
    if (tid == 0) {   // the true total, and whether any tile left work
      const unsigned long long w = prefix_word(status, n_tiles - 1, epoch);
      offset_s = value_of(w);
      overflow_s = overflow_of(w);
    }
    __syncthreads();
    const int64_t true_total = offset_s;
    const int64_t limit = true_total < total ? true_total : total;
    if (overflow_s && limit > 0) {
      // the tiles' outputs past their first kOwnOutputs: helper e takes
      // those in its share [c0, c1) of [0, limit), tile by tile
      const int64_t share = (limit + helpers - 1) / helpers;
      const int64_t c0 = helper * share;
      const int64_t c1 = c0 + share < limit ? c0 + share : limit;
      if (tid == 0 && c0 < c1) {   // the first tile whose outputs pass c0
        int64_t low = 0, high = n_tiles - 1;
        while (low < high) {
          const int64_t mid = (low + high) / 2;
          if (inclusive_prefix(status, mid, epoch) > c0) {
            high = mid;
          } else {
            low = mid + 1;
          }
        }
        tile_s = low;
      }
      __syncthreads();
      for (int64_t tt = tile_s; c0 < c1 && tt < n_tiles; ++tt) {
        if (tid == 0) {
          offset_s = tt > 0 ? inclusive_prefix(status, tt - 1, epoch) : 0;
          bound_s = inclusive_prefix(status, tt, epoch);
        }
        __syncthreads();
        const int64_t first = offset_s;
        const int64_t a = first + kOwnOutputs > c0 ? first + kOwnOutputs : c0;
        const int64_t b = bound_s < c1 ? bound_s : c1;
        if (first >= c1) break;
        if (a < b) {
          const int64_t r0 = tt * kTileRuns;
          const int nr = n - r0 < kTileRuns ? static_cast<int>(n - r0) : kTileRuns;
          scan_tile(counts_out, r0, nr, start, warp_sums);
          write_range(a, b, first, r0, nr, start, lo, counts, order, probe_idx, build_idx,
                      matched, nb);
        }
        __syncthreads();   // before offset_s, bound_s and start[] change
      }
    }
    if (true_total >= total) return;
    // the filler [T, total): every helper takes a stride of it
    const int64_t last = n - 1;
    const int64_t last_start = true_total - __ldg(counts_out + last);
    const bool m = __ldg(counts + last) > 0;
    for (int64_t j = true_total + helper * repro::kThreads + tid; j < total;
         j += helpers * repro::kThreads) {
      probe_idx[j] = last;
      build_idx[j] = __ldg(order + build_pos(last, j - last_start, m, lo, nb));
      matched[j] = m;
    }
    return;
  }

  const int64_t r0 = t * kTileRuns;
  const int nr = n - r0 < kTileRuns ? static_cast<int>(n - r0) : kTileRuns;
  const long long tile_sum = scan_tile(counts_out, r0, nr, start, warp_sums);

  // the tile's offset: decoupled look-back over the earlier tiles
  // A word's overflow bit says that this tile (an aggregate) or one up to
  // it (a prefix) has more than kOwnOutputs outputs, which helpers write.
  if (warp == 0) {
    bool overflow = tile_sum > kOwnOutputs;
    long long offset = 0;
    if (t == 0) {
      if (lane == 0) store_status(status, pack(epoch, kPrefix, tile_sum, overflow));
    } else {
      if (lane == 0) store_status(status + t, pack(epoch, kAggregate, tile_sum, overflow));
      int64_t idx = t - 1;
      while (true) {
        const int64_t j = idx - lane;
        unsigned long long flag = kPrefix;
        long long value = 0;   // before tile 0: a prefix of 0
        bool over = false;
        if (j >= 0) {
          unsigned long long w = load_status(status + j);
          flag = flag_of(w, epoch);
          for (unsigned spins = 0; flag == 0; flag = flag_of(w, epoch)) {
            spin_wait(spins);
            w = load_status(status + j);
          }
          value = value_of(w);
          over = overflow_of(w);
        }
        const unsigned prefixes = __ballot_sync(kFullWarp, flag == kPrefix);
        if (prefixes && lane > __ffs(prefixes) - 1) value = 0, over = false;
        overflow |= __any_sync(kFullWarp, over);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) value += __shfl_xor_sync(kFullWarp, value, off);
        offset += value;
        offset = offset < kCap ? offset : kCap;
        if (prefixes) break;
        idx -= 32;
      }
      if (lane == 0) store_status(status + t, pack(epoch, kPrefix, offset + tile_sum, overflow));
    }
    if (lane == 0) offset_s = offset;
  }
  __syncthreads();

  // the tile's first kOwnOutputs outputs, spread over the block (helper
  // blocks take the rest of a longer range)
  const int64_t offset = offset_s;
  int64_t end = offset + tile_sum < total ? offset + tile_sum : total;
  end = end < offset + kOwnOutputs ? end : offset + kOwnOutputs;
  write_range(offset, end, offset, r0, nr, start, lo, counts, order, probe_idx, build_idx,
              matched, nb);
}

}  // namespace

// The wrapper (kernels/join_expand.py) has checked the shapes: n >= 1 runs,
// nb >= 1 build rows, 1 <= total < 2^40, n_tiles = ceil(n / 2048),
// helper_blocks >= 1.  status holds n_tiles words left by earlier launches
// with other epochs (or zeros); counter holds base.
extern "C" cudaError_t repro_join_expand(const int64_t* counts_out, const int64_t* lo,
                                         const int64_t* counts, const int64_t* order,
                                         int64_t* probe_idx, int64_t* build_idx,
                                         bool* matched, int64_t n, int64_t nb,
                                         int64_t total, int64_t n_tiles, int helper_blocks,
                                         unsigned long long* status,
                                         unsigned long long* counter,
                                         unsigned long long base, unsigned epoch,
                                         cudaStream_t stream) {
  if (total == 0) return cudaSuccess;
  join_expand_kernel<<<static_cast<unsigned>(n_tiles + helper_blocks), repro::kThreads, 0,
                       stream>>>(counts_out, lo, counts, order, probe_idx, build_idx,
                                 matched, n, nb, total, n_tiles, status, counter, base,
                                 epoch);
  return cudaGetLastError();
}
