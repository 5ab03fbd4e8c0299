// Open-addressing hash-join probe: for each int32 key, the build row stored
// under it, or -1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_probe.py::hash_probe.
//
// Table: slots_key / slots_row int32[cap], cap a power of two, built by
// kernels/hash_probe.py::build_table32 with the same hash.  The hash is
// h = key * 0x9E3779B9 in wrapping 32-bit arithmetic, then h ^ (h >> 15)
// with an arithmetic shift, masked to cap.  Linear probing ends at the key
// with row >= 0 (a hit), at row == -1 (absent), or after max_probes rounds
// (-1), as kernels/ref.py::hash_probe_ref.
//
// Bound on H100: bytes.  Each key is read once and a row and a flag written
// once (9 bytes a key); the table is read at random but is small enough to
// stay in the 50 MB L2 (Q3 at SF1: 3.0 M keys into a 2^19-slot table,
// ~32 MB in all, ~9.4 us at 3.35 TB/s).
//
// What the main path feeds it: map_probe_keys turns every key absent from the
// build into the one rank -2, so at Q3's second call ~99% of the keys are
// -2, and in that table -2's chain is 7 slots long.  Walked by every thread,
// that chain costs more than the keys' whole stream, even from L1.  And each
// further read a warp has to wait for shows in the call's time, L1 hit or
// not, since few warps have other work meanwhile.  So the design keeps the
// round trips a warp waits for to the key load and one table read.
//
// Design (one grid a call):
//   * Wide kernel, for calls that give each warp at least two tiles.  A warp
//     takes a tile of 128 consecutive keys, 4 a lane: one 16-byte load a lane
//     (ld.global.L1::no_allocate, so the stream does not evict table lines
//     from L1), 512 contiguous bytes a warp.  Rows go out as one 16-byte
//     st.global.cs a lane and flags as one 4-byte store.
//   * The warp's hot key.  When more than 16 lanes hold the same first key
//     (__match_any_sync, skipped while the key held still has most lanes),
//     the whole warp walks that key's chain once, 32 slots a read, and keeps
//     the result: later keys equal to it need no table read.  This is exact
//     (a key's result depends only on the key) and takes -2 off the table.
//   * The first slot of every other key: slots_row and slots_key of all 4
//     keys are read together (ld.global.L1::evict_last), one round trip.
//   * The rest inline: a lane whose key's slot holds another key walks its
//     lowest such key two slots a read until no lane has one left.  Most
//     chains end within one read (load factor <= 0.5).
//   * Narrow kernel, for smaller calls (Q5's and Q3's first probes): one key
//     a thread, both words of each slot a read.  Here a warp's tile would be
//     its only one, and the wide kernel's lockstep wait for the longest of
//     128 chains costs more than it saves.
//   * Grids sized to the card: resident blocks an SM (the occupancy API,
//     read once a device and kernel) times the SMs, with a grid stride.
//   * Ragged and unaligned input inside the kernel: the last partial tile,
//     and keys whose pointer is not 16-byte aligned (a view such as
//     p32[1:]), are read and written 4 bytes at a time.  The wrapper
//     allocates the outputs, so they start on 16-byte boundaries.
// The multiply is done on uint32_t, since signed overflow is undefined in
// C++, and cast back before the shift.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneKeys = 4;                // keys a lane takes in the wide kernel
constexpr int kTileKeys = 32 * kLaneKeys;   // keys a warp takes at once
constexpr int kWarps = repro::kThreads / 32;
constexpr int kWideBlocksPerSm = 6;         // __launch_bounds__: <= 40 registers
constexpr int kMaxDevices = 64;

__device__ __forceinline__ int32_t first_slot(int32_t key, int32_t mask) {
  int32_t h = static_cast<int32_t>(static_cast<uint32_t>(key) * 0x9E3779B9u);
  h = h ^ (h >> 15);  // arithmetic shift of a signed int32, as in jnp
  return h & mask;
}

// A table word, kept in L1 ahead of the streamed keys.
__device__ __forceinline__ int32_t load_slot(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.L1::evict_last.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// 4 keys that pass L1 by.
__device__ __forceinline__ int4 load_keys(const int32_t* p) {
  int4 v;
  asm volatile("ld.global.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The chain of key from probe 0, one slot a read (narrow kernel).
__device__ __forceinline__ int32_t probe_chain(int32_t key, const int32_t* __restrict__ slots_key,
                                               const int32_t* __restrict__ slots_row,
                                               int32_t mask, int max_probes) {
  const int32_t h0 = first_slot(key, mask);
  for (int p = 0; p < max_probes; ++p) {
    const int32_t cand = (h0 + p) & mask;
    const int32_t r = load_slot(slots_row + cand);
    const int32_t k = load_slot(slots_key + cand);
    if (r == -1) break;  // empty slot: the key is absent
    if (r >= 0 && k == key) return r;
  }
  return -1;
}

// The chain of key, walked by the whole warp, 32 slots a read.
__device__ __noinline__ int32_t warp_chain(int32_t key, const int32_t* __restrict__ slots_key,
                                           const int32_t* __restrict__ slots_row, int32_t mask,
                                           int max_probes, int lane) {
  const int32_t h0 = first_slot(key, mask);
  for (int p = 0; p < max_probes; p += 32) {
    const int q = p + lane;
    const bool in = q < max_probes;
    const int32_t cand = (h0 + q) & mask;
    const int32_t r = in ? load_slot(slots_row + cand) : -1;
    const int32_t k = in ? load_slot(slots_key + cand) : 0;
    const bool hit = in && r >= 0 && k == key;
    const unsigned stop = __ballot_sync(kFull, !in || r == -1 || hit);
    if (stop != 0) return __shfl_sync(kFull, hit ? r : -1, __ffs(stop) - 1);
  }
  return -1;
}

__global__ void __launch_bounds__(repro::kThreads)
hash_probe_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ slots_key,
                  const int32_t* __restrict__ slots_row, int32_t* __restrict__ row_out,
                  bool* __restrict__ found, int64_t n, int32_t mask, int max_probes) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * repro::kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * repro::kThreads + threadIdx.x; i < n;
       i += stride) {
    const int32_t row = probe_chain(__ldcs(keys + i), slots_key, slots_row, mask, max_probes);
    __stcs(row_out + i, row);
    found[i] = row >= 0;
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(repro::kThreads, kWideBlocksPerSm)
hash_probe_wide_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ slots_key,
                       const int32_t* __restrict__ slots_row, int32_t* __restrict__ row_out,
                       bool* __restrict__ found, int64_t n, int32_t mask, int max_probes) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t tiles = (n + kTileKeys - 1) / kTileKeys;
  int32_t hot_key = 0, hot_row = -1;  // the warp's hot key and its result
  bool hot = false;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); t < tiles;
       t += warps) {
    const int64_t base = t * kTileKeys + kLaneKeys * lane;  // this lane's 4 keys
    const bool full = (t + 1) * kTileKeys <= n;
    int32_t key[kLaneKeys], row[kLaneKeys], kk[kLaneKeys];
    if (kAligned && full) {
      const int4 v = load_keys(keys + base);
      key[0] = v.x;
      key[1] = v.y;
      key[2] = v.z;
      key[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) key[j] = base + j < n ? __ldcs(keys + base + j) : 0;
    }
    // a new hot key only when the one held no longer has most lanes
    const bool keep = hot && __popc(__ballot_sync(kFull, key[0] == hot_key)) > 16;
    const unsigned same = keep ? 0u : __match_any_sync(kFull, key[0]);
    const unsigned major = keep ? 0u : __ballot_sync(kFull, __popc(same) > 16);
    if (major != 0) {
      const int32_t mk = __shfl_sync(kFull, key[0], __ffs(major) - 1);
      if (!hot || mk != hot_key) {
        hot_row = warp_chain(mk, slots_key, slots_row, mask, max_probes, lane);
        hot_key = mk;
        hot = true;
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      const int32_t h0 = first_slot(key[j], mask);
      row[j] = load_slot(slots_row + h0);
      kk[j] = load_slot(slots_key + h0);
    }
    unsigned open = 0;  // bit j: key j's chain goes on past its first slot
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      const int32_t r = row[j];
      if (hot && key[j] == hot_key) {
        row[j] = hot_row;
      } else if (max_probes > 0 && r >= 0 && kk[j] == key[j]) {
        row[j] = r;
      } else {
        row[j] = -1;
        if (max_probes > 1 && r != -1 && (full || base + j < n)) open |= 1u << j;
      }
    }
    // each lane walks its lowest open key, two slots a read; keys equal to it
    // take its result
    int32_t kx = 0, hx = 0;
    int p = 1;
    if (open != 0) {
      const int j0 = __ffs(open) - 1;
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j)
        if (j == j0) kx = key[j];
      hx = first_slot(kx, mask);
    }
    while (__any_sync(kFull, open != 0)) {
      if (open == 0) continue;
      const int32_t c0 = (hx + p) & mask, c1 = (hx + p + 1) & mask;
      const int32_t r2[2] = {load_slot(slots_row + c0), load_slot(slots_row + c1)};
      const int32_t k2[2] = {load_slot(slots_key + c0), load_slot(slots_key + c1)};
      bool done = false;
      int32_t res = -1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (done) continue;
        if (p >= max_probes || r2[e] == -1) {
          done = true;
        } else if (r2[e] >= 0 && k2[e] == kx) {
          res = r2[e];
          done = true;
        } else {
          ++p;
        }
      }
      if (!done) continue;
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) {
        if ((open >> j & 1u) && key[j] == kx) {
          row[j] = res;
          open &= ~(1u << j);
        }
      }
      if (open != 0) {
        const int j0 = __ffs(open) - 1;
#pragma unroll
        for (int j = 0; j < kLaneKeys; ++j)
          if (j == j0) kx = key[j];
        hx = first_slot(kx, mask);
        p = 1;
      }
    }
    if (full) {
      __stcs(reinterpret_cast<int4*>(row_out + base), make_int4(row[0], row[1], row[2], row[3]));
      const unsigned flags = static_cast<unsigned>(row[0] >= 0) |
                             static_cast<unsigned>(row[1] >= 0) << 8 |
                             static_cast<unsigned>(row[2] >= 0) << 16 |
                             static_cast<unsigned>(row[3] >= 0) << 24;
      __stcs(reinterpret_cast<unsigned*>(found + base), flags);
    } else {
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) {
        if (base + j < n) {
          __stcs(row_out + base + j, row[j]);
          found[base + j] = row[j] >= 0;
        }
      }
    }
  }
}

// Resident blocks of a kernel on the whole card, read once a device (the
// occupancy query costs host time).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* cache, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  *blocks = device < kMaxDevices ? cache[device] : 0;
  if (*blocks > 0) return cudaSuccess;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, repro::kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms > 0 ? per_sm * sms : 1;
  if (device < kMaxDevices) cache[device] = *blocks;
  return cudaSuccess;
}

template <bool kAligned>
cudaError_t launch(const int32_t* keys, const int32_t* slots_key, const int32_t* slots_row,
                   int32_t* row_out, bool* found, int64_t n, int32_t mask, int max_probes,
                   cudaStream_t stream) {
  static int wide_cache[kMaxDevices] = {};
  static int narrow_cache[kMaxDevices] = {};
  int blocks = 0;
  cudaError_t err = resident_blocks(hash_probe_wide_kernel<kAligned>, wide_cache, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTileKeys - 1) / kTileKeys;
  if (tiles >= 2 * static_cast<int64_t>(blocks) * kWarps) {
    hash_probe_wide_kernel<kAligned><<<blocks, repro::kThreads, 0, stream>>>(
        keys, slots_key, slots_row, row_out, found, n, mask, max_probes);
    return cudaGetLastError();
  }
  err = resident_blocks(hash_probe_kernel, narrow_cache, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t need = (n + repro::kThreads - 1) / repro::kThreads;
  const unsigned grid = static_cast<unsigned>(need < blocks ? need : blocks);
  hash_probe_kernel<<<grid, repro::kThreads, 0, stream>>>(keys, slots_key, slots_row, row_out,
                                                          found, n, mask, max_probes);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/hash_probe.py) has checked the inputs: keys int32[n],
// slots_key and slots_row int32[cap], cap a power of two; row_out int32[n]
// and found bool[n] start on 16-byte boundaries.
extern "C" cudaError_t repro_hash_probe(const int32_t* keys, const int32_t* slots_key,
                                        const int32_t* slots_row, int32_t* row_out,
                                        bool* found, int64_t n, int32_t cap,
                                        int max_probes, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(row_out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(found) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(keys) % 16 == 0)
    return launch<true>(keys, slots_key, slots_row, row_out, found, n, cap - 1, max_probes,
                        stream);
  return launch<false>(keys, slots_key, slots_row, row_out, found, n, cap - 1, max_probes,
                       stream);
}
