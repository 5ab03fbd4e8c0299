// Count distinct per group: counts[g] = the number of distinct values among
// the rows whose gid is g; rows whose gid lies outside [0, G) are dropped.
//
// Replaces no TPU kernel: the JAX package counts distinct values by sorting
// (group, value) pairs, and so did the port, with two stable sorts of the
// pairs, their gathers and an int64 index_add_ of one flag a row.  On
// ClickBench's hits at 99,997,497 rows those sorts were the largest
// operator of the benchmark's cell (q4, q5, q8-q11, q13 and q22), so the
// pairs are counted here in one pass with an exact device hash set.
//
// Bound on H100: bytes.  The function reads each row's int32 gid and int64
// value once and writes the (G,) int64 counts once: q4 (99,997,497 rows,
// one group) reads 1.2 GB, 0.36 ms at 3.35 TB/s.  The design adds its
// table (the wrapper's fill of 2^28 16-byte slots, 4.3 GB for q4) and one
// random slot access a row.
//
// Design (kernels/count_distinct.py sizes the table and the grid, and
// fills the table with 0xff bytes and the counts with zeros before the
// launch; one grid a call):
//   * The table.  An open-addressing set of 16-byte slots (int64 value,
//     int32 gid tag), a power of two of them, at least twice the rows: no
//     more pairs than rows can be distinct, so it never fills and linear
//     probing always ends.  A slot no pair has claimed has the tag kEmpty
//     (all bytes 0xff, the wrapper's fill).  Exact: the slot holds
//     the whole pair, with no fingerprint, and equality is on both halves,
//     so every int64 value (-1, both ends of the range) is a value.
//   * One row a lane, a grid stride over the rows.  Lanes of a warp that
//     hold the same (gid, value) find each other with __match_any_sync,
//     and only the lowest of them inserts: a hot pair costs one insert a
//     warp.
//   * Insertion reads before it writes.  A lane reads the tag of the pair's
//     slot (splitmix64 of the value and the gid) with acquire semantics: a
//     gid tag with an equal value is a duplicate, another pair sends it to
//     the next slot, and only an empty slot takes an atomic.  So the
//     duplicates of a hot pair, most of q4's rows, cost one load that hits
//     L2 and no atomic.
//   * A claim word and a publish step make a pair appear whole or not at
//     all.  The lane that wins the empty tag (atomicCAS kEmpty -> kBusy)
//     writes the value, then publishes its gid in the tag with release
//     semantics; a lane that reads kBusy reads the tag again until the gid
//     is there, and only then reads the value.  A tag goes kEmpty -> kBusy
//     -> gid once, so no pair is inserted twice.
//   * Counting.  A lane that inserted a pair adds one to its group's count;
//     the inserting lanes of a warp with equal gids find each other with
//     __match_any_sync and the lowest adds their number, so q4's single
//     group takes about one atomic a warp that found new pairs.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlocksPerSm = 8;   // kernels/count_distinct.py BLOCKS_PER_SM
constexpr int kEmpty = -1;        // the tag of a slot no pair has claimed
constexpr int kBusy = -2;         // the tag of a slot whose value is being written

struct alignas(16) Slot {
  long long value;
  int tag;  // kEmpty, kBusy or the pair's gid
  int unused;
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long load_relaxed(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(long long* p, long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// the first slot of (gid, value): splitmix64's finalizer over the value
// mixed with the gid
__device__ __forceinline__ uint64_t first_slot(int gid, long long value, uint64_t mask) {
  uint64_t x = static_cast<uint64_t>(value) ^
               (static_cast<uint64_t>(static_cast<uint32_t>(gid)) * 0x9e3779b97f4a7c15ull);
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x & mask;
}

// true where this call put (gid, value) into the table, false where it
// found the pair there
__device__ bool insert(Slot* table, uint64_t mask, int gid, long long value) {
  uint64_t i = first_slot(gid, value, mask);
  for (;;) {
    Slot* s = table + i;
    const int tag = load_acquire(&s->tag);
    if (tag == kEmpty) {
      if (atomicCAS(&s->tag, kEmpty, kBusy) == kEmpty) {
        store_relaxed(&s->value, value);
        store_release(&s->tag, gid);
        return true;
      }
      continue;  // claimed meanwhile: read the tag again
    }
    if (tag == kBusy) continue;  // its value is on the way
    if (tag == gid && load_relaxed(&s->value) == value) return false;
    i = (i + 1) & mask;
  }
}

__global__ void __launch_bounds__(repro::kThreads, kBlocksPerSm)
count_distinct_insert_kernel(const int32_t* __restrict__ gids,
                             const long long* __restrict__ values, Slot* table,
                             unsigned long long* counts, int64_t n, int g, uint64_t mask) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * repro::kThreads;
  // warp-uniform bounds, so that every lane takes part in the warp's votes
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * repro::kThreads +
                      (threadIdx.x & ~31u);
       base < n; base += stride) {
    const int64_t row = base + lane;
    int gid = row < n ? __ldg(gids + row) : -1;
    if (static_cast<unsigned>(gid) >= static_cast<unsigned>(g)) gid = -1;  // dropped
    const long long value = gid >= 0 ? __ldg(values + row) : 0;
    const unsigned same = __match_any_sync(kFull, gid) &
                          __match_any_sync(kFull, static_cast<unsigned long long>(value));
    const bool fresh = gid >= 0 && (same & below) == 0 && insert(table, mask, gid, value);
    const unsigned peers = __match_any_sync(kFull, fresh ? gid : -1);
    if (fresh && (peers & below) == 0) {
      atomicAdd(counts + gid, static_cast<unsigned long long>(__popc(peers)));
    }
  }
}

}  // namespace

// The wrapper (kernels/count_distinct.py) has checked the shapes and filled
// the buffers: n >= 1, 1 <= g, n_slots a power of two >= 2 n; table holds
// n_slots 16-byte slots, every byte 0xff, and counts g zeros.
extern "C" cudaError_t repro_count_distinct(const int32_t* gids, const long long* values,
                                            void* table, unsigned long long* counts,
                                            int64_t n, int g, int64_t n_slots, int blocks,
                                            cudaStream_t stream) {
  count_distinct_insert_kernel<<<blocks, repro::kThreads, 0, stream>>>(
      gids, values, static_cast<Slot*>(table), counts, n, g,
      static_cast<uint64_t>(n_slots - 1));
  return cudaGetLastError();
}
