// Open-addressing hash-join probe: for each int32 key, the build row stored
// under it, or -1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hash_probe.py::hash_probe.
//
// Table: slots_key / slots_row int32[cap], cap a power of two, built by
// kernels/hash_probe.py::build_table32 with the same hash.  The hash is
// h = key * 0x9E3779B9 in wrapping 32-bit arithmetic, then h ^ (h >> 15)
// with an arithmetic shift, masked to cap.  Linear probing stops at the
// key, at an empty slot (row -1), or after max_probes rounds.
//
// Bound on H100: bytes.  Each key is read once and a row and a flag written
// once (9 bytes a key); the table is read at random but is small enough to
// stay in the 50 MB L2 (Q3 at SF1: 3.0 M keys into a 2^19-slot table,
// ~32 MB in all, ~9 us).
//
// Design: one thread per probe key, the table read through L2 (the TPU kept
// it whole in VMEM; here no shared-memory copy is needed because L2 holds
// it).  A thread leaves its loop as soon as its chain ends, instead of
// running the TPU's fixed rounds.  The multiply is done on uint32_t, since
// signed overflow is undefined in C++, and cast back before the shift.
#include "common.cuh"

namespace {

__global__ void hash_probe_kernel(const int32_t* __restrict__ keys,
                                  const int32_t* __restrict__ slots_key,
                                  const int32_t* __restrict__ slots_row,
                                  int32_t* __restrict__ row_out,
                                  bool* __restrict__ found,
                                  int64_t n, int32_t cap, int max_probes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * repro::kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t key = keys[i];
  const int32_t mask = cap - 1;
  int32_t h = static_cast<int32_t>(static_cast<uint32_t>(key) * 0x9E3779B9u);
  h = h ^ (h >> 15);  // arithmetic shift of a signed int32, as in jnp
  const int32_t h0 = h & mask;
  int32_t row = -1;
  for (int p = 0; p < max_probes; ++p) {
    const int32_t cand = (h0 + p) & mask;
    const int32_t r = slots_row[cand];
    if (r == -1) break;  // empty slot: the key is absent
    if (slots_key[cand] == key) {
      row = r;
      break;
    }
  }
  row_out[i] = row;
  found[i] = row >= 0;
}

}  // namespace

extern "C" cudaError_t repro_hash_probe(const int32_t* keys, const int32_t* slots_key,
                                        const int32_t* slots_row, int32_t* row_out,
                                        bool* found, int64_t n, int32_t cap,
                                        int max_probes, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  hash_probe_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(
      keys, slots_key, slots_row, row_out, found, n, cap, max_probes);
  return cudaGetLastError();
}
