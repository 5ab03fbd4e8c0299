// Hash-join run expansion: output position j belongs to the probe row p
// whose run [ends[p] - counts_out[p], ends[p]) covers j; it gathers build
// row order[lo[p] + (j - run start)].
//
// Replaces the Pallas TPU kernel src/repro/kernels/join_expand.py::join_expand
// (the device version of relational/join.py::_join_expand).
//
// Bound on H100: bytes.  The function must read counts_out once (for the
// prefix sum the wrapper takes), write two int64 indices and a flag per
// output position (17 bytes), and read lo, counts and order once per real
// output.  The binary search's top levels are shared by every thread, so
// they stay in L1 and L2.
//
// Design: one thread per output position, each binary-searching the int64
// inclusive prefix sums `ends` of the n real runs for the first end > j
// (the TPU version searched a whole tile of positions per grid step over
// int32 sums padded to its 1024-row tile; nothing here needs the padding).
// Positions past the true total (the bucket's filler) land on the last run,
// as the plain version's padding does.  lo and counts are read in place at
// the run found, and the gather order[pos] is done in the kernel, so the
// positions never go back to device memory.
#include "common.cuh"

namespace {

__global__ void join_expand_kernel(const int64_t* __restrict__ ends,
                                   const int64_t* __restrict__ lo,
                                   const int64_t* __restrict__ counts,
                                   const int64_t* __restrict__ order,
                                   int64_t* __restrict__ probe_idx,
                                   int64_t* __restrict__ build_idx,
                                   bool* __restrict__ matched,
                                   int64_t n, int64_t nb, int64_t total) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * repro::kThreads + threadIdx.x;
  if (j >= total) return;
  int64_t low = 0, high = n;  // the first p with ends[p] > j lies in [low, high]
  while (low < high) {
    const int64_t mid = low + (high - low) / 2;
    if (ends[mid] <= j) {
      low = mid + 1;
    } else {
      high = mid;
    }
  }
  const int64_t p = low < n ? low : n - 1;  // filler past the total
  const int64_t intra = j - (p > 0 ? ends[p - 1] : 0);
  const bool m = counts[p] > 0;
  int64_t pos = 0;
  if (m) {
    pos = lo[p] + intra;
    pos = pos < 0 ? 0 : (pos > nb - 1 ? nb - 1 : pos);
  }
  probe_idx[j] = p;
  build_idx[j] = order[pos];
  matched[j] = m;
}

}  // namespace

extern "C" cudaError_t repro_join_expand(const int64_t* ends, const int64_t* lo,
                                         const int64_t* counts, const int64_t* order,
                                         int64_t* probe_idx, int64_t* build_idx,
                                         bool* matched, int64_t n, int64_t nb,
                                         int64_t total, cudaStream_t stream) {
  if (total == 0) return cudaSuccess;
  join_expand_kernel<<<repro::grid_for(total), repro::kThreads, 0, stream>>>(
      ends, lo, counts, order, probe_idx, build_idx, matched, n, nb, total);
  return cudaGetLastError();
}
