// Fused conjunctive range filter: mask[r] = AND_c (lo[c] <= x[r, c] <= hi[c]),
// plus the number of selected rows in each 2048-row tile.
//
// Replaces the Pallas TPU kernel src/repro/kernels/filter_count.py::
// filter_mask_counts (reached through kernels/ops.py::filter_select).
//
// Bound on H100: bytes.  Each row is read once (C float32) and its mask byte
// written once, about 2 operations per value; at 3.35 TB/s the memory rate,
// not the arithmetic, sets the floor (Q6 at SF1: 6.0 M rows x 4 columns,
// ~102 MB, ~30 us).
//
// Design: one thread per row, looping over the C columns, so neighbouring
// threads read neighbouring rows of the row-major (N, C) matrix and the
// loads coalesce.  The tile counts come from a block-wide
// __syncthreads_count and one integer atomic per block (256 divides 2048,
// so a block never straddles a tile); integer atomics are order-free, so the
// counts are exact.  Rows past N are never read, unlike the TPU version,
// which pads with +inf and so counts padding rows when hi = +inf.
#include "common.cuh"

namespace {

constexpr int kTile = 2048;

__global__ void filter_mask_counts_kernel(const float* __restrict__ cols,
                                          const float* __restrict__ lo,
                                          const float* __restrict__ hi,
                                          bool* __restrict__ mask,
                                          int32_t* __restrict__ counts,
                                          int64_t n, int c) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * repro::kThreads + threadIdx.x;
  bool pass = false;
  if (row < n) {
    pass = true;
    const float* x = cols + row * c;
    for (int j = 0; j < c; ++j) {
      const float v = x[j];
      pass = pass && (v >= lo[j]) && (v <= hi[j]);
    }
    mask[row] = pass;
  }
  const int selected = __syncthreads_count(pass);
  if (threadIdx.x == 0 && selected > 0) {
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * repro::kThreads / kTile;
    atomicAdd(&counts[tile], selected);
  }
}

}  // namespace

// counts must hold ceil(n / 2048) zeros on entry.
extern "C" cudaError_t repro_filter_mask_counts(const float* cols, const float* lo,
                                                const float* hi, bool* mask,
                                                int32_t* counts, int64_t n, int c,
                                                cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  filter_mask_counts_kernel<<<repro::grid_for(n), repro::kThreads, 0, stream>>>(
      cols, lo, hi, mask, counts, n, c);
  return cudaGetLastError();
}
