// Group-by sum: out[g, v] = sum of values[r, v] over rows r with gids[r] == g;
// rows whose gid lies outside [0, G) are dropped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/groupby_agg.py::groupby_sum
// (reached through kernels/ops.py::groupby_sum_large, which cuts G above
// 4096 into several calls).
//
// Bound on H100: bytes.  Each row's gid and V float32 values are read once
// (Q1 at SF1: 6.0 M rows x 15 values, ~384 MB, ~115 us); one add per value
// is far below the card's arithmetic rate.
//
// Design.  The TPU version ran one sequential grid that carried a single
// accumulator through a one-hot matrix product.  Hopper's blocks run in no
// order and carry nothing between them, so this is two kernels:
//   1. each block sums one contiguous slice of the rows into a (G, Vb)
//      float64 partial in shared memory, then writes it to device memory.
//      Inside a warp, the lanes that hold the same group are first summed
//      with shuffles (one round per distinct group in the warp), so one lane
//      per group and column adds to shared memory: few groups (Q1 has four)
//      would otherwise put 32 lanes on one address.  When G * V doubles
//      exceed the shared budget, V is cut into chunks of Vb columns across
//      blockIdx.y;
//   2. one thread per (g, v) adds the partials over the blocks, in block
//      order, in float64, and rounds once to float32.
// Every add is in float64.  Float32 running sums would not do: the
// centred values that core/kernel_backend.py feeds in share one fractional
// part (an integer minus the column mean), so their rounding errors do not
// cancel but add up with the row count, to a few 1e-7 of Q1's sums at SF1
// (measured with float32 block partials on the H100), too close to the
// suite's 1e-6.  Across warps the order of the shared-memory adds varies
// from run to run, so the last bits of a float64 partial may too.  No
// tensor-core product is used, so no TF32 rounding can break the exact
// hi/lo split the backend relies on.
#include "common.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ double warp_sum(double x) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(kFullWarp, x, offset);
  }
  return x;
}

__global__ void groupby_partial_kernel(const int32_t* __restrict__ gids,
                                       const float* __restrict__ values,
                                       double* __restrict__ partials,
                                       int64_t n, int v, int g, int v_chunk) {
  extern __shared__ double acc[];  // (g, vb) row-major
  const int v0 = blockIdx.y * v_chunk;
  const int vb = v - v0 < v_chunk ? v - v0 : v_chunk;
  const int cells = g * vb;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t per_block = (n + gridDim.x - 1) / gridDim.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t r1 = r0 + per_block < n ? r0 + per_block : n;
  // the bounds are the same for every thread, so whole warps reach the
  // shuffles together
  for (int64_t base = r0; base < r1; base += blockDim.x) {
    const int64_t r = base + threadIdx.x;
    int32_t gid = -1;
    if (r < r1) {
      gid = gids[r];
      if (gid >= g) gid = -1;  // out of range: dropped
    }
    const float* row = values + r * v + v0;
    unsigned todo = __ballot_sync(kFullWarp, gid >= 0);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const int32_t group = __shfl_sync(kFullWarp, gid, leader);
      const bool mine = gid == group;
      for (int j = 0; j < vb; ++j) {
        const double x = warp_sum(mine ? static_cast<double>(row[j]) : 0.0);
        if (lane == leader) atomicAdd(acc + group * vb + j, x);
      }
      todo &= ~__ballot_sync(kFullWarp, mine);
    }
  }
  __syncthreads();

  double* out = partials + static_cast<int64_t>(blockIdx.x) * g * v;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int gg = i / vb, j = i - gg * vb;
    out[gg * v + v0 + j] = acc[i];
  }
}

__global__ void groupby_merge_kernel(const double* __restrict__ partials,
                                     float* __restrict__ out, int n_blocks,
                                     int cells) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += partials[static_cast<int64_t>(b) * cells + i];
  out[i] = static_cast<float>(s);
}

}  // namespace

// partials must hold n_blocks * g * v doubles; smem_bytes = g * v_chunk * 8.
extern "C" cudaError_t repro_groupby_sum(const int32_t* gids, const float* values,
                                         double* partials, float* out, int64_t n,
                                         int v, int g, int n_blocks, int v_chunk,
                                         int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      groupby_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (v + v_chunk - 1) / v_chunk);
  groupby_partial_kernel<<<grid, repro::kThreads, smem_bytes, stream>>>(
      gids, values, partials, n, v, g, v_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cells = g * v;
  groupby_merge_kernel<<<repro::grid_for(cells), repro::kThreads, 0, stream>>>(
      partials, out, n_blocks, cells);
  return cudaGetLastError();
}
