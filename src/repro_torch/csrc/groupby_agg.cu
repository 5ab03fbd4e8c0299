// Group-by sum: out[g, v] = sum of values[r, v] over rows r with gids[r] == g;
// rows whose gid lies outside [0, G) are dropped.
//
// Replaces the Pallas TPU kernel src/repro/kernels/groupby_agg.py::groupby_sum
// (the reference cuts G above 4096 into several calls, one VMEM accumulator
// each; here one call takes any G, in one of two designs chosen by
// kernels/groupby_agg.py::one_pass).
//
// Bound on H100: bytes.  Each row's gid and V float32 values are read once
// and the (G, V) float32 result written once: Q1 at SF1 (6.0 M rows x 15
// values, G = 128) moves ~384 MB, 114.6 us at 3.35 TB/s; ClickBench q2 at
// 2 M rows (V = 5) 48 MB, 14.3 us.
//
// The register/shared design, for G <= 4096 (kernels/groupby_agg.py picks
// the shapes; one launch a call):
//   * Lanes over columns.  A chunk of cw <= 32 columns (cw = V unless V > 32
//     or G * V doubles exceed the shared budget; further chunks go across
//     blockIdx.y) is spread over W lanes, W the power of two >= cw in
//     4..32; the 32 / W lane groups of a warp take 32 / W consecutive rows
//     at a time, so lane c of a group adds column c of its row, and the
//     lanes that hold one group's row of accumulators never shuffle.
//   * Registers for the first K = 8 groups.  Each lane keeps float64 sums
//     for gids 0..7 in registers, added by unrolled predicated adds (no
//     indexed register array, so nothing spills); a warp-uniform mask of
//     the groups its 16 row steps reach (__reduce_or_sync) skips the
//     groups that are absent, so a value costs one conversion to float64
//     (at a quarter of the DADD rate on this card) and, per group
//     present, a compare and a predicated DADD.  The backend
//     factorizes gids densely from 0, so Q1 (4 live groups) and the
//     one-group ClickBench calls never touch shared memory in the row
//     loop, although the caller passes G = 128.  Gids >= 8 go to a (G, cw)
//     float64 block partial in shared memory through atomicAdd (Q3's
//     4096-group calls).
//   * Bytes in flight.  Each block streams its contiguous slice of rows
//     through a 3-stage ring of tiles in dynamic shared memory, filled by
//     cp.async 16 bytes a thread (4 where gids or values do not start on a
//     16-byte boundary; the last copy zero-fills): a tile is ~32 KB of
//     gids and values (512 rows at V = 15, 1,024 at V = 5), so two tiles,
//     ~64 KB a block, are in flight while the block adds the third.  A
//     warp takes its share of a tile's rows in steps of 32 / W rows, reads
//     16 steps from shared memory, then adds them.  At Q1 a block has 111
//     KB of shared memory (the ring and a 15 KB partial): 2 blocks an SM.
//   * The cross-block merge in the same grid.  At the end the register
//     sums fold into the block partial (a shuffle over the row groups, one
//     shared atomic a lane), and the block adds its nonzero cells to a
//     float64 (G, V) accumulator in device memory with atomicAdd (at Q1
//     60 cells a block, not 1,920).  Then it fences and takes a ticket from
//     its column chunk's counter; the block that draws the last ticket
//     rounds the accumulator once to float32 into out, zeroes it and resets
//     the counter, so the wrapper's per-(device, stream) scratch is zero
//     again for the next launch on that stream.  Skipping zero cells is
//     exact: the accumulator starts at +0.0, and +0.0 + -0.0 is +0.0, as in
//     the plain version.
// Every add is in float64.  Float32 running sums would not do: the
// centred values that core/kernel_backend.py feeds in share one fractional
// part (an integer minus the column mean), so their rounding errors do not
// cancel but add up with the row count, to a few 1e-7 of Q1's sums at SF1
// (measured with float32 block partials on the H100), too close to the
// suite's 1e-6.  The order of the atomic float64 adds varies from run to
// run, so the last bits of a float64 sum may too; the count column is an
// integer below 2^53 and exact whatever the order.  No tensor-core product
// is used, so no TF32 rounding can break the exact hi/lo split the backend
// relies on.
//
// ptxas (sm_90a, -O3; kernels/build.py's log on the H100): 113-115
// registers for each of W = 4, 8, 16, 32, no spill, 16 bytes of static
// shared memory.  Dynamic shared memory (the ring and the partial): Q1's
// call (W = 16) 113,664 bytes, 2 blocks an SM; ClickBench's (W = 8)
// 78,848, 2 an SM (registers); 4096 groups at V = 3 (W = 4) 196,608, 1.
//
// The one-pass design, for G > 4096.  Above 4096 groups a block's (G, cw)
// partial holds at most two columns, so the rows would be read once per
// column chunk, and a block that must take G rows or more (grid_blocks)
// merges about one global atomic a row anyway.  So each row is read once
// and its V values go straight into the (G, V) float64 accumulator in
// device memory: Q13's inner group-by at SF10 (15,321,151 rows, V = 3, G =
// 2^21, 1.5 M live groups) reads 245 MB of rows once and adds into 36 MB
// of live cells, which stay in the 50 MB L2.
//   * A warp takes 32 consecutive rows, one a lane.  Equal gids of the warp
//     find each other with __match_any_sync; where any lane has a peer, a
//     shuffle tree sums each column over the peers in float64 and only the
//     lowest lane of each gid adds (red.global.add.f64), so a hot group
//     costs one atomic a warp and column, not one a row.
//   * A second grid, launched by the same entry point behind the first on
//     the stream, rounds the G x V cells once to float32 into out and
//     zeroes the accumulator for the next launch.
// The numerics are the register/shared design's: every add in float64,
// one rounding, the count column exact, the last bits of a sum varying
// with the order of the atomics.
#include "common.cuh"

namespace {

constexpr int kRegGroups = 8;      // kernels/groupby_agg.py REG_GROUPS
constexpr int kStages = 3;         // kernels/groupby_agg.py STAGES
constexpr int kUnroll = 16;        // row steps read before they are added
constexpr int kWarps = repro::kThreads / 32;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr unsigned kShared = 1u << kRegGroups;   // a gid >= kRegGroups in range
constexpr int kMaxDevices = 64;

// acc += x where gid == k: a compare and a predicated DADD, never a
// divergent branch
__device__ __forceinline__ void add_if(double& acc, double x, int gid, int k) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %2, %3;\n\t@p add.f64 %0, %0, %1;\n\t}"
      : "+d"(acc)
      : "d"(x), "r"(gid), "r"(k));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copy `bytes` (a multiple of 4) from src to the shared dst: 16 bytes a
// copy where both lie on 16-byte boundaries (the last copy zero-fills
// past the end), else 4.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int64_t bytes,
                                           bool aligned) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (aligned) {
    for (int64_t i = threadIdx.x * 16; i < bytes; i += repro::kThreads * 16) {
      const int64_t left = bytes - i;
      cp_async16(d + i, s + i, left < 16 ? static_cast<int>(left) : 16);
    }
  } else {
    for (int64_t i = threadIdx.x * 4; i < bytes; i += repro::kThreads * 4) {
      cp_async4(d + i, s + i);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(repro::kThreads, 2)
groupby_sum_kernel(const int32_t* __restrict__ gids,
                   const float* __restrict__ values, double* __restrict__ acc,
                   int32_t* __restrict__ tickets, float* __restrict__ out,
                   int64_t n, int v, int g, int cw, int64_t rows_per_block,
                   int tile_rows, int part_bytes, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* part = reinterpret_cast<double*>(smem);   // (g, vb) row-major
  unsigned char* ring = smem + part_bytes;          // kStages x (gids, values)
  __shared__ int is_last;
  constexpr int kRowsPerStep = 32 / W;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * cw;
  const int vb = v - c0 < cw ? v - c0 : cw;
  const int cells = g * vb;
  const int64_t stage_bytes = static_cast<int64_t>(tile_rows) * (v + 1) * 4;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const int n_tiles = r1 > r0 ? static_cast<int>((r1 - r0 + tile_rows - 1) / tile_rows) : 0;

  // tile i: rows [r0 + i * tile_rows, ...), gids then the rows' V values
  auto issue = [&](int i) {
    const int64_t row0 = r0 + static_cast<int64_t>(i) * tile_rows;
    const int64_t rows = r1 - row0 < tile_rows ? r1 - row0 : tile_rows;
    unsigned char* st = ring + (i % kStages) * stage_bytes;
    copy_async(st, gids + row0, rows * 4, aligned);
    copy_async(st + static_cast<int64_t>(tile_rows) * 4, values + row0 * v, rows * v * 4,
               aligned);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }
  for (int i = tid; i < cells; i += repro::kThreads) part[i] = 0.0;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = lane % W;
  const int sub = lane / W;
  const bool active = col < vb;
  // each warp's share of a tile, in whole row steps (rows past the tile's
  // are skipped below)
  const int steps = (tile_rows + kWarps * kRowsPerStep - 1) / (kWarps * kRowsPerStep);
  const int warp_rows = steps * kRowsPerStep;

  double reg[kRegGroups];
#pragma unroll
  for (int k = 0; k < kRegGroups; ++k) reg[k] = 0.0;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile it landed
    __syncthreads();                // everyone's did, and tile it - 1 is done
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();

    const unsigned char* st = ring + (it % kStages) * stage_bytes;
    const int32_t* sg = reinterpret_cast<const int32_t*>(st);
    const float* sv = reinterpret_cast<const float*>(st + static_cast<int64_t>(tile_rows) * 4) +
                      c0 + col;
    const int64_t left = r1 - (r0 + static_cast<int64_t>(it) * tile_rows);
    const int rows = left < tile_rows ? static_cast<int>(left) : tile_rows;
    const int row_base = warp * warp_rows + sub;
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      int32_t gid[kUnroll];
      float x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = row_base + (s0 + u) * kRowsPerStep;
        const bool ok = s0 + u < steps && row < rows;
        gid[u] = ok ? sg[row] : -1;
        x[u] = ok && active ? sv[row * v] : 0.f;
      }
      // which register groups, and whether the shared partial, these rows
      // reach: one warp-uniform mask, so that each add below runs only for
      // the groups present (4 at Q1, 1 on ClickBench)
      // (a gid outside [0, 8) sets kShared; that loop drops what is out
      // of range)
      unsigned bits = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bits |= 1u << min(static_cast<unsigned>(gid[u]), static_cast<unsigned>(kRegGroups));
      }
      bits = __reduce_or_sync(kFullWarp, bits);
      double xd[kUnroll];   // each value converted once
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) xd[u] = static_cast<double>(x[u]);
#pragma unroll
      for (int k = 0; k < kRegGroups; ++k) {
        if (bits & (1u << k)) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) add_if(reg[k], xd[u], gid[u], k);
        }
      }
      if (bits & kShared) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int32_t gg = gid[u];
          if (gg >= kRegGroups && gg < g && active) {
            atomicAdd(part + gg * vb + col, xd[u]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // part's zeroing is seen by every thread (no tile: here)

  // fold the register sums into the block partial: the row groups of a
  // warp hold the same columns, so a shuffle over them leaves one sum a
  // column on the lanes of row group 0
#pragma unroll
  for (int k = 0; k < kRegGroups; ++k) {
    double s = reg[k];
#pragma unroll
    for (int off = W; off < 32; off <<= 1) s += __shfl_xor_sync(kFullWarp, s, off);
    if (k < g && sub == 0 && active && s != 0.0) atomicAdd(part + k * vb + col, s);
  }
  __syncthreads();

  for (int i = tid; i < cells; i += repro::kThreads) {
    const double s = part[i];
    if (s != 0.0) {
      const int gg = i / vb;
      atomicAdd(acc + static_cast<int64_t>(gg) * v + c0 + (i - gg * vb), s);
    }
  }

  // the last block of this column chunk to finish rounds the sums
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + blockIdx.y, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < cells; i += repro::kThreads) {
    const int gg = i / vb;
    const int64_t at = static_cast<int64_t>(gg) * v + c0 + (i - gg * vb);
    out[at] = static_cast<float>(__ldcg(acc + at));
    acc[at] = 0.0;   // ready for the next launch on this stream
  }
  if (tid == 0) tickets[blockIdx.y] = 0;
}

// x summed over this lane's peers (the lanes of its warp with the same
// gid) on the lowest of them; `above` holds the peers above this lane and
// `rank` its rank among its peers.  A tree: each round every lane adds the
// next peer still in play, and the odd ranks leave.
__device__ __forceinline__ double sum_peers(double x, unsigned above, int rank) {
  while (__any_sync(kFullWarp, above != 0)) {
    const int next = __ffs(above);   // 1 + the next peer's lane, 0 if none
    const double t = __shfl_sync(kFullWarp, x, next > 0 ? next - 1 : 0);
    if (next > 0) x += t;
    above &= __ballot_sync(kFullWarp, (rank & 1) == 0);
    rank >>= 1;
  }
  return x;
}

__global__ void __launch_bounds__(repro::kThreads, 4)
groupby_sum_wide_kernel(const int32_t* __restrict__ gids,
                        const float* __restrict__ values, double* __restrict__ acc,
                        int64_t n, int v, int g) {
  const unsigned lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * repro::kThreads;
  // warp-uniform bounds, so that every lane takes part in the warp's votes
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * repro::kThreads +
                      (threadIdx.x & ~31u);
       base < n; base += stride) {
    const int64_t row = base + lane;
    int32_t gid = row < n ? __ldg(gids + row) : -1;
    if (static_cast<unsigned>(gid) >= static_cast<unsigned>(g)) gid = -1;   // dropped
    const unsigned peers = __match_any_sync(kFullWarp, gid);
    const unsigned below = peers & ((1u << lane) - 1u);
    const unsigned above = peers & ~below & ~(1u << lane);
    const int rank = __popc(below);
    const bool lead = below == 0 && gid >= 0;
    const bool shared = __any_sync(kFullWarp, above != 0);
    const float* src = values + row * v;
    double* dst = acc + static_cast<int64_t>(gid) * v;
    for (int c = 0; c < v; ++c) {
      double x = gid >= 0 ? static_cast<double>(__ldg(src + c)) : 0.0;
      if (shared) x = sum_peers(x, above, rank);
      if (lead) atomicAdd(dst + c, x);
    }
  }
}

// out = the accumulator rounded once to float32; the accumulator zeroed
__global__ void __launch_bounds__(repro::kThreads)
groupby_sum_finish_kernel(double* __restrict__ acc, float* __restrict__ out,
                          int64_t cells) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * repro::kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * repro::kThreads + threadIdx.x;
       i < cells; i += stride) {
    out[i] = static_cast<float>(acc[i]);
    acc[i] = 0.0;
  }
}

template <int W>
cudaError_t launch(const int32_t* gids, const float* values, double* acc,
                   int32_t* tickets, float* out, int64_t n, int v, int g,
                   int n_blocks, int cw, int64_t rows_per_block, int tile_rows,
                   int part_bytes, int smem_bytes, bool aligned, cudaStream_t stream) {
  // raise the kernel's dynamic shared memory limit only when a launch
  // needs more than this device allows it so far (the call costs host time)
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || allowed[device] < smem_bytes) {
    err = cudaFuncSetAttribute(groupby_sum_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) allowed[device] = smem_bytes;
  }
  const dim3 grid(n_blocks, (v + cw - 1) / cw);
  groupby_sum_kernel<W><<<grid, repro::kThreads, smem_bytes, stream>>>(
      gids, values, acc, tickets, out, n, v, g, cw, rows_per_block, tile_rows,
      part_bytes, aligned);
  return cudaGetLastError();
}

}  // namespace

// The wrapper (kernels/groupby_agg.py) has checked the shapes: n >= 1.
// finish_blocks > 0 takes the one-pass design: n_blocks blocks over the
// rows, then finish_blocks blocks over the g * v cells (the register/shared
// design's arguments, from cw to aligned, are not read).  Else
// 1 <= cw <= min(v, 32), lane_width the power of two >= cw in 4..32,
// tile_rows a multiple of 8 * 32 / lane_width, rows_per_block a multiple
// of 4, part_bytes = g * cw * 8 rounded up to 16, smem_bytes = part_bytes
// + 3 * tile_rows * (v + 1) * 4 within the card's 227 KB; aligned says
// that gids and values start on 16-byte boundaries.  acc holds g * v
// float64 zeros and tickets ceil(v / cw) int32 zeros; every launch leaves
// both at zero.
extern "C" cudaError_t repro_groupby_sum(const int32_t* gids, const float* values,
                                         double* acc, int32_t* tickets, float* out,
                                         int64_t n, int v, int g, int n_blocks,
                                         int cw, int64_t rows_per_block,
                                         int lane_width, int tile_rows, int part_bytes,
                                         int smem_bytes, int aligned,
                                         int finish_blocks, cudaStream_t stream) {
  if (finish_blocks > 0) {
    groupby_sum_wide_kernel<<<n_blocks, repro::kThreads, 0, stream>>>(gids, values, acc,
                                                                      n, v, g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    groupby_sum_finish_kernel<<<finish_blocks, repro::kThreads, 0, stream>>>(
        acc, out, static_cast<int64_t>(g) * v);
    return cudaGetLastError();
  }
#define REPRO_GROUPBY_LAUNCH(W)                                                     \
  return launch<W>(gids, values, acc, tickets, out, n, v, g, n_blocks, cw,         \
                   rows_per_block, tile_rows, part_bytes, smem_bytes, aligned != 0, \
                   stream)
  switch (lane_width) {
    case 4:
      REPRO_GROUPBY_LAUNCH(4);
    case 8:
      REPRO_GROUPBY_LAUNCH(8);
    case 16:
      REPRO_GROUPBY_LAUNCH(16);
    case 32:
      REPRO_GROUPBY_LAUNCH(32);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_GROUPBY_LAUNCH
}
