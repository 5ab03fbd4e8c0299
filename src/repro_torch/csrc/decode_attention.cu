// Single-token GQA decode attention over a KV cache: for each batch row b
// and query head, softmax(q . k_s / sqrt(D)) over the cache positions
// s < lengths[b], applied to v, in float32, written in q's dtype.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention.py::decode_attention, with the
// semantics of its plain version (repro/kernels/ref.py::
// decode_attention_ref, which the reference's attention_decode computes):
// lengths[b] >= S attends all S rows, and lengths[b] <= 0 gives the uniform
// mean of v over all S rows.  The Pallas kernel pads S to 512-row blocks
// with zero rows and differs at both edges.
//
// Layouts: q (B,H,D), k and v (B,S,KVH,D), out (B,H,D), all contiguous,
// bf16 or float32; lengths (B,) int32 read on the device.  Query head
// kh*G + i (G = H/KVH) attends KV head kh.
//
// Bound on H100: bytes.  Each valid k and v row is read once (2*D bytes a
// row in bf16; only v where lengths <= 0), for 4*G*D float32 operations a
// row, far below the operation bound.  So the design is about keeping
// enough bytes in flight on every SM.
//
// Design (split-S flash decoding): each (b, KV head, chunk of up to GMAX
// of its G query heads) is a unit whose cache rows split over n_split
// blocks, which the wrapper (kernels/decode_attention.py) picks from B,
// KVH, G, S and the SM count, never from lengths: about 4 blocks an SM.
// The grid is one-dimensional with the split index fastest, so that the
// blocks the scheduler places together on an SM belong to different units
// (with (B, ., n_split) ordering and B dividing 132, every SM got four
// blocks of one batch row, and the rows differ in length).  Row b attends
// L_b rows (S where lengths[b] <= 0, else min(lengths[b], S)); split j
// covers rows [j*c_b, min((j+1)*c_b, L_b)) with c_b = ceil(L_b / n_split)
// rounded up to a tile.  A block streams its rows of one KV head through a
// 3-stage ring of 16 KB tiles (k and v) in dynamic shared memory, filled by
// cp.async 16 bytes a thread (rows past the split and columns past D are
// zero-filled), so two tiles are in flight while it computes on the third.
// Its 128 threads form row groups of DP/8 threads; each thread holds 8
// elements of a row (one 16-byte vector in bf16, two in float32) and the
// unit's query rows, scaled by log2(e)/sqrt(D), in registers, so each k and
// v row is read once for all of them.  A q . k dot product reduces over the
// row group by warp shuffle; each row group keeps its own running max, sum
// and float32 accumulator (online softmax in base 2, exp2f, over its rows
// of each tile, rescaling only when the max moves) on the CUDA cores.
// Scores and probabilities stay float32 and p . v adds in float32:
// rounding either to bf16 fails chip_smoke.py's half-ulp check.  At the
// end the row groups merge in shared memory, in order, into the block's
// partial (m, l, acc[D]) per query head.
//
// Combine: with n_split > 1 each block writes its partial in float32 to
// the wrapper's scratch (acc as (B,H,n_split,D), then (m, l) as
// (B,H,n_split,2): B*H*n_split*(D+2) floats; an empty split writes m =
// -inf, l = 0, acc = 0), fences, and takes a ticket from its unit's int32
// counter with atomicAdd.  The block that draws the last ticket combines
// the n_split partials in split order (so the same input gives bitwise the
// same output on every call, whichever block finishes last), writes the
// output, rounded once, and resets the counter to 0 for the next launch on
// the stream.  One launch per call.
//
// ptxas (sm_90a, -O3, -Xptxas -v in kernels/build.py's log): the main
// path's instantiation, bf16 with DP = 128 and GMAX = 3 (llama3.2-3b's 24
// query and 8 KV heads of 128), uses 119 registers, no spill and 49,152
// bytes of dynamic shared memory (the ring; no static shared memory), so
// 4 blocks fit an SM.  The float32 group-7 shape's (DP = 64, GMAX = 8)
// uses 222 registers, no spill: 2 blocks an SM.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;        // 4 warps a block
constexpr int kStages = 3;           // tiles in the ring
constexpr int kStageBytes = 16384;   // one tile of k and one of v
constexpr int kRing = kStages * kStageBytes;  // 48 KB: no opt-in needed
constexpr int kMaxSplits = 64;       // kernels/decode_attention.py MAX_SPLITS
constexpr unsigned kFullMask = 0xffffffffu;

// Shapes that follow from the element type and the padded head dim DP
// (64, 128 or 256): each thread holds 8 elements of a row.
template <typename T, int DP>
struct Cfg {
  static constexpr int kTpr = DP / 8;                // threads a row
  static constexpr int kGroups = kThreads / kTpr;    // row groups
  static constexpr int kRpt = 8 / sizeof(T);         // rows a thread a tile
  static constexpr int kTile = kRpt * kGroups;       // rows a tile
  static constexpr int kChunksPerRow = DP * sizeof(T) / 16;
  static_assert(2 * kTile * DP * sizeof(T) == kStageBytes, "tile size");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Element e (0..7) of the 8 that row lane c holds: c*8+e in bf16 (one
// 16-byte vector); in float32 two vectors, c*4.. and DP/2 + c*4.., so
// that neighbouring lanes read neighbouring 16 bytes.
template <typename T, int DP>
__device__ __forceinline__ int elem(int c, int e) {
  if constexpr (sizeof(T) == 2) {
    return c * 8 + e;
  } else {
    return (e >> 2) * (DP / 2) + c * 4 + (e & 3);
  }
}

// The 8 elements of lane c of a row as float.  With check, vectors at or
// past d read as zero (a vector lies wholly below or above d, since d is
// a multiple of 16); shared-memory rows are zero-filled there already.
template <typename T, int DP, bool kCheck>
__device__ __forceinline__ void load8(const T* row, int c, int d,
                                      float (&x)[8]) {
  if constexpr (sizeof(T) == 2) {
    if (kCheck && c * 8 >= d) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
      return;
    }
    const uint4 u = *reinterpret_cast<const uint4*>(row + c * 8);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> float is the 16 bits placed high; element 0 is low
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = h * (DP / 2) + c * 4;
      if (kCheck && at >= d) {
        x[4 * h] = x[4 * h + 1] = x[4 * h + 2] = x[4 * h + 3] = 0.f;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(row + at);
        x[4 * h] = f.x;
        x[4 * h + 1] = f.y;
        x[4 * h + 2] = f.z;
        x[4 * h + 3] = f.w;
      }
    }
  }
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (src is
// then not read, but stays a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Issue the copies of one tile: rows [row0, row0 + nrows) of k (unless
// skipped) and v into sk and sv ([kTile][DP] each).
template <typename T, int DP>
__device__ __forceinline__ void issue_tile(T* sk, T* sv, const T* kb,
                                           const T* vb, int64_t row_stride,
                                           int row0, int nrows, int d,
                                           bool with_k) {
  using C = Cfg<T, DP>;
  constexpr int kPerChunk = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int kIters = C::kTile * C::kChunksPerRow / kThreads;
  static_assert(kIters * kThreads == C::kTile * C::kChunksPerRow, "chunks");
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / C::kChunksPerRow;
    const int col = (i % C::kChunksPerRow) * kPerChunk;
    const bool ok = r < nrows && col < d;
    const int64_t off = ok ? static_cast<int64_t>(row0 + r) * row_stride + col : 0;
    if (with_k) cp_async16(sk + r * DP + col, kb + off, ok);
    cp_async16(sv + r * DP + col, vb + off, ok);
  }
}

template <typename T, int DP, int GMAX>
__global__ void __launch_bounds__(kThreads, GMAX <= 4 ? 4 : 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part,
                        int32_t* __restrict__ tickets, int batch, int s_len,
                        int h, int kvh, int d, int n_split, float q_scale) {
  using C = Cfg<T, DP>;
  extern __shared__ __align__(16) unsigned char smem[];

  // the block's (b, KV head, chunk) "unit" and split; the split index runs
  // fastest, so that the blocks the scheduler places on one SM belong to
  // different units (and rows of different lengths)
  const int groups = h / kvh;
  const int chunks = (groups + GMAX - 1) / GMAX;
  const int split = static_cast<int>(blockIdx.x % n_split);
  const int64_t unit = blockIdx.x / n_split;
  const int b = static_cast<int>(unit / (kvh * chunks));
  const int y = static_cast<int>(unit % (kvh * chunks));
  const int kh = y / chunks;
  const int g0 = (y % chunks) * GMAX;
  const int gn = min(GMAX, groups - g0);    // query heads of this block
  const int tid = threadIdx.x;
  const int c = tid % C::kTpr;              // lane within the row
  const int rg = tid / C::kTpr;             // row group

  // this split's rows [r0, r1)
  const int len = lengths[b];
  const bool uniform = len <= 0;            // every position masked: mean of v
  const int rows = uniform ? s_len : min(len, s_len);
  int64_t per = (static_cast<int64_t>(rows) + n_split - 1) / n_split;
  per = (per + C::kTile - 1) / C::kTile * C::kTile;
  const int r0 = static_cast<int>(min(static_cast<int64_t>(split) * per,
                                      static_cast<int64_t>(rows)));
  const int r1 = static_cast<int>(min(r0 + per, static_cast<int64_t>(rows)));
  const int n_tiles = (r1 - r0 + C::kTile - 1) / C::kTile;

  // q carries log2(e)/sqrt(D), so scores come out in base 2 (exp2f below)
  const int head0 = kh * groups + g0;
  const int64_t q_base = (static_cast<int64_t>(b) * h + head0) * d;
  float qr[GMAX][8], acc[GMAX][8], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < gn) {
      load8<T, DP, true>(q + q_base + static_cast<int64_t>(g) * d, c, d, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[g][e] *= q_scale;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(kvh) * d;
  const int64_t kv_base = (static_cast<int64_t>(b) * s_len * kvh + kh) * d;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  T* ring = reinterpret_cast<T*>(smem);
  constexpr int kStageElems = 2 * C::kTile * DP;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) {
      const int row0 = r0 + st * C::kTile;
      issue_tile<T, DP>(ring + st * kStageElems,
                        ring + st * kStageElems + C::kTile * DP, kb, vb,
                        row_stride, row0, min(C::kTile, r1 - row0), d, !uniform);
    }
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int ahead = it + kStages - 1;
    if (ahead < n_tiles) {
      const int st = ahead % kStages;
      const int row0 = r0 + ahead * C::kTile;
      issue_tile<T, DP>(ring + st * kStageElems,
                        ring + st * kStageElems + C::kTile * DP, kb, vb,
                        row_stride, row0, min(C::kTile, r1 - row0), d, !uniform);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // this thread's copies of tile it landed
    __syncthreads();                // everyone's did

    const T* sk = ring + (it % kStages) * kStageElems;
    const T* sv = sk + C::kTile * DP;
    const int valid = min(C::kTile, r1 - (r0 + it * C::kTile));
    // scores of this thread's rows rg + i*kGroups (zero-filled rows past
    // the split give 0 and are masked below)
    float sc[C::kRpt][GMAX];
#pragma unroll
    for (int i = 0; i < C::kRpt; ++i) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sc[i][g] = 0.f;
      if (!uniform) {
        float kr[8];
        load8<T, DP, false>(sk + (rg + i * C::kGroups) * DP, c, d, kr);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sc[i][g] = fmaf(qr[g][e], kr[e], sc[i][g]);
        }
#pragma unroll
        for (int off = C::kTpr / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            sc[i][g] += __shfl_xor_sync(kFullMask, sc[i][g], off);
          }
        }
      }
    }
    // the thread's valid rows are its first nv
    const int nv = rg < valid ? (valid - rg + C::kGroups - 1) / C::kGroups : 0;
    if (nv > 0) {
      float vr[C::kRpt][8];
#pragma unroll
      for (int i = 0; i < C::kRpt; ++i) {
        if (i < nv) {
          load8<T, DP, false>(sv + (rg + i * C::kGroups) * DP, c, d, vr[i]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) vr[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= gn) break;
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < C::kRpt; ++i) {
          if (i < nv) mx = fmaxf(mx, sc[i][g]);
        }
        if (mx > m[g]) {   // the max moved (always on the first rows): rescale
          const float alpha = exp2f(m[g] - mx);
          l[g] *= alpha;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
          m[g] = mx;
        }
#pragma unroll
        for (int i = 0; i < C::kRpt; ++i) {
          if (i < nv) {
            const float p = exp2f(sc[i][g] - mx);
            l[g] += p;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vr[i][e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();                // the stage is refilled next iteration
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the row groups into the block's partial, in row-group order; the
  // ring is free now
  float* red_acc = reinterpret_cast<float*>(smem);      // [kGroups][GMAX][DP]
  float* red_m = red_acc + C::kGroups * GMAX * DP;      // [kGroups][GMAX]
  float* red_l = red_m + C::kGroups * GMAX;
  float* red_w = red_l + C::kGroups * GMAX;
  float* blk = red_w + C::kGroups * GMAX;               // m, l per head
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red_acc[(rg * GMAX + g) * DP + elem<T, DP>(c, e)] = acc[g][e];
    }
    if (c == 0) {
      red_m[rg * GMAX + g] = m[g];
      red_l[rg * GMAX + g] = l[g];
    }
  }
  __syncthreads();
  if (tid < gn) {
    float mx = -INFINITY;
    for (int r = 0; r < C::kGroups; ++r) mx = fmaxf(mx, red_m[r * GMAX + tid]);
    float sum = 0.f;
    for (int r = 0; r < C::kGroups; ++r) {
      // a row group without rows (m = -inf) weighs 0; so does all of an
      // empty split, whose m stays -inf
      const float w = mx == -INFINITY ? 0.f : exp2f(red_m[r * GMAX + tid] - mx);
      red_w[r * GMAX + tid] = w;
      sum = fmaf(red_l[r * GMAX + tid], w, sum);
    }
    blk[2 * tid] = mx;
    blk[2 * tid + 1] = sum;
  }
  __syncthreads();
  // partials: acc (B,H,n_split,D), then (m, l) (B,H,n_split,2)
  const int64_t head_row = (static_cast<int64_t>(b) * h + head0) * n_split;
  float* part_acc = part + head_row * d;
  float* part_ml = part + static_cast<int64_t>(batch) * h * n_split * d + head_row * 2;
  for (int i = tid; i < gn * d; i += kThreads) {
    const int g = i / d;
    const int dd = i - g * d;
    float a = 0.f;
    for (int r = 0; r < C::kGroups; ++r) {
      a = fmaf(red_acc[(r * GMAX + g) * DP + dd], red_w[r * GMAX + g], a);
    }
    if (n_split == 1) {
      store(out + q_base + static_cast<int64_t>(g) * d + dd, a / blk[2 * g + 1]);
    } else {
      part_acc[(static_cast<int64_t>(g) * n_split + split) * d + dd] = a;
    }
  }
  if (n_split == 1) return;
  if (tid < gn) {
    part_ml[(static_cast<int64_t>(tid) * n_split + split) * 2] = blk[2 * tid];
    part_ml[(static_cast<int64_t>(tid) * n_split + split) * 2 + 1] = blk[2 * tid + 1];
  }

  // the last block of this unit to finish combines
  __threadfence();
  __syncthreads();
  int* is_last = reinterpret_cast<int*>(blk + 2 * GMAX);   // past the combine's arrays
  if (tid == 0) *is_last = atomicAdd(tickets + unit, 1) == n_split - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();

  float* wm = reinterpret_cast<float*>(smem);   // [GMAX][kMaxSplits]: m, then weight
  float* wl = wm + GMAX * kMaxSplits;           // [GMAX][kMaxSplits]: l
  float* tot = wl + GMAX * kMaxSplits;          // [GMAX]
  for (int i = tid; i < gn * n_split; i += kThreads) {
    const int g = i / n_split;
    const int j = i - g * n_split;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + g * n_split + j);
    wm[g * kMaxSplits + j] = ml.x;
    wl[g * kMaxSplits + j] = ml.y;
  }
  __syncthreads();
  // one warp a head: the max and the weighted sum of l over the splits
  // (split j on lane j % 32, then a fixed shuffle tree: deterministic)
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int g = warp; g < gn; g += kThreads / 32) {
    float mx = -INFINITY;
    for (int j = lane; j < n_split; j += 32) mx = fmaxf(mx, wm[g * kMaxSplits + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    }
    // mx is finite: split 0 always has a row
    float sum = 0.f;
    for (int j = lane; j < n_split; j += 32) {
      const float w = exp2f(wm[g * kMaxSplits + j] - mx);   // 0 when empty
      wm[g * kMaxSplits + j] = w;
      sum = fmaf(wl[g * kMaxSplits + j], w, sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(kFullMask, sum, off);
    }
    if (lane == 0) tot[g] = sum;
  }
  __syncthreads();
  // four output elements a thread, the splits added in order
  const int d4 = d / 4;
  for (int i = tid; i < gn * d4; i += kThreads) {
    const int g = i / d4;
    const int dd = (i - g * d4) * 4;
    const float4* p = reinterpret_cast<const float4*>(
        part_acc + static_cast<int64_t>(g) * n_split * d + dd);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < n_split; ++j) {
      const float4 x = __ldcg(p + static_cast<int64_t>(j) * d4);
      const float w = wm[g * kMaxSplits + j];
      a.x = fmaf(x.x, w, a.x);
      a.y = fmaf(x.y, w, a.y);
      a.z = fmaf(x.z, w, a.z);
      a.w = fmaf(x.w, w, a.w);
    }
    T* o = out + q_base + static_cast<int64_t>(g) * d + dd;
    const float t = tot[g];
    store(o, a.x / t);
    store(o + 1, a.y / t);
    store(o + 2, a.z / t);
    store(o + 3, a.w / t);
  }
  if (tid == 0) tickets[unit] = 0;   // ready for the next launch on this stream
}

template <typename T, int DP, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* part,
                   int32_t* tickets, int b, int s, int h, int kvh, int d,
                   int n_split, cudaStream_t stream) {
  const int64_t units = static_cast<int64_t>(b) * kvh * ((h / kvh + GMAX - 1) / GMAX);
  decode_attention_kernel<T, DP, GMAX>
      <<<static_cast<unsigned>(units * n_split), kThreads, kRing, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), part, tickets,
      b, s, h, kvh, d, n_split,
      1.4426950408889634f / sqrtf(static_cast<float>(d)));  // log2(e)/sqrt(D)
  return cudaGetLastError();
}

// query heads per block: the whole group up to 4, or up to 8 (larger groups
// take several blocks per KV head); kernels/decode_attention.py
// group_chunk mirrors this choice
template <typename T, int DP>
cudaError_t by_group(const void* q, const void* k, const void* v,
                     const int32_t* lengths, void* out, float* part,
                     int32_t* tickets, int b, int s, int h, int kvh, int d,
                     int n_split, cudaStream_t stream) {
  switch (h / kvh) {
    case 1:
      return launch<T, DP, 1>(q, k, v, lengths, out, part, tickets, b, s, h, kvh,
                              d, n_split, stream);
    case 2:
      return launch<T, DP, 2>(q, k, v, lengths, out, part, tickets, b, s, h, kvh,
                              d, n_split, stream);
    case 3:
      return launch<T, DP, 3>(q, k, v, lengths, out, part, tickets, b, s, h, kvh,
                              d, n_split, stream);
    case 4:
      return launch<T, DP, 4>(q, k, v, lengths, out, part, tickets, b, s, h, kvh,
                              d, n_split, stream);
    default:
      return launch<T, DP, 8>(q, k, v, lengths, out, part, tickets, b, s, h, kvh,
                              d, n_split, stream);
  }
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* part,
                   int32_t* tickets, int b, int s, int h, int kvh, int d,
                   int n_split, cudaStream_t stream) {
  if (d <= 64) {
    return by_group<T, 64>(q, k, v, lengths, out, part, tickets, b, s, h, kvh, d,
                           n_split, stream);
  }
  if (d <= 128) {
    return by_group<T, 128>(q, k, v, lengths, out, part, tickets, b, s, h, kvh, d,
                            n_split, stream);
  }
  return by_group<T, 256>(q, k, v, lengths, out, part, tickets, b, s, h, kvh, d,
                          n_split, stream);
}

}  // namespace

// The wrapper (kernels/decode_attention.py) has checked the shapes: B, S,
// KVH >= 1, H a multiple of KVH and below 2^16, D a multiple of 16 in
// [16, 256], 1 <= n_split <= 64, B*KVH*chunks*n_split blocks below 2^31.
// part holds B*H*n_split*(D+2) floats (unused when n_split == 1); tickets
// holds B*H int32 zeros, which every launch leaves at zero.
extern "C" cudaError_t repro_decode_attention(
    const void* q, const void* k, const void* v, const int32_t* lengths,
    void* out, float* part, int32_t* tickets, int b, int s, int h, int kvh,
    int d, int n_split, int is_bf16, cudaStream_t stream) {
  if (n_split < 1 || n_split > kMaxSplits) return cudaErrorInvalidValue;
  if (is_bf16) {
    return by_dim<__nv_bfloat16>(q, k, v, lengths, out, part, tickets, b, s, h,
                                 kvh, d, n_split, stream);
  }
  return by_dim<float>(q, k, v, lengths, out, part, tickets, b, s, h, kvh, d,
                       n_split, stream);
}
