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
// Design: one block of 8 warps per (b, KV head, chunk of up to GMAX of
// its G query heads).  Each warp walks its share of the valid rows
// s < min(lengths[b], S), R rows at a time (their k and v loads issued
// together), and keeps, per query head, a running max, a running sum and a
// float32 accumulator of D values spread over its 32 lanes (D/32 each:
// DPL); each q . k dot product reduces by warp shuffle.  The masked rows
// are never read: in float32 they contribute exactly 0, as exp(-1e30 - m)
// does.  At the end the warps' partial softmaxes are rescaled to the
// block's maximum and added in warp order in shared memory (deterministic),
// and the last warp divides by the total and writes the output.  The TPU
// kernel's sequential grid over 512-row blocks with a VMEM accumulator
// becomes the loop inside each warp; its cross-block combine becomes the
// warp merge.
//
// Bound on H100: bytes (each valid k and v row read once, 2*D bytes per
// row in bf16), far below the float32 operation bound.  With one block
// per (b, KV head) the grid is small (64 blocks at the server's batch of
// 8 with 8 KV heads, for 132 SMs); splitting S over more blocks with a
// second combine pass (flash-decoding) is left for a later change.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBlockThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// Elements [lane*DPL, lane*DPL + DPL) of a D-element row, as float; zero
// past D.  When D == 32*DPL and DPL is a multiple of 4, four elements go in
// one 8-byte (bf16) or 16-byte (float32) load; the row starts on a
// multiple of 16 elements, so those loads are aligned.
template <typename T, int DPL>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int lane,
                                         int d, bool full, float (&out)[DPL]) {
  const int base = lane * DPL;
  if constexpr (DPL % 4 == 0) {
    if (full) {
#pragma unroll
      for (int j = 0; j < DPL; j += 4) {
        if constexpr (sizeof(T) == 2) {
          const uint2 u = *reinterpret_cast<const uint2*>(row + base + j);
          // bf16 -> float is the 16 bits placed high; element 0 is low
          out[j] = __uint_as_float(u.x << 16);
          out[j + 1] = __uint_as_float(u.x & 0xffff0000u);
          out[j + 2] = __uint_as_float(u.y << 16);
          out[j + 3] = __uint_as_float(u.y & 0xffff0000u);
        } else {
          const float4 f = *reinterpret_cast<const float4*>(row + base + j);
          out[j] = f.x;
          out[j + 1] = f.y;
          out[j + 2] = f.z;
          out[j + 3] = f.w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    out[j] = base + j < d ? to_float(row[base + j]) : 0.f;
  }
}

template <typename T, int DPL, int GMAX>
__global__ void __launch_bounds__(kBlockThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int s_len, int h, int kvh, int d,
                        float sqrt_d) {
  constexpr int R = DPL >= 8 ? 2 : 4;  // rows a warp loads at once
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int groups = h / kvh;
  const int g0 = blockIdx.z * GMAX;
  const int gn = min(GMAX, groups - g0);  // query heads of this block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool full = d == 32 * DPL;

  const int len = lengths[b];
  const bool uniform = len <= 0;  // every position masked: mean of all v
  const int rows = uniform ? s_len : min(len, s_len);

  const int64_t q_base = (static_cast<int64_t>(b) * h + kh * groups + g0) * d;
  float qr[GMAX][DPL];
  float m[GMAX], l[GMAX], acc[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < gn) {
      load_row<T, DPL>(q + q_base + static_cast<int64_t>(g) * d, lane, d, full,
                       qr[g]);
    } else {
#pragma unroll
      for (int j = 0; j < DPL; ++j) qr[g][j] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  const int64_t row_stride = static_cast<int64_t>(kvh) * d;
  const int64_t kv_base = (static_cast<int64_t>(b) * s_len * kvh + kh) * d;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;

  for (int s0 = warp * R; s0 < rows; s0 += kWarps * R) {
    float kr[R][DPL], vr[R][DPL];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = s0 + r;
      if (s < rows) {
        if (!uniform) load_row<T, DPL>(kb + s * row_stride, lane, d, full, kr[r]);
        load_row<T, DPL>(vb + s * row_stride, lane, d, full, vr[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (s0 + r >= rows) break;  // the same for the whole warp
      float sc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float dot = 0.f;
        if (!uniform && g < gn) {
#pragma unroll
          for (int j = 0; j < DPL; ++j) dot = fmaf(qr[g][j], kr[r][j], dot);
        }
        sc[g] = dot;
      }
      if (!uniform) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            sc[g] += __shfl_xor_sync(kFullMask, sc[g], off);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= gn) break;
        const float score = uniform ? 0.f : sc[g] / sqrt_d;
        const float m_new = fmaxf(m[g], score);
        const float alpha = expf(m[g] - m_new);  // 0 on the first row
        const float p = expf(score - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(acc[g][j], alpha, p * vr[r][j]);
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes (warp 0 always has row 0)
  __shared__ float sm_m[kWarps][GMAX];
  __shared__ float sm_l[kWarps][GMAX];
  __shared__ float sm_acc[GMAX][32 * DPL];
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  float total[GMAX], mine[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sm_l[w][g] * expf(sm_m[w][g] - mx);
    total[g] = sum;
    mine[g] = expf(m[g] - mx);  // 0 for a warp that had no rows
  }
  const int64_t out_base = q_base;
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= gn) break;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int idx = lane * DPL + j;
          const float val = acc[g][j] * mine[g];
          if (w == 0) {
            sm_acc[g][idx] = val;
          } else if (w < kWarps - 1) {
            sm_acc[g][idx] += val;
          } else if (idx < d) {
            store(out + out_base + static_cast<int64_t>(g) * d + idx,
                  (sm_acc[g][idx] + val) / total[g]);
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int DPL, int GMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, int b, int s, int h,
                   int kvh, int d, cudaStream_t stream) {
  const int groups = h / kvh;
  const dim3 grid(static_cast<unsigned>(b), static_cast<unsigned>(kvh),
                  static_cast<unsigned>((groups + GMAX - 1) / GMAX));
  decode_attention_kernel<T, DPL, GMAX><<<grid, kBlockThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), s, h, kvh, d,
      sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

// query heads per block: all of a group of 1, up to 4, or up to 8 (larger
// groups take several blocks per KV head)
template <typename T, int DPL>
cudaError_t by_group(const void* q, const void* k, const void* v,
                     const int32_t* lengths, void* out, int b, int s, int h,
                     int kvh, int d, cudaStream_t stream) {
  const int groups = h / kvh;
  if (groups == 1) return launch<T, DPL, 1>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  if (groups <= 4) return launch<T, DPL, 4>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  return launch<T, DPL, 8>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
}

template <typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, int b, int s, int h,
                   int kvh, int d, cudaStream_t stream) {
  if (d <= 32) return by_group<T, 1>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  if (d <= 64) return by_group<T, 2>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  if (d <= 128) return by_group<T, 4>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  return by_group<T, 8>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
}

}  // namespace

// The wrapper (kernels/decode_attention.py) has checked the shapes: B, S,
// KVH >= 1, H a multiple of KVH, D a multiple of 16 in [16, 256].
extern "C" cudaError_t repro_decode_attention(const void* q, const void* k,
                                              const void* v,
                                              const int32_t* lengths, void* out,
                                              int b, int s, int h, int kvh,
                                              int d, int is_bf16,
                                              cudaStream_t stream) {
  if (is_bf16) {
    return by_dim<__nv_bfloat16>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
  }
  return by_dim<float>(q, k, v, lengths, out, b, s, h, kvh, d, stream);
}
