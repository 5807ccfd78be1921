// The paged-attention decode body (s = 1) shared by
// csrc/paged_attention.cu (one CTA per work item) and csrc/decode_layer.cu
// (the decode-layer megakernel's attention phase, a grid-stride loop over
// the same work items), so both routes run one arithmetic.
//
// A work item is one (slot, kv head) and up to G of that kv head's
// g = h / kvh query heads. Its four warps take the table entries
// round-robin (warp w: entries w, w + 4, ...) and stream them from HBM
// straight into registers, with no CTA barrier in the loop: one
// (position, kv head) row of d elements is d / V lanes wide (V = the
// elements in 16 bytes: 4 fp32, 8 bf16 or 16 int8 codes), so one 16-byte
// load per lane covers 32 / (d / V) rows, and each lane walks the rows
// tl, tl + 32 / (d / V), ... of a block. A lane folds its rows into its
// own online softmax per query head (running max and normalizer, the
// accumulator of its V dims): the update of `_online_update`
// (paddle_tpu/ops/pallas/paged_attention.py:175-192) over up to kRows
// rows at a time, each row's score reduced over its d / V lanes with
// shuffles. Rows at or past the length do not enter the softmax (the TPU
// kernel's -1e30 score gives them probability 0); entries at or past
// ceil(length / block_size) are not read. At the end the partial states
// merge, each rescaled by exp(m_i - max): across a warp's row groups with
// shuffles, across the warps in shared memory. The output is acc / l.
//
// How a 16-byte K/V vector reaches fp32 is a policy: `DenseKV` converts
// fp32/bf16 arena elements, `Int8KV` dequantizes 16 int8 codes of a row
// (nb, bs, kvh, d) with the row's fp32 absmax scale (nb, bs, kvh) in
// registers, exactly as `_dequantize` of
// paddle_tpu/distributed/collectives/quantized.py compiles under XLA: a
// code of +-127 gives +-absmax bit-exactly, any other code
// q * (absmax * fl(1/127)) (XLA rewrites the division by 127 into a
// product with its fp32 reciprocal). How q is read (`QLoad`) is a policy
// too: the standalone kernel reads q as given, the megakernel rotates it
// (RoPE) as it loads it.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace pt_paged {

constexpr float kNeg = -1e30f;
constexpr float kInv127 = 1.0f / 127.0f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;           // rows a lane loads before folding them
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// fp32/bf16 arena: one 16-byte vector is V elements of a row.
template <typename T>
struct DenseKV {
  static constexpr int V = 16 / sizeof(T);
  struct Vec {
    uint4 raw;
  };
  const T* k;
  const T* v;

  // vector c of arena row `row` = (blk * bs + t) * kvh + kh
  __device__ __forceinline__ Vec load_k(size_t row, int d, int c) const {
    return {load16(k + row * d + (size_t)c * V)};
  }
  __device__ __forceinline__ Vec load_v(size_t row, int d, int c) const {
    return {load16(v + row * d + (size_t)c * V)};
  }
  __device__ __forceinline__ static void expand(const Vec& x,
                                                float (&f)[V]) {
    const T* e = reinterpret_cast<const T*>(&x.raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f32(e[i]);
  }
};

// int8 arena: 16 codes of a row and the row's absmax scale (scales are
// (nb, bs, kvh): one per row). The dequantization of `_dequantize`
// (quantized.py:64-72) as XLA compiles it:
// where(|q| == 127, sign(q) * s, q * (s * fl(1/127))), s >= 0.
struct Int8KV {
  static constexpr int V = 16;
  struct Vec {
    uint4 raw;
    float s;
  };
  const int8_t* k;
  const int8_t* v;
  const float* sk;
  const float* sv;

  __device__ __forceinline__ Vec load_k(size_t row, int d, int c) const {
    return {load16(k + row * d + (size_t)c * V), sk[row]};
  }
  __device__ __forceinline__ Vec load_v(size_t row, int d, int c) const {
    return {load16(v + row * d + (size_t)c * V), sv[row]};
  }
  __device__ __forceinline__ static void expand(const Vec& x,
                                                float (&f)[V]) {
    const float step = x.s * kInv127;
    const uint32_t w[4] = {x.raw.x, x.raw.y, x.raw.z, x.raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // byte b of the word, sign-extended (the arena is little-endian)
        const float qf = (float)((int32_t)(w[i] << (24 - 8 * b)) >> 24);
        f[4 * i + b] = fabsf(qf) == 127.f ? copysignf(x.s, qf) : qf * step;
      }
    }
  }
};

// q (b, h, d) read as given, in its own dtype.
template <typename T>
struct QPlain {
  const T* q;
  __device__ __forceinline__ float operator()(int slot, int head, int i,
                                              int h, int d) const {
    return to_f32(q[((size_t)slot * h + head) * d + i]);
  }
};

// Shared memory one work item needs: the warps' accumulators (kWarps, G,
// d) and their (max, normalizer) pairs (kWarps, G, 2).
template <int G>
__host__ __device__ constexpr size_t item_smem_floats(int d) {
  return (size_t)kWarps * G * d + (size_t)kWarps * G * 2;
}

// Work item `item` = (slot, kv head, head chunk) of a (b, h, d) query
// block, out (b, h, d) in T. `lengths` (b,) counts each slot's valid
// positions; `table` is the (b, mb) int32 block table. `smem` holds
// item_smem_floats<G>(d) floats; all kThreads threads of the CTA call
// this together, and it ends in a barrier, so the caller may start the
// next item at once.
template <typename T, typename KV, int G, typename QLoad>
__device__ __forceinline__ void decode_item(
    int item, const QLoad& qload, const KV& kv, const int* table,
    const int* lengths, T* out, int h, int kvh, int d, int bs, int mb,
    float scale, float* smem) {
  constexpr int V = KV::V;
  const int g = h / kvh;
  const int chunks = (g + G - 1) / G;
  const int hc = item % chunks;
  const int kh = (item / chunks) % kvh;
  const int slot = item / (chunks * kvh);
  const int h0 = kh * g + hc * G;          // the item's first query head
  const int ng = min(G, g - hc * G);       // the query heads it computes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpp = d / V;                   // lanes per row (power of two)
  const int ppw = 32 / lpp;                // rows per warp-wide load
  const int c = lane % lpp, tl = lane / lpp;
  const int npl = (bs + ppw - 1) / ppw;    // rows per lane per block

  float qr[G][V], acc[G][V], m[G], l[G];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[hh][e] = hh < ng ? qload(slot, h0 + hh, c * V + e, h, d) : 0.f;
      acc[hh][e] = 0.f;
    }
    m[hh] = kNeg;
    l[hh] = 0.f;
  }

  const int length = lengths[slot];
  const int nblk = min((length + bs - 1) / bs, mb);
  const int* trow = table + (size_t)slot * mb;
  int next = warp < nblk ? trow[warp] : 0;
  for (int j = warp; j < nblk; j += kWarps) {
    const size_t blk = (size_t)next;
    if (j + kWarps < nblk) next = trow[j + kWarps];
    for (int i0 = 0; i0 < npl; i0 += kRows) {
      typename KV::Vec kx[kRows] = {}, vx[kRows] = {};
      bool valid[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int t = (i0 + i) * ppw + tl;
        valid[i] = i0 + i < npl && t < bs && j * bs + t < length;
        if (i0 + i < npl && t < bs) {
          const size_t row = (blk * bs + t) * kvh + kh;
          kx[i] = kv.load_k(row, d, c);
          vx[i] = kv.load_v(row, d, c);
        }
      }
      // scores; i0 + i < npl is the same on every lane of the warp
      float s[kRows][G];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i0 + i >= npl) continue;
        float kf[V];
        KV::expand(kx[i], kf);
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qr[hh][e] * kf[e];
          for (int o = lpp >> 1; o > 0; o >>= 1)
            dot += __shfl_xor_sync(kFull, dot, o);
          s[i][hh] = dot * scale;
        }
      }
      // online-softmax fold of this lane's rows
      float p[kRows][G];
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (valid[i]) mx = fmaxf(mx, s[i][hh]);
        const float corr = expf(m[hh] - mx);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          p[i][hh] = valid[i] ? expf(s[i][hh] - mx) : 0.f;
          sum += p[i][hh];
        }
        l[hh] = l[hh] * corr + sum;
        m[hh] = mx;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[hh][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (!valid[i]) continue;
        float vf[V];
        KV::expand(vx[i], vf);
#pragma unroll
        for (int hh = 0; hh < G; ++hh)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[hh][e] += p[i][hh] * vf[e];
      }
    }
  }

  // merge the warp's row groups (lanes c, c + lpp, ...): rescale each to
  // the warp's max, then sum
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    float mw = m[hh];
    for (int o = lpp; o < 32; o <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(kFull, mw, o));
    const float w = expf(m[hh] - mw);
    float lw = l[hh] * w;
    for (int o = lpp; o < 32; o <<= 1) lw += __shfl_xor_sync(kFull, lw, o);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float a = acc[hh][e] * w;
      for (int o = lpp; o < 32; o <<= 1) a += __shfl_xor_sync(kFull, a, o);
      acc[hh][e] = a;
    }
    m[hh] = mw;
    l[hh] = lw;
  }
  // merge the warps in shared memory
  float* acc_s = smem;                          // (kWarps, G, d)
  float* ml_s = smem + (size_t)kWarps * G * d;  // (kWarps, G, 2)
  if (tl == 0) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh)
#pragma unroll
      for (int e = 0; e < V; ++e)
        acc_s[(warp * G + hh) * d + c * V + e] = acc[hh][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      ml_s[(warp * G + hh) * 2] = m[hh];
      ml_s[(warp * G + hh) * 2 + 1] = l[hh];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * d; e += kThreads) {
    const int hh = e / d, i = e - hh * d;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * G + hh) * 2]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ml_s[(w * G + hh) * 2] - mx);
      lt += f * ml_s[(w * G + hh) * 2 + 1];
      a += f * acc_s[(w * G + hh) * d + i];
    }
    out[((size_t)slot * h + h0 + hh) * d + i] = from_f32<T>(a / lt);
  }
  __syncthreads();
}

}  // namespace pt_paged
