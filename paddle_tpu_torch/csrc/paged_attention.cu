// Paged-attention decode (s = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (fp32/bf16 arena, reached through
// `paged_attention_decode`) and `_decode_kernel_int8` (int8 arena,
// reached through `paged_attention_decode_int8`); both run their
// pallas_call in `_grid_call`. q (b, h, d) attends over each slot's KV
// history, stored as blocks of a shared (num_blocks, block_size, kvh, d)
// arena and addressed through the slot's row of the (b, max_blocks)
// int32 block table; lengths (b,) counts the valid positions.
//
// The TPU kernel walked table entries as a sequential grid axis with the
// table and lengths in scalar prefetch, carrying the online softmax in
// VMEM scratch. Here each CTA reads its own table row and length and
// owns one (slot, kv head) and up to four of that kv head's g = h / kvh
// query heads (more heads take more CTAs). Its four warps take the table
// entries round-robin (warp w: entries w, w + 4, ...) and stream them
// from HBM straight into registers, with no CTA barrier in the loop:
// one (position, kv head) row of d elements is d / V lanes wide (V = the
// elements in 16 bytes: 4 fp32, 8 bf16 or 16 int8 codes), so one 16-byte
// load per lane covers 32 / (d / V) rows, and each lane walks the rows
// tl, tl + 32 / (d / V), ... of a block. A lane folds its rows into its
// own online softmax per query head (running max and normalizer, the
// accumulator of its V dims): the update of `_online_update`
// (paged_attention.py:175-192) over up to kRows rows at a time, each
// row's score reduced over its d / V lanes with shuffles. Rows at or past
// the length do not enter the softmax (the TPU kernel's -1e30 score gives
// them probability 0); entries at or past ceil(length / block_size) are
// not read. At the end the partial states merge, each rescaled by
// exp(m_i - max): across a warp's row groups with shuffles, across the
// warps in shared memory. The output is acc / l in q's dtype. The g query
// heads of a CTA share every K/V vector it loads.
//
// The two TPU kernels share `_decode_kernel_core` and differ only in how
// a block's k/v reach fp32; here one kernel template shares the whole
// online-softmax body and takes that step as a policy on one 16-byte
// vector: `DenseKV` converts fp32/bf16 arena elements, `Int8KV`
// dequantizes 16 int8 codes of a row (nb, bs, kvh, d) with the row's
// fp32 absmax scale (nb, bs, kvh) in registers, exactly as `_dequantize`
// of paddle_tpu/distributed/collectives/quantized.py compiles under XLA:
// a code of +-127 gives +-absmax bit-exactly, any other code
// q * (absmax * fl(1/127)) (XLA rewrites the division by 127 into a
// product with its fp32 reciprocal).
//
// Bound: bytes — the KV actually read, sum over slots of
// ceil(len / bs) * bs * kvh * (d * elt + scale bytes) * 2 per layer
// (elt 1 and 4 scale bytes for the int8 arena), plus q and out. Plain
// 16-byte loads, kRows rows of K and V in flight per lane; cp.async/TMA
// pipelining and split-K over long tables (to fill the card when
// b * kvh is small) are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// T: the type of q and out; KV: how a 16-byte K/V vector reaches fp32;
// G: query heads per CTA (1, 2 or 4).
template <typename T, typename KV, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, KV kv,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        T* __restrict__ out, int h, int kvh, int d, int bs,
                        int mb, float scale) {
  constexpr int V = KV::V;
  const int g = h / kvh;
  const int chunks = (g + G - 1) / G;
  const int hc = blockIdx.x % chunks;
  const int kh = (blockIdx.x / chunks) % kvh;
  const int slot = blockIdx.x / (chunks * kvh);
  const int h0 = kh * g + hc * G;          // the CTA's first query head
  const int ng = min(G, g - hc * G);       // the query heads it computes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpp = d / V;                   // lanes per row (power of two)
  const int ppw = 32 / lpp;                // rows per warp-wide load
  const int c = lane % lpp, tl = lane / lpp;
  const int npl = (bs + ppw - 1) / ppw;    // rows per lane per block

  float qr[G][V], acc[G][V], m[G], l[G];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    const T* qh = q + ((size_t)slot * h + h0 + hh) * d + (size_t)c * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[hh][e] = hh < ng ? to_f32(qh[e]) : 0.f;
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
  __shared__ float ml_s[kWarps][G][2];
  extern __shared__ float acc_s[];   // (kWarps, G, d)
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
      ml_s[warp][hh][0] = m[hh];
      ml_s[warp][hh][1] = l[hh];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < ng * d; e += kThreads) {
    const int hh = e / d, i = e - hh * d;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[w][hh][0]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ml_s[w][hh][0] - mx);
      lt += f * ml_s[w][hh][1];
      a += f * acc_s[(w * G + hh) * d + i];
    }
    out[((size_t)slot * h + h0 + hh) * d + i] = from_f32<T>(a / lt);
  }
}

template <typename T, typename KV, int G>
int launch_g(const T* q, KV kv, const int* table, const int* lengths,
             T* out, int b, int h, int kvh, int d, int bs, int mb,
             float scale, cudaStream_t stream) {
  const int chunks = (h / kvh + G - 1) / G;
  const size_t smem = sizeof(float) * kWarps * G * d;
  paged_decode_kernel<T, KV, G><<<b * kvh * chunks, kThreads, smem,
                                  stream>>>(q, kv, table, lengths, out, h,
                                            kvh, d, bs, mb, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, KV kv, const void* table, const void* lengths,
           void* out, int b, int h, int kvh, int d, int bs, int mb,
           float scale, cudaStream_t stream) {
  // the lane layout: a row is d / V lanes, a power of two up to 32
  const int lpp = d / KV::V;
  if (d % KV::V || lpp > 32 || (lpp & (lpp - 1)) || kvh <= 0 || h % kvh)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  T* o = static_cast<T*>(out);
  const int g = h / kvh;
  if (g == 1)
    return launch_g<T, KV, 1>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb,
                              scale, stream);
  if (g == 2)
    return launch_g<T, KV, 2>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb,
                              scale, stream);
  return launch_g<T, KV, 4>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb, scale,
                            stream);
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* table, const void* lengths, void* out, int b,
                 int h, int kvh, int d, int bs, int mb, float scale,
                 cudaStream_t stream) {
  DenseKV<T> kv{static_cast<const T*>(k), static_cast<const T*>(v)};
  return launch<T>(q, kv, table, lengths, out, b, h, kvh, d, bs, mb, scale,
                   stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both arenas and out share it).
// q/out (b, h, d), arenas (nb, bs, kvh, d), table (b, mb) int32, lengths
// (b,) int32, all contiguous; d / (16-byte vector width) is a power of
// two up to 32 and the arena pointers are 16-byte aligned (the Python
// wrapper checks). Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int pt_paged_attention_decode(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* table,
                                         const void* lengths, void* out,
                                         int b, int h, int kvh, int d, int bs,
                                         int mb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dense<float>(q, k, v, table, lengths, out, b, h, kvh, d,
                               bs, mb, scale, s);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(q, k, v, table, lengths, out, b, h,
                                       kvh, d, bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 arena. qdtype: 0 = float32, 1 = bfloat16 (q and out share
// it). Codes (nb, bs, kvh, d) int8, scales (nb, bs, kvh) float32, the
// rest as above; d / 16 is a power of two up to 32 and the code arenas
// are 16-byte aligned (the Python wrapper checks).
extern "C" int pt_paged_attention_decode_int8(
    int qdtype, const void* q, const void* k, const void* v,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lengths, void* out, int b, int h, int kvh, int d, int bs,
    int mb, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
            static_cast<const float*>(k_scales),
            static_cast<const float*>(v_scales)};
  if (qdtype == 0)
    return launch<float>(q, kv, table, lengths, out, b, h, kvh, d, bs, mb,
                         scale, s);
  if (qdtype == 1)
    return launch<__nv_bfloat16>(q, kv, table, lengths, out, b, h, kvh, d,
                                 bs, mb, scale, s);
  return (int)cudaErrorInvalidValue;
}
