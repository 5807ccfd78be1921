// The paged-attention decode body (s = 1) shared by
// csrc/paged_attention.cu (one CTA per work unit) and csrc/decode_layer.cu
// (the decode-layer megakernel's attention phase, a grid-stride loop over
// the same work units), so both routes run one arithmetic.
//
// A work item is one (slot, kv head) and up to G of that kv head's
// g = h / kvh query heads. Its table walk is split into `nc` chunks of
// `ce` table entries (the split table walk): a work unit is one (item,
// chunk), so a long table spreads over many CTAs and no single ragged row
// sets the time. The plan (ce, nc) comes from the table width and the
// item count on the host, never from the lengths: a chunk at or past a
// row's ceil(length / block_size) entries exits at once (the plan is
// `split_plan` of ops/paged_attention.py).
//
// A unit's four warps take its entries round-robin (warp w: entries
// jb + w, jb + w + 4, ...) and stream them from HBM straight into
// registers, with no CTA barrier in the loop: one (position, kv head) row
// of d elements is d / V lanes wide (V = the elements in 16 bytes: 4
// fp32, 8 bf16 or 16 int8 codes), so one 16-byte load per lane covers
// 32 / (d / V) rows, and each lane walks the rows tl, tl + 32 / (d / V),
// ... of a block. A lane folds its rows into its own online softmax per
// query head (running max and normalizer, the accumulator of its V dims):
// the update of `_online_update` (paddle_tpu/ops/pallas/paged_attention.py
// :175-192) over up to kRows rows at a time, each row's score reduced over
// its d / V lanes with shuffles. Rows at or past the length do not enter
// the softmax (the TPU kernel's -1e30 score gives them probability 0).
// Then the partial states merge, each rescaled by exp(m_i - max): across
// a warp's row groups with shuffles, across the warps in shared memory.
// With one chunk the output is acc / l at once. With more, each unit
// leaves its (m, l, acc) in scratch, takes a ticket (an integer atomic
// per item), and the unit that takes the last ticket merges the item's
// chunks in chunk order, the same rescaled sum, writes acc / l and resets
// the ticket to 0 for the next launch. The merge order is fixed, so two
// launches give bit-identical outputs; no float atomics.
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
  static constexpr bool kInt8 = false;
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
  static constexpr bool kInt8 = true;
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

// Shared memory one work unit needs: the warps' accumulators (kWarps, G,
// d), their (max, normalizer) pairs (kWarps, G, 2), the merge flag and
// the unit's query rows (G, d), first; a multiple of 4 floats.
template <int G>
__host__ __device__ constexpr size_t item_smem_floats(int d) {
  return (size_t)G * d + (size_t)kWarps * G * d + (size_t)kWarps * G * 2 + 4;
}

// The kThreads threads that run a work unit: a whole CTA (barrier
// __syncthreads), or with `id` > 0 the id-th group of kThreads threads of
// a larger CTA, synchronised by named barrier `id`.
struct UnitThreads {
  int id;
  __device__ __forceinline__ int tid() const {
    return id ? threadIdx.x - (id - 1) * kThreads : threadIdx.x;
  }
  __device__ __forceinline__ void sync() const {
    if (id)
      asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads));
    else
      __syncthreads();
  }
};

// Scratch of one unit's partial state: G heads of (acc[d], m, l).
template <int G>
__host__ __device__ constexpr size_t unit_part_floats(int d) {
  return (size_t)G * (d + 2);
}

// The split of a table walk: `nc` chunks of `ce` entries. `part` holds
// unit_part_floats<G>(d) floats per (item, chunk) and `tickets` one int
// per item, zero before the launch (the merging unit leaves it zero);
// both are unused when nc == 1.
struct Split {
  int ce, nc;
  float* part;
  int* tickets;
};

// Work unit (item, chunk) of a (b, h, d) query block, item = (slot, kv
// head, head chunk), out (b, h, d) in T. `lengths` (b,) counts each
// slot's valid positions; `table` is the (b, mb) int32 block table.
// `smem` holds item_smem_floats<G>(d) floats; the kThreads threads of
// `threads` call this together, and it ends in their barrier, so the
// caller may start the next unit at once. R rows of K and V are in flight
// per lane. The unit's query rows are read once (`qload`, one element a
// thread) into shared memory, where every lane of a row position finds
// its V elements.
template <typename T, typename KV, int G, int R = kRows, typename QLoad>
__device__ __forceinline__ void decode_item(
    int item, int chunk, const Split& split, const QLoad& qload,
    const KV& kv, const int* table, const int* lengths, T* out, int h,
    int kvh, int d, int bs, int mb, float scale, float* smem,
    UnitThreads threads = {0}) {
  constexpr int V = KV::V;
  const int tid = threads.tid();
  const int g = h / kvh;
  const int chunks = (g + G - 1) / G;
  const int hc = item % chunks;
  const int kh = (item / chunks) % kvh;
  const int slot = item / (chunks * kvh);
  const int h0 = kh * g + hc * G;          // the item's first query head
  const int ng = min(G, g - hc * G);       // the query heads it computes
  const int lane = tid & 31, warp = tid >> 5;
  const int lpp = d / V;                   // lanes per row (power of two)
  const int ppw = 32 / lpp;                // rows per warp-wide load
  const int c = lane % lpp, tl = lane / lpp;
  const int npl = (bs + ppw - 1) / ppw;    // rows per lane per block

  const int length = lengths[slot];
  const int nblk = min((length + bs - 1) / bs, mb);
  const int jb = chunk * split.ce;
  const int je = min(jb + split.ce, nblk);
  // chunk 0 always runs (an empty row leaves m = -1e30, l = 0)
  const bool empty = chunk > 0 && jb >= nblk;
  float* q_s = smem;                            // (G, d)
  float* acc_s = q_s + G * d;                   // (kWarps, G, d)
  float* ml_s = acc_s + (size_t)kWarps * G * d;  // (kWarps, G, 2)
  int* last_unit = reinterpret_cast<int*>(ml_s + kWarps * G * 2);
  float* part = split.nc > 1 ? split.part + ((size_t)item * split.nc +
                                             chunk) * unit_part_floats<G>(d)
                             : nullptr;

  if (!empty) {
    for (int e = tid; e < ng * d; e += kThreads)
      q_s[e] = qload(slot, h0 + e / d, e % d, h, d);
    threads.sync();
    float qr[G][V], acc[G][V], m[G], l[G];
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qr[hh][e] = hh < ng ? q_s[hh * d + c * V + e] : 0.f;
        acc[hh][e] = 0.f;
      }
      m[hh] = kNeg;
      l[hh] = 0.f;
    }

    const int* trow = table + (size_t)slot * mb;
    int next = jb + warp < je ? trow[jb + warp] : 0;
    for (int j = jb + warp; j < je; j += kWarps) {
      const size_t blk = (size_t)next;
      if (j + kWarps < je) next = trow[j + kWarps];
      for (int i0 = 0; i0 < npl; i0 += R) {
        typename KV::Vec kx[R] = {}, vx[R] = {};
        bool valid[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int t = (i0 + i) * ppw + tl;
          valid[i] = i0 + i < npl && t < bs && j * bs + t < length;
          if (i0 + i < npl && t < bs) {
            const size_t row = (blk * bs + t) * kvh + kh;
            kx[i] = kv.load_k(row, d, c);
            vx[i] = kv.load_v(row, d, c);
          }
        }
        // scores; i0 + i < npl is the same on every lane of the warp
        float s[R][G];
#pragma unroll
        for (int i = 0; i < R; ++i) {
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
        float p[R][G];
#pragma unroll
        for (int hh = 0; hh < G; ++hh) {
          float mx = m[hh];
#pragma unroll
          for (int i = 0; i < R; ++i)
            if (valid[i]) mx = fmaxf(mx, s[i][hh]);
          const float corr = expf(m[hh] - mx);
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            p[i][hh] = valid[i] ? expf(s[i][hh] - mx) : 0.f;
            sum += p[i][hh];
          }
          l[hh] = l[hh] * corr + sum;
          m[hh] = mx;
#pragma unroll
          for (int e = 0; e < V; ++e) acc[hh][e] *= corr;
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
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

    // merge the warp's row groups (lanes c, c + lpp, ...): rescale each
    // to the warp's max, then sum
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
    threads.sync();
    for (int e = tid; e < ng * d; e += kThreads) {
      const int hh = e / d, i = e - hh * d;
      float mx = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        mx = fmaxf(mx, ml_s[(w * G + hh) * 2]);
      float lt = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(ml_s[(w * G + hh) * 2] - mx);
        lt += f * ml_s[(w * G + hh) * 2 + 1];
        a += f * acc_s[(w * G + hh) * d + i];
      }
      if (split.nc == 1) {
        out[((size_t)slot * h + h0 + hh) * d + i] = from_f32<T>(a / lt);
      } else {
        part[hh * (d + 2) + i] = a;
        if (i == 0) {
          part[hh * (d + 2) + d] = mx;
          part[hh * (d + 2) + d + 1] = lt;
        }
      }
    }
  }
  if (split.nc > 1) {
    // the ticket: the unit that finishes an item's walk last merges it
    __threadfence();
    threads.sync();
    if (tid == 0)
      *last_unit = atomicAdd(split.tickets + item, 1) == split.nc - 1;
    threads.sync();
    if (*last_unit) {
      __threadfence();
      const float* ip = split.part + (size_t)item * split.nc *
                                         unit_part_floats<G>(d);
      const int nv = max(1, min(split.nc, (nblk + split.ce - 1) / split.ce));
      for (int e = tid; e < ng * d; e += kThreads) {
        const int hh = e / d, i = e - hh * d;
        float mx = kNeg;
        for (int u = 0; u < nv; ++u)
          mx = fmaxf(mx, __ldcg(ip + u * unit_part_floats<G>(d) +
                                hh * (d + 2) + d));
        float lt = 0.f, a = 0.f;
        for (int u = 0; u < nv; ++u) {
          const float* pu = ip + u * unit_part_floats<G>(d) + hh * (d + 2);
          const float f = expf(__ldcg(pu + d) - mx);
          lt += f * __ldcg(pu + d + 1);
          a += f * __ldcg(pu + i);
        }
        out[((size_t)slot * h + h0 + hh) * d + i] = from_f32<T>(a / lt);
      }
      if (tid == 0) split.tickets[item] = 0;
    }
  }
  threads.sync();
}

}  // namespace pt_paged
