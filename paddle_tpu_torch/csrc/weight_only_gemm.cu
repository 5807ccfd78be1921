// Weight-only quantized product for Hopper (sm_90a), on the tensor cores:
//   y[m, o] = sum_k x[m, k] * w[o, k],   w[o, k] = (q[o, k] * s) / qmax
// with int8 codes q (qmax 127) or int4 codes nibble-packed along k (two
// consecutive k a byte, the even k in the low nibble; qmax 7), and s the
// fp32 scale of output channel o (per-channel, (N,)) or of o's group of
// `gsize` consecutive k (grouped, (N, K / gsize)). Each weight is the one
// `nn.quant.dequantize_array` computes, bit for bit: the product rounded,
// then the correctly rounded quotient. x is fp32 or bf16; the sum is fp32
// and y has x's type.
//
// Replaces no TPU kernel: the JAX package dequantizes its serving weights
// in the decode program (`paddle_tpu/serving/quant.py` dequantize_pv,
// `nn/quant/__init__.py` dequantize_array) and XLA fuses the scale
// multiply into the GEMM's prologue, so the weights cross HBM as codes.
// Torch fuses nothing: dequantizing to fp32 and calling cuBLAS writes and
// reads the fp32 weight again. This kernel keeps the weight out of device
// memory: codes go from HBM through shared memory into registers, and the
// dequantized pieces from registers straight into the MMA.
//
// Precision scheme (exact weights on bf16 tensor cores). Each fp32 weight
// w is split by truncation into three bf16 pieces, w1 = w & 0xFFFF0000,
// r = w - w1, w2 = r & 0xFFFF0000, w3 = r - w2 (both subtractions exact):
// w1 holds w's top 8 significant bits, w2 the next 8 of r, w3 the rest
// (at most 8 bits), so w1 + w2 + w3 = w exactly and each piece is a bf16.
// fp32 x is split the same way. With |x2| < 2^-7 |x|, |x3| < 2^-15 |x|
// (and likewise for w), the kernel accumulates six products in fp32,
// x3w1, x2w2, x1w3, x2w1, x1w2, x1w1, and drops x2w3, x3w2 and x3w3,
// whose sum is under (2^-21 + 2^-30) |x w| = 8.02 u |x w| (u = 2^-24):
// inside the summation-order bound 2 K u sum|x w| that the kernel is held
// to for every K >= 9. bf16 x is its own single piece: x (w3 + w2 + w1),
// nothing dropped. A one-hot row of x therefore reproduces w exactly: the
// accumulator takes w3, then w2 (w2 + w3 = r, exact), then w1 (r + w1 =
// w, 24 bits, exact). The 8-row tile starts each chunk of K on fresh
// accumulators, added into the running fp32 sum with a plain add, so the
// tensor core's own accumulation (aligned, truncating) spans one chunk;
// wider tiles accumulate into the running sum (registers).
// tests/test_torch_port_quant.py checks the split over every fp32
// significand and the dropped terms' bound against an fp64 emulation.
//
// The weight of code q: int8 codes become exact floats with one byte
// permute (prmt: 2^23 + (q + 128)) and one subtraction; int4 nibbles with
// one masked or (2^23 + (q + 8) 16^j for the j-th nibble of a half word)
// and one subtraction, which yields q 16^j, and the division below uses
// qmax 16^j and fl(1/qmax) 16^-j: every step is the unscaled one times a
// power of two (exact in the normal range), so the result is the same
// bits. The division by qmax is the product-and-two-fmas sequence of
// `dequant` (checked over every fp32 significand in the tests).
//
// Design (swap AB, mma.sync m16n8k16 bf16 with fp32 accumulators): the
// weight tile is the MMA's M side (16 channels a warp, 64 a CTA of 4
// warps), the rows of x its N side: all of a CTA's rows (up to 64, kNT
// n-tiles of 8) live in one tile, so each weight is dequantized once,
// into registers, and feeds every row. K streams in chunks of 64 code
// bytes a channel (64 k int8, 128 k int4). Each warp copies its own 16
// rows in bursts of kBurst chunks (128 contiguous bytes of a row, 8
// lanes a row, 16-byte cp.async: LDGSTS; rows whose bytes are not
// 16-aligned take a bounds-checked byte path) into its own kBursts-slot
// shared-memory ring, refilled as soon as a slot is read: no CTA barrier
// in the K loop, only the lane's cp.async.wait_group and a __syncwarp,
// so every warp streams on its own. Within a chunk a lane's A-fragment
// entries are 16 consecutive code bytes of each of its two channels (K
// is permuted inside the chunk to make it so; the 16-byte units are
// XOR-swizzled by the row's parity, so the reads hit distinct banks);
// x's pieces are staged once per CTA in shared memory in the matching
// B-fragment order (16-byte reads, no bank conflicts), a phase of chunks
// at a time (the only barriers; a phase's x is loaded before the codes,
// or while the phase before it computes, since loads queue behind the
// code stream). K is split over the CTAs of a thread-block cluster (1-8:
// the fewest that put four CTAs on each SM, in one wave), whose partial
// tiles are reduced in a
// fixed rank order through distributed shared memory, each rank summing
// a slice: one launch, no atomics, deterministic. More than 64 rows: more
// row tiles, adjacent in launch order to their channel tile's other row
// tiles, so the codes come again from L2.
//
// Bound: bytes at decode (codes + scales + x + y over 3.35 TB/s: 5.1 us
// for int8 4096x4096 at M = 8); the MMA operations (6 x 2MNK bf16 for fp32
// x, 3 x 2MNK for bf16 x, at 989 TFLOP/s) from about 24 rows. What bounds
// it in practice is the dequantization's instruction throughput (decode,
// product, division, split and pack: about 13 instructions a weight,
// shared by the rows; the 24 MMAs a chunk are not the limit) and each
// CTA's fixed costs (the first copies, x's staging, the cluster
// reduction).
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 12 (a)):
// int8 4096x4096 23.4 us at 1 and 8 rows (0.22 of the bound), 56.3 / 68.0
// / 90.7 us at 32 / 40 / 64 rows; lm_head (4096x32000) 121.7 us at 8
// rows; every product of the int8 decode step 67% of the replayed step's
// device time. PERF.md section 6, row 11, has every shape.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChannels = 16 * kWarps;          // output channels a CTA
constexpr int kChunkBytes = 64;                 // code bytes a channel a chunk
constexpr int kBurst = 2;                       // chunks a warp copies at once
constexpr int kBursts = 2;                      // bursts in a warp's ring
constexpr int kBurstBytes = 16 * kBurst * kChunkBytes;   // a warp's burst
constexpr int kMaxCluster = 8;
constexpr int kMaxCtasPerSm = 4;                // the split's target

// codes a lane holds a chunk (its 16 bytes), k a chunk, and 16-byte B
// units a lane, piece and n-tile a chunk (each two MMA k16 steps)
template <int kBits>
struct Shape {
  static constexpr int kLane = kBits == 8 ? 16 : 32;
  static constexpr int kChunkK = 4 * kLane;
  static constexpr int kUnits = kLane / 8;
};

template <typename XT>
struct Pieces {
  static constexpr int n = 3;
};
template <>
struct Pieces<__nv_bfloat16> {
  static constexpr int n = 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d (16 x 8, fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values' high halves as one bf16 pair (a in the low half)
__device__ __forceinline__ uint32_t pack_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// the bits of w's three truncated pieces: each piece's bf16 is the high
// half of its word (w for w1, r = w2 + w3 for w2, w3), the low half is
// ignored
__device__ __forceinline__ void split3(float w, uint32_t& p1, uint32_t& p2,
                                       uint32_t& p3) {
  const uint32_t wb = __float_as_uint(w);
  const float r = __fsub_rn(w, __uint_as_float(wb & 0xFFFF0000u));
  const uint32_t rb = __float_as_uint(r);
  p1 = wb;
  p2 = rb;
  p3 = __float_as_uint(__fsub_rn(r, __uint_as_float(rb & 0xFFFF0000u)));
}

// a / qmax correctly rounded: y0 = a * r with r = fl(1 / qmax), the exact
// remainder e = a - y0 * qmax (one fma), then y0 + e * r rounded once
// (one fma). For qmax 127 and 7 this equals a / qmax for every fp32 a:
// checked over all 2^23 significands (tests/test_torch_port_quant.py),
// which covers every exponent, the sequence being scale-invariant.
__device__ __forceinline__ float div_q(float a, float qmax, float rcp) {
  const float y0 = __fmul_rn(a, rcp);
  const float e = __fmaf_rn(-y0, qmax, a);
  return __fmaf_rn(e, rcp, y0);
}

// The weights of codes 4s..4s+3 of a lane's 16-byte slice (words w[0..3],
// already XOR-ed to offset binary) times their scales sc[0..3].
template <int kBits>
__device__ __forceinline__ void weights4(const uint32_t (&w)[4], int s,
                                         const float (&sc)[4],
                                         float (&out)[4]) {
  if (kBits == 8) {
    constexpr float kQ = 127.0f, kR = 1.0f / 127.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f = __uint_as_float(__byte_perm(w[s], 0x4B000000u,
                                                  0x7540 | e));
      out[e] = div_q(__fmul_rn(__fsub_rn(f, 8388736.0f), sc[e]), kQ, kR);
    }
  } else {
    // nibble j of the half word: f = 2^23 + (q + 8) 16^j
    const uint32_t v = (s & 1) ? (w[s >> 1] >> 16) : w[s >> 1];
    constexpr float kR = 1.0f / 7.0f;
    const float off[4] = {8388616.0f, 8388736.0f, 8390656.0f, 8421376.0f};
    const float qm[4] = {7.0f, 112.0f, 1792.0f, 28672.0f};
    const float rc[4] = {kR, kR * 0.0625f, kR * 0.00390625f,
                         kR * 0.000244140625f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f =
          __uint_as_float((v & (0xFu << (4 * e))) | 0x4B000000u);
      out[e] = div_q(__fmul_rn(__fsub_rn(f, off[e]), sc[e]), qm[e], rc[e]);
    }
  }
}

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// x's 8 values at row `row`, k .. k + 7 (zeros past m or k), as fp32
template <typename XT>
__device__ __forceinline__ void load_x8(const XT* __restrict__ x, int m,
                                        int k_total, int row, int k, bool vec,
                                        float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (row >= m || k >= k_total) return;
  const XT* p = x + (long)row * k_total + k;
  if (vec) {  // k_total % 4 == 0 and x aligned for 4 values
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k + 4 * h < k_total) {
        if constexpr (sizeof(XT) == 4) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(p) + h);
          v[4 * h] = f.x; v[4 * h + 1] = f.y;
          v[4 * h + 2] = f.z; v[4 * h + 3] = f.w;
        } else {
          const uint2 u = __ldg(reinterpret_cast<const uint2*>(p) + h);
          v[4 * h] = __uint_as_float(u.x << 16);
          v[4 * h + 1] = __uint_as_float(u.x & 0xFFFF0000u);
          v[4 * h + 2] = __uint_as_float(u.y << 16);
          v[4 * h + 3] = __uint_as_float(u.y & 0xFFFF0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (k + e < k_total) v[e] = load_x(p + e);
  }
}

// The rare paths, out of line so that the K loop's code stays small (it
// runs from the instruction cache): 16 code bytes of row o from byte b
// with bounds (rows whose length is not a multiple of 16 bytes), and the
// scales of 4 consecutive codes from k = kk of rows oa and ob (groups
// that do not span whole lane slices).
__device__ __noinline__ uint4 codes16_bounded(const uint8_t* __restrict__ q,
                                              int o, int n, long b,
                                              long row_bytes) {
  uint32_t wv[4] = {0u, 0u, 0u, 0u};
  if (o < n) {
    const uint8_t* src = q + (long)o * row_bytes;
    for (int i = 0; i < 16; ++i)
      if (b + i < row_bytes)
        wv[i >> 2] |= (uint32_t)__ldg(src + b + i) << (8 * (i & 3));
  }
  return make_uint4(wv[0], wv[1], wv[2], wv[3]);
}

__device__ __noinline__ void scales4(const float* __restrict__ scales,
                                     int oa, int ob, int n, int kk, int k,
                                     int groups, int gsize, float4* sa,
                                     float4* sb) {
  float va[4], vb[4];
  for (int e = 0; e < 4; ++e) {
    const bool ok = kk + e < k;
    va[e] = ok && oa < n ? scales[(long)oa * groups + (kk + e) / gsize] : 0.f;
    vb[e] = ok && ob < n ? scales[(long)ob * groups + (kk + e) / gsize] : 0.f;
  }
  *sa = make_float4(va[0], va[1], va[2], va[3]);
  *sb = make_float4(vb[0], vb[1], vb[2], vb[3]);
}

template <int kBits, typename XT, int kNT>
__global__ void __launch_bounds__(kThreads, kNT == 1 ? 4 : 3)
    weight_only_gemm_kernel(const XT* __restrict__ x,
                            const uint8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            XT* __restrict__ y, int m, int n, int k,
                            long row_bytes, int groups, int gsize, int vec,
                            int chunks, int phase_chunks, int csize) {
  using S = Shape<kBits>;
  constexpr int P = Pieces<XT>::n;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint4* xp = reinterpret_cast<uint4*>(smem + kWarps * kBursts * kBurstBytes);
  float* part = reinterpret_cast<float*>(xp);   // after the K loop

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)(blockIdx.x % csize);     // the cluster is along x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (blockIdx.x / csize) * 8 * kNT;
  const int nt = min(kNT, (m - m0 + 7) / 8);
  const int o0 = blockIdx.y * kChannels;
  const int ch0 = warp * 16 + g;                 // the lane's channels in
  const int oa = o0 + ch0, ob = oa + 8;          // the tile: ch0, ch0 + 8
  const int cb = rank * chunks / csize, ce = (rank + 1) * chunks / csize;

  // per-channel scales once; grouped ones a chunk (one a lane's slice
  // when a group spans whole slices, else one a code, out of line)
  const bool slice_scale = groups == 0 || gsize % S::kLane == 0;
  float sa = 0.f, sb = 0.f;
  if (groups == 0) {
    if (oa < n) sa = scales[oa];
    if (ob < n) sb = scales[ob];
  }

  // the warp's codes, a burst of kBurst chunks at a time (its 16 rows x
  // kBurst x 64 contiguous bytes, a row's bytes copied by neighbouring
  // lanes), into its ring of kBursts slots with cp.async, or byte loads
  // with bounds; 16-byte units XOR-swizzled by the row's parity, so that
  // the fragment reads (rows g and g + 1 of a quarter warp at the same
  // unit) fall on distinct banks
  uint8_t* my_ring = ring + warp * kBursts * kBurstBytes;
  auto unit_at = [](int row, int unit) {
    return row * (kBurst * kChunkBytes) + ((unit ^ ((row & 1) << 2)) << 4);
  };
  auto load_burst = [&](int bi) {
    uint8_t* slot = my_ring + (bi % kBursts) * kBurstBytes;
    const long b0 = (long)(cb + bi * kBurst) * kChunkBytes;
    long bend = (long)ce * kChunkBytes;
    if (bend > row_bytes) bend = row_bytes;
    if (b0 < bend) {
#pragma unroll
      for (int i = 0; i < kBurstBytes / 16 / 32; ++i) {
        const int u = lane + 32 * i;
        const int row = u / (kBurst * 4), unit = u % (kBurst * 4);
        const int o = o0 + warp * 16 + row;
        const long b = b0 + 16 * unit;
        uint8_t* d = slot + unit_at(row, unit);
        if (vec) {
          const bool ok = o < n && b < bend;
          cp_async16(smem_u32(d), ok ? q + (long)o * row_bytes + b : q,
                     ok ? 16 : 0);
        } else {
          *reinterpret_cast<uint4*>(d) =
              b < bend ? codes16_bounded(q, o, n, b, row_bytes)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

  // x of chunks c0 .. c0 + np - 1, split into its pieces, in B-fragment
  // order: unit ((cl * nt + j) * P + p) * kUnits + i, lane l holds the
  // bf16 pairs of row m0 + 8j + l/4, k = chunk k0 + kLane (l % 4) + 8i ..
  // +7. A thread loads a batch of kBatch units (units base + b kThreads)
  // into registers, then splits and stores them.
  constexpr int kBatch = 4;
  auto x_units = [&](int np) { return np * nt * S::kUnits * 32; };
  auto x_load = [&](int c0, int np, int base, float (&v)[kBatch][8]) {
    const int units = x_units(np);
#pragma unroll
    for (int bt = 0; bt < kBatch; ++bt) {
      const int u = base + bt * kThreads;
      const int l = u & 31, i = (u >> 5) % S::kUnits;
      const int j = (u >> 5) / S::kUnits % nt;
      const int cl = (u >> 5) / S::kUnits / nt;
      const int row = u < units ? m0 + 8 * j + (l >> 2) : m;
      const int kk = (c0 + cl) * S::kChunkK + S::kLane * (l & 3) + 8 * i;
      load_x8(x, m, k, row, kk, vec != 0, v[bt]);
    }
  };
  auto x_store = [&](int np, int base, const float (&v)[kBatch][8]) {
    const int units = x_units(np);
#pragma unroll
    for (int bt = 0; bt < kBatch; ++bt) {
      const int u = base + bt * kThreads;
      if (u >= units) break;
      const int l = u & 31, i = (u >> 5) % S::kUnits;
      const int j = (u >> 5) / S::kUnits % nt;
      const int cl = (u >> 5) / S::kUnits / nt;
      uint4* dst = xp + ((cl * nt + j) * P * S::kUnits + i) * 32 + l;
      uint32_t p1[8], p2[8], p3[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (P == 1)
          p1[e] = __float_as_uint(v[bt][e]);
        else
          split3(v[bt][e], p1[e], p2[e], p3[e]);
      }
      dst[0] = make_uint4(pack_hi(p1[0], p1[1]), pack_hi(p1[2], p1[3]),
                          pack_hi(p1[4], p1[5]), pack_hi(p1[6], p1[7]));
      if constexpr (P == 3) {
        dst[S::kUnits * 32] =
            make_uint4(pack_hi(p2[0], p2[1]), pack_hi(p2[2], p2[3]),
                       pack_hi(p2[4], p2[5]), pack_hi(p2[6], p2[7]));
        dst[2 * S::kUnits * 32] =
            make_uint4(pack_hi(p3[0], p3[1]), pack_hi(p3[2], p3[3]),
                       pack_hi(p3[4], p3[5]), pack_hi(p3[6], p3[7]));
      }
    }
  };

  float sum[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) sum[j][r] = 0.f;

  // one chunk: dequantize the lane's 2 x kLane codes into A fragments and
  // multiply them with every n-tile's x pieces. kPerCode: a scale a code
  constexpr bool kFresh = kNT == 1;
  const uint32_t flip = kBits == 8 ? 0x80808080u : 0x88888888u;
  auto chunk = [&](auto per_code, int c, const uint4 ca, const uint4 cbw,
                   const uint4* xc, float s_a, float s_b) {
    constexpr bool kPerCode = decltype(per_code)::value;
    const uint32_t wa[4] = {ca.x ^ flip, ca.y ^ flip, ca.z ^ flip,
                            ca.w ^ flip};
    const uint32_t wb[4] = {cbw.x ^ flip, cbw.y ^ flip, cbw.z ^ flip,
                            cbw.w ^ flip};
    const int kl = c * S::kChunkK + S::kLane * t;    // the lane's first k
    // the 8-row tile starts each chunk on two fresh accumulators (the
    // three small products apart from the three large ones: two short
    // MMA chains), added into the running sum in plain fp32; wider tiles
    // accumulate into the running sum (registers: 8 n-tiles)
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < S::kUnits; ++i) {
      // A fragments of steps 2i and 2i + 1, one a piece: regs 0/2 hold
      // channel ch0's codes 4s, 4s+1 / 4s+2, 4s+3; regs 1/3 channel ch0 + 8
      uint32_t A[2][3][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * i + h;
        float fa[4], fb[4];
        if constexpr (kPerCode) {
          float4 va, vb;
          scales4(scales, oa, ob, n, kl + 4 * s, k, groups, gsize, &va,
                  &vb);
          const float sca[4] = {va.x, va.y, va.z, va.w};
          const float scb[4] = {vb.x, vb.y, vb.z, vb.w};
          weights4<kBits>(wa, s, sca, fa);
          weights4<kBits>(wb, s, scb, fb);
        } else {
          const float sca[4] = {s_a, s_a, s_a, s_a};
          const float scb[4] = {s_b, s_b, s_b, s_b};
          weights4<kBits>(wa, s, sca, fa);
          weights4<kBits>(wb, s, scb, fb);
        }
        uint32_t pa[3][4], pb[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split3(fa[e], pa[0][e], pa[1][e], pa[2][e]);
          split3(fb[e], pb[0][e], pb[1][e], pb[2][e]);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          A[h][p][0] = pack_hi(pa[p][0], pa[p][1]);
          A[h][p][1] = pack_hi(pb[p][0], pb[p][1]);
          A[h][p][2] = pack_hi(pa[p][2], pa[p][3]);
          A[h][p][3] = pack_hi(pb[p][2], pb[p][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < nt) {
          uint4 B[P];
#pragma unroll
          for (int p = 0; p < P; ++p)
            B[p] = xc[((j * P + p) * S::kUnits + i) * 32];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t b0[P], b1[P];
#pragma unroll
            for (int p = 0; p < P; ++p) {
              b0[p] = h ? B[p].z : B[p].x;
              b1[p] = h ? B[p].w : B[p].y;
            }
            float (&lo)[4] = kFresh ? acc[0] : sum[j];
            float (&hi)[4] = kFresh ? acc[1] : sum[j];
            // small terms first: x3w1, x2w2, x1w3 | x2w1, x1w2, x1w1
            if constexpr (P == 3) {
              mma(lo, A[h][0], b0[2], b1[2]);
              mma(lo, A[h][1], b0[1], b1[1]);
            }
            mma(lo, A[h][2], b0[0], b1[0]);
            if constexpr (P == 3) mma(hi, A[h][0], b0[1], b1[1]);
            mma(hi, A[h][1], b0[0], b1[0]);
            mma(hi, A[h][0], b0[0], b1[0]);
          }
        }
      }
    }
    if constexpr (kFresh) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sum[0][r] = __fadd_rn(__fadd_rn(sum[0][r], acc[0][r]), acc[1][r]);
    }
  };

  // x's first batch goes out before the codes (it is needed first, and
  // loads queue behind the code stream); each later phase's first batch
  // is loaded while the phase before it computes
  float xv[kBatch][8];
  x_load(cb, min(phase_chunks, ce - cb), tid, xv);
#pragma unroll
  for (int bi = 0; bi < kBursts; ++bi) load_burst(bi);

  // phases of phase_chunks (a multiple of kBurst) chunks: x's pieces
  // staged by the CTA (the only barriers), then each warp streams the
  // phase's bursts on its own
  for (int p0 = cb; p0 < ce; p0 += phase_chunks) {
    const int p1 = min(p0 + phase_chunks, ce);
    __syncthreads();                 // every warp is done with the old x
    x_store(p1 - p0, tid, xv);
    for (int base = tid + kBatch * kThreads; base < x_units(p1 - p0);
         base += kBatch * kThreads) {
      x_load(p0, p1 - p0, base, xv);
      x_store(p1 - p0, base, xv);
    }
    __syncthreads();
    if (p1 < ce) x_load(p1, min(phase_chunks, ce - p1), tid, xv);
    for (int c0 = p0; c0 < p1; c0 += kBurst) {
      const int bi = (c0 - cb) / kBurst;
      cp_async_wait<kBursts - 1>();  // the lane's copies of burst bi
      __syncwarp();                  // and the warp's
      const uint8_t* slot = my_ring + (bi % kBursts) * kBurstBytes;
      uint4 ca[kBurst], cbw[kBurst];
      float sca[kBurst], scb[kBurst];
#pragma unroll
      for (int cc = 0; cc < kBurst; ++cc) {
        ca[cc] = *reinterpret_cast<const uint4*>(slot + unit_at(g, 4 * cc + t));
        cbw[cc] = *reinterpret_cast<const uint4*>(
            slot + unit_at(g + 8, 4 * cc + t));
        sca[cc] = sa;
        scb[cc] = sb;
        const int kl = (c0 + cc) * S::kChunkK + S::kLane * t;
        if (groups > 0 && slice_scale && c0 + cc < p1) {
          sca[cc] = (oa < n && kl < k)
                        ? scales[(long)oa * groups + kl / gsize] : 0.f;
          scb[cc] = (ob < n && kl < k)
                        ? scales[(long)ob * groups + kl / gsize] : 0.f;
        }
      }
      auto xc = [&](int cc) {
        return xp + (c0 + cc - p0) * nt * P * S::kUnits * 32 + lane;
      };
      if (c0 + kBurst <= p1 && slice_scale) {
        // a whole burst in one straight block, so that the compiler
        // interleaves one chunk's dequantization with another's MMAs
#pragma unroll
        for (int cc = 0; cc < kBurst; ++cc)
          chunk(std::false_type{}, c0 + cc, ca[cc], cbw[cc], xc(cc),
                sca[cc], scb[cc]);
      } else {
#pragma unroll
        for (int cc = 0; cc < kBurst; ++cc) {
          if (c0 + cc < p1) {
            if (slice_scale)
              chunk(std::false_type{}, c0 + cc, ca[cc], cbw[cc], xc(cc),
                    sca[cc], scb[cc]);
            else
              chunk(std::true_type{}, c0 + cc, ca[cc], cbw[cc], xc(cc),
                    sca[cc], scb[cc]);
          }
        }
      }
      __syncwarp();                  // the slot is read: refill it
      load_burst(bi + kBursts);
    }
  }
  cp_async_wait<0>();

  // the CTA's partial tile, [row][channel], then the cluster's ranks each
  // sum a slice of it over the ranks in order 0 .. csize - 1
  __syncthreads();                   // every warp is done with x's pieces
  const int elems = 8 * nt * kChannels;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 8 * j + 2 * t + (r & 1);
        part[row * kChannels + ch0 + 8 * (r >> 1)] = sum[j][r];
      }
    }
  }
  cluster.sync();
  const int lo = rank * elems / csize, hi = (rank + 1) * elems / csize;
  for (int e = lo + tid; e < hi; e += kThreads) {
    float parts[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      parts[r] = r < csize ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < csize) v = __fadd_rn(v, parts[r]);
    const int row = m0 + e / kChannels, o = o0 + e % kChannels;
    if (row < m && o < n) {
      if constexpr (sizeof(XT) == 4)
        y[(long)row * n + o] = v;
      else
        y[(long)row * n + o] = __float2bfloat16_rn(v);
    }
  }
  cluster.sync();                    // no rank leaves while read
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int kBits, typename XT, int kNT>
int launch(int vec, const void* x, const void* q, const float* scales,
           void* y, int m, int n, int k, long row_bytes, int groups,
           int gsize, cudaStream_t s) {
  using S = Shape<kBits>;
  constexpr int P = Pieces<XT>::n;
  const int chunks = (int)((row_bytes + kChunkBytes - 1) / kChunkBytes);
  const int rows_tiles = (m + 8 * kNT - 1) / (8 * kNT);
  const int ch_tiles = (n + kChannels - 1) / kChannels;
  // x's pieces a phase of chunks: at most `cap` chunks, phases balanced,
  // a whole number of bursts
  const int nt = (m < 8 * kNT ? (m + 7) / 8 : kNT);
  const int xp_chunk = nt * P * S::kUnits * 32 * 16;
  const int budget = kNT == 1 ? 24 * 1024 : 32 * 1024;
  const int cap = budget / xp_chunk / kBurst > 0
                      ? budget / xp_chunk / kBurst * kBurst : kBurst;
  const int part_bytes = 8 * nt * kChannels * (int)sizeof(float);
  auto phase_for = [&](int per_rank) {
    const int phases = (per_rank + cap - 1) / cap;
    const int even = (per_rank + phases - 1) / phases;
    return (even + kBurst - 1) / kBurst * kBurst;
  };
  auto smem_for = [&](int per_rank) {
    const int region = phase_for(per_rank) * xp_chunk;
    return (size_t)kWarps * kBursts * kBurstBytes +
           (size_t)(region > part_bytes ? region : part_bytes);
  };
  auto kernel = weight_only_gemm_kernel<kBits, XT, kNT>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_for(chunks));
  if (rc != cudaSuccess) return (int)rc;
  // K over a cluster of csize CTAs: the fewest ranks that give
  // kMaxCtasPerSm CTAs an SM (or as many as fit at once), all in one
  // wave, each rank at least two chunks
  int fit = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, kernel, kThreads, smem_for(cap));
  if (rc != cudaSuccess) return (int)rc;
  const long want = (long)sm_count() *
                    (fit < kMaxCtasPerSm ? (fit > 0 ? fit : 1)
                                         : kMaxCtasPerSm);
  const long tiles = (long)rows_tiles * ch_tiles;
  int csize = 1;
  while (csize < kMaxCluster && tiles * csize < want &&
         tiles * 2 * csize <= (long)sm_count() * (fit > 0 ? fit : 1) &&
         chunks >= 4 * csize)
    csize *= 2;
  const int per_rank = (chunks + csize - 1) / csize;
  const int phase_chunks = phase_for(per_rank);
  const size_t smem = smem_for(per_rank);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows_tiles * csize), (unsigned)ch_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = cudaLaunchKernelEx(&cfg, kernel, static_cast<const XT*>(x),
                          static_cast<const uint8_t*>(q), scales,
                          static_cast<XT*>(y), m, n, k, row_bytes, groups,
                          gsize, vec, chunks, phase_chunks, csize);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

template <int kBits, typename XT>
int by_rows(int vec, const void* x, const void* q, const float* scales,
            void* y, int m, int n, int k, long row_bytes, int groups,
            int gsize, cudaStream_t s) {
  if (m <= 8)
    return launch<kBits, XT, 1>(vec, x, q, scales, y, m, n, k, row_bytes,
                                groups, gsize, s);
  return launch<kBits, XT, 8>(vec, x, q, scales, y, m, n, k, row_bytes,
                              groups, gsize, s);
}

}  // namespace

// x (m, k) fp32 (x_dtype 0) or bf16 (1), contiguous; q (n, row_bytes)
// int8 codes (bits 8, row_bytes = k) or packed int4 (bits 4, row_bytes =
// ceil(k / 2)); scales fp32 (n,) when groups == 0, else (n, groups) with
// gsize = k / groups; y (m, n) of x's type. `vec` selects the 16-byte code
// copies and 4-wide x loads: the caller sets it only when row_bytes % 16 ==
// 0, k % 4 == 0 and the pointers are aligned for them. Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int pt_weight_only_gemm(int x_dtype, int bits, int vec,
                                   const void* x, const void* q,
                                   const void* scales, void* y, int m, int n,
                                   int k, long row_bytes, int groups,
                                   int gsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (m <= 0 || n <= 0) return 0;
  if ((bits != 8 && bits != 4) || (x_dtype != 0 && x_dtype != 1) ||
      (groups > 0 && gsize <= 0))
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return x_dtype == 0
               ? by_rows<8, float>(vec, x, q, sc, y, m, n, k, row_bytes,
                                   groups, gsize, s)
               : by_rows<8, __nv_bfloat16>(vec, x, q, sc, y, m, n, k,
                                           row_bytes, groups, gsize, s);
  return x_dtype == 0
             ? by_rows<4, float>(vec, x, q, sc, y, m, n, k, row_bytes,
                                 groups, gsize, s)
             : by_rows<4, __nv_bfloat16>(vec, x, q, sc, y, m, n, k,
                                         row_bytes, groups, gsize, s);
}
