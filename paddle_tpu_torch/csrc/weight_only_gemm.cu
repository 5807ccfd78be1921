// Weight-only quantized product for Hopper (sm_90a):
//   y[m, o] = sum_k x[m, k] * w[o, k],   w[o, k] = (q[o, k] * s) / qmax
// with int8 codes q (qmax 127) or int4 codes nibble-packed along k (two
// consecutive k a byte, the even k in the low nibble; qmax 7), and s the
// fp32 scale of output channel o (per-channel, (N,)) or of o's group of
// `gsize` consecutive k (grouped, (N, K / gsize)). The weight is computed
// element by element as `nn.quant.dequantize_array` computes it: the
// product rounded, then the correctly rounded quotient. x is
// fp32 or bf16 (read into fp32); the sum is fp32 and y has x's type.
//
// Replaces no TPU kernel: the JAX package dequantizes its serving weights
// in the decode program (`paddle_tpu/serving/quant.py` dequantize_pv,
// `nn/quant/__init__.py` dequantize_array) and XLA fuses the scale
// multiply into the GEMM's prologue, so the weights cross HBM as codes.
// Torch fuses nothing: dequantizing to fp32 and calling cuBLAS writes and
// reads the fp32 weight again (about 9x the codes' bytes for int8). This
// kernel keeps the fp32 weight out of device memory.
//
// Bound: bytes at decode (codes + scales + x + y over 3.35 TB/s: 5.1 us
// for int8 4096x4096 at M = 8), the fp32 products (2MNK at 67 TFLOP/s)
// from about 16 rows; the dequantization adds a conversion, a product
// and three FP ops per weight, shared by the M rows. Design, simple
// first: a CTA owns 32 output channels (8 row groups of 4) and up to kMT
// = 8 rows of x, with two warps a row group, each on every other chunk
// of K (16 warps: twice the warps an SM that one warp a row group gave,
// to hide the load and FP latencies). K streams in chunks of 32 lanes x
// 16 code bytes: each lane loads its 16 bytes of each of its 4 channels
// with one 16-byte load (the next chunk's loads issued before this
// chunk's arithmetic), decodes them in registers (a byte or nibble
// becomes an exact float through the 2^23 magic-number trick, no
// conversion instruction; the division by qmax through one product and
// two fmas, exact, see `dequant`), and multiplies them with the chunk of
// x, which the CTA stages in shared memory in float4 groups,
// XOR-swizzled so that a quarter warp's 16-byte reads hit 8 distinct
// bank groups; 4 channels a lane reuse each x value from a register
// four times. Every lane keeps 4 x kMT partial sums; a butterfly a
// (channel, row) reduces them over the warp, and shared memory over the
// two K slices, in a fixed order (deterministic). More rows than kMT:
// more CTAs along x of the grid (adjacent in launch order, so one tile's
// codes are re-read from L2). Shapes whose code rows or x rows are not
// 16-/4-aligned take the same kernel with element loads and bounds (kVec
// false). Measured on the H100: PERF.md section 6, row 11.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // row groups of a CTA
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kSplit = 2;                 // K slices of a CTA
constexpr int kThreads = 32 * kWarps * kSplit;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_y(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_y(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive x values from an address aligned to their size
__device__ __forceinline__ float4 load_x4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

// code e (0-based, in k order) of a 16-byte lane slice as an exact float:
// 0x4B000000 | u is the float 2^23 + u for 0 <= u < 2^23, and the code's
// offset-binary form u = code + 128 (int8) or code + 8 (int4).
template <int kBits>
__device__ __forceinline__ float code_at(const uint32_t (&w)[4], int e) {
  if (kBits == 8) {
    const uint32_t u = ((w[e >> 2] >> (8 * (e & 3))) & 0xFFu) ^ 0x80u;
    return __int_as_float(0x4B000000u | u) - 8388736.0f;
  } else {
    const uint32_t u = ((w[e >> 3] >> (4 * (e & 7))) & 0xFu) ^ 0x8u;
    return __int_as_float(0x4B000000u | u) - 8388616.0f;
  }
}

// the 16 code bytes of (channel o, byte offset b) as 4 words; zeros past
// the row or the channel count
template <bool kVec>
__device__ __forceinline__ void load_codes(uint32_t (&w)[4],
                                           const uint8_t* __restrict__ q,
                                           int o, int n, long b,
                                           long row_bytes) {
  if (o >= n || b >= row_bytes) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    return;
  }
  const uint8_t* p = q + (long)o * row_bytes + b;
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long bj = b + 4 * i + j;
        if (bj < row_bytes) word |= (uint32_t)__ldg(p + 4 * i + j) << (8 * j);
      }
      w[i] = word;
    }
  }
}

// w = (q * s) / qmax, correctly rounded like the IEEE division: y0 =
// a * r with r = fl(1 / qmax), the exact remainder e = a - y0 * qmax
// (one fma), then y0 + e * r rounded once (one fma). For qmax 127 and 7
// this equals a / qmax for every fp32 a: checked over all 2^23
// significands (tests/test_torch_port_quant.py), which covers every
// exponent, the sequence being scale-invariant.
template <int kBits>
__device__ __forceinline__ float dequant(float code, float s) {
  constexpr float kQmax = kBits == 8 ? 127.0f : 7.0f;
  constexpr float kRcp = 1.0f / kQmax;
  const float a = __fmul_rn(code, s);
  const float y0 = __fmul_rn(a, kRcp);
  const float e = __fmaf_rn(-y0, kQmax, a);
  return __fmaf_rn(e, kRcp, y0);
}

template <int kBits, int kMT, typename XT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    weight_only_gemm_kernel(const XT* __restrict__ x,
                            const uint8_t* __restrict__ q,
                            const float* __restrict__ scales,
                            XT* __restrict__ y, int m, int n, int k,
                            long row_bytes, int groups, int gsize) {
  constexpr int kCodes = kBits == 8 ? 16 : 32;     // k a lane's 16 bytes
  constexpr int kChunk = 32 * kCodes;              // k a chunk
  constexpr int kGroups4 = kChunk / 4;             // float4 groups a row
  extern __shared__ float4 xs[];                   // kSplit chunks of x

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = warp / kWarps;                  // the warp's K slice
  const int m0 = blockIdx.x * kMT;
  const int o0 = blockIdx.y * kRowsPerCta + (warp % kWarps) * kRowsPerWarp;
  const int chunks = (k + kChunk - 1) / kChunk;
  const int steps = (chunks + kSplit - 1) / kSplit;
  float4* my_xs = xs + half * kMT * kGroups4;

  float acc[kRowsPerWarp][kMT];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kMT; ++i) acc[r][i] = 0.f;

  float chan_scale[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    chan_scale[r] = (groups == 0 && o0 + r < n) ? scales[o0 + r] : 0.f;

  uint32_t cur[kRowsPerWarp][4], nxt[kRowsPerWarp][4];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    load_codes<kVec>(cur[r], q, o0 + r, n,
                     (long)half * (kChunk * kBits / 8) + 16L * lane,
                     row_bytes);

  for (int t = 0; t < steps; ++t) {
    const int c = t * kSplit + half;               // this warp's chunk
    const int k0 = c * kChunk;
    if (t + 1 < steps) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        load_codes<kVec>(nxt[r], q, o0 + r, n,
                         (long)(c + kSplit) * (kChunk * kBits / 8)
                             + 16L * lane, row_bytes);
    }
    __syncthreads();             // the previous chunks' reads are done
    for (int idx = threadIdx.x; idx < kSplit * kMT * kGroups4;
         idx += kThreads) {
      const int hc = idx / (kMT * kGroups4);
      const int mi = (idx / kGroups4) % kMT, g = idx % kGroups4;
      const int kk = (t * kSplit + hc) * kChunk + 4 * g;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + mi < m) {
        const XT* row = x + (long)(m0 + mi) * k;
        if (kVec) {
          if (kk < k) v = load_x4(row + kk);
        } else {
          if (kk < k) v.x = load_x(row + kk);
          if (kk + 1 < k) v.y = load_x(row + kk + 1);
          if (kk + 2 < k) v.z = load_x(row + kk + 2);
          if (kk + 3 < k) v.w = load_x(row + kk + 3);
        }
      }
      xs[(hc * kMT + mi) * kGroups4 + (g ^ ((g >> 3) & 7))] = v;
    }
    __syncthreads();

    const int kl = k0 + lane * kCodes;     // the lane's first k
    float sc[kRowsPerWarp] = {};
    const bool slice_scale = groups == 0 || gsize % kCodes == 0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (groups == 0) {
        sc[r] = chan_scale[r];
      } else if (slice_scale) {
        sc[r] = (o0 + r < n && kl < k)
                    ? scales[(long)(o0 + r) * groups + kl / gsize] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kCodes / 4; ++i) {
      const int g = lane * (kCodes / 4) + i;
      float wv[kRowsPerWarp][4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[r];
          if (!slice_scale) {
            const int kk = kl + 4 * i + e;
            s = (o0 + r < n && kk < k)
                    ? scales[(long)(o0 + r) * groups + kk / gsize] : 0.f;
          }
          wv[r][e] = dequant<kBits>(code_at<kBits>(cur[r], 4 * i + e), s);
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const float4 xv = my_xs[mi * kGroups4 + (g ^ ((g >> 3) & 7))];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          float a = acc[r][mi];
          a = fmaf(xv.x, wv[r][0], a);
          a = fmaf(xv.y, wv[r][1], a);
          a = fmaf(xv.z, wv[r][2], a);
          a = fmaf(xv.w, wv[r][3], a);
          acc[r][mi] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) cur[r][j] = nxt[r][j];
  }

  // each warp's sums over its lanes, then the K slices' sums over the
  // warps through shared memory (slice 0 adds the others in order)
  __syncthreads();
  float* part = reinterpret_cast<float*>(xs);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      float v = acc[r][mi];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][mi] = v;
      const int slot = ((warp % kWarps) * kRowsPerWarp + r) * kMT + mi;
      if (half > 0 && lane == ((r * kMT + mi) & 31))
        part[(half - 1) * kRowsPerCta * kMT + slot] = v;
    }
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int slot = ((warp % kWarps) * kRowsPerWarp + r) * kMT + mi;
        const int o = o0 + r, row = m0 + mi;
        if (lane == ((r * kMT + mi) & 31) && o < n && row < m) {
          float v = acc[r][mi];
          for (int h = 1; h < kSplit; ++h)
            v += part[(h - 1) * kRowsPerCta * kMT + slot];
          store_y(y + (long)row * n + o, v);
        }
      }
    }
  }
}

template <int kBits, int kMT, typename XT, bool kVec>
int launch(const void* x, const void* q, const float* scales, void* y, int m,
           int n, int k, long row_bytes, int groups, int gsize,
           cudaStream_t s) {
  constexpr int kChunk = 32 * (kBits == 8 ? 16 : 32);
  constexpr size_t kSmem = sizeof(float4) * kSplit * kMT * (kChunk / 4);
  static_assert(sizeof(float) * (kSplit - 1) * kRowsPerCta * kMT <= kSmem,
                "the partial sums reuse the x staging buffer");
  auto kernel = weight_only_gemm_kernel<kBits, kMT, XT, kVec>;
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)((m + kMT - 1) / kMT),
                  (unsigned)((n + kRowsPerCta - 1) / kRowsPerCta));
  kernel<<<grid, kThreads, kSmem, s>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(q), scales,
      static_cast<XT*>(y), m, n, k, row_bytes, groups, gsize);
  return (int)cudaGetLastError();
}

template <int kBits, typename XT, bool kVec>
int by_rows(const void* x, const void* q, const float* scales, void* y, int m,
            int n, int k, long row_bytes, int groups, int gsize,
            cudaStream_t s) {
  if (m == 1)
    return launch<kBits, 1, XT, kVec>(x, q, scales, y, m, n, k, row_bytes,
                                      groups, gsize, s);
  return launch<kBits, 8, XT, kVec>(x, q, scales, y, m, n, k, row_bytes,
                                    groups, gsize, s);
}

template <int kBits, typename XT>
int by_layout(int vec, const void* x, const void* q, const float* scales,
              void* y, int m, int n, int k, long row_bytes, int groups,
              int gsize, cudaStream_t s) {
  if (vec)
    return by_rows<kBits, XT, true>(x, q, scales, y, m, n, k, row_bytes,
                                    groups, gsize, s);
  return by_rows<kBits, XT, false>(x, q, scales, y, m, n, k, row_bytes,
                                   groups, gsize, s);
}

}  // namespace

// x (m, k) fp32 (x_dtype 0) or bf16 (1), contiguous; q (n, row_bytes)
// int8 codes (bits 8, row_bytes = k) or packed int4 (bits 4, row_bytes =
// ceil(k / 2)); scales fp32 (n,) when groups == 0, else (n, groups) with
// gsize = k / groups; y (m, n) of x's type. `vec` selects the 16-byte code
// loads and 4-wide x loads: the caller sets it only when row_bytes % 16 ==
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
               ? by_layout<8, float>(vec, x, q, sc, y, m, n, k, row_bytes,
                                     groups, gsize, s)
               : by_layout<8, __nv_bfloat16>(vec, x, q, sc, y, m, n, k,
                                             row_bytes, groups, gsize, s);
  return x_dtype == 0
             ? by_layout<4, float>(vec, x, q, sc, y, m, n, k, row_bytes,
                                   groups, gsize, s)
             : by_layout<4, __nv_bfloat16>(vec, x, q, sc, y, m, n, k,
                                           row_bytes, groups, gsize, s);
}
