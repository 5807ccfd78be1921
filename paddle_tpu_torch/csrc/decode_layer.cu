// The decode-layer megakernel for Hopper (sm_90a): one cooperative launch
// per Llama decode layer per decode step, over every slot at once.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_layer.py
// `_mega_kernel` (pallas_call in `decode_layer_paged_kernel`), for the
// fp32 arena (mode "paged") and the int8 arena ("paged_int8"). For S
// slots of hidden state x (S, d) it computes, after the torch prologue
// has normalised x (r1 = RMSNorm #1) and written this step's k and v into
// the arena (ops/decode_layer.py): the q product and RoPE, paged
// attention over each slot's block table (int8 codes dequantized in
// registers), the o product and residual #1, RMSNorm #2, SwiGLU (gate and
// up products), the down product and residual #2. Weights are the (out,
// in) rows of nn.Linear, fp32, streamed from device memory.
//
// Why not the TPU shape: the TPU runs a grid of (S, max_blocks) with one
// slot's whole weight set resident in VMEM. At Llama-2-7B width that set
// is 675.3 MB a layer, and on this card the shape would stream it once
// per slot on only S CTAs. Here every weight byte is read once per step
// for all S slots.
//
// Bound: bytes. Per layer the weights (4 * (2 d^2 + 3 d ff), 675.3 MB at
// 7B width: 0.2016 ms at 3.35 TB/s) plus the KV of the step; the products
// are GEMV-shaped (S <= 32 columns).
//
// Design. A persistent grid (the occupancy limit times the SM count,
// launched with cudaLaunchCooperativeKernel) runs five phases separated
// by grid-wide barriers (cooperative_groups::this_grid().sync()):
//   A  q = r1 Wq^T
//   B  attn = paged attention of RoPE(q)  (units: slot, head, table chunk)
//   C  h1 = x + attn Wo^T                 (and each slot's sum of h1^2)
//   D  act = silu(rms2(h1) Wg^T) * (rms2(h1) Wu^T)
//   E  out = h1 + act Wd^T
// The intermediates live in a few MB of device scratch, which L2 holds.
//
// A CTA is eight warps, two warpgroups. A product phase is split-K: a
// work item is (a band of 128 weight rows, one K-slice); the host plans
// the slices so that the items fill the grid (ops/decode_layer.py
// `product_plan`). A CTA copies its item's slice of the S input rows
// into shared memory with cp.async in chunks, two deep, so the next chunk
// lands while this one is multiplied, splits each chunk once into TF32
// hi and lo parts, and each warpgroup runs 64 weight rows against it on
// the tensor cores: wgmma m64nNk8 TF32 (N = 8, 16, 24 or 32 slots) with
// fp32 accumulators in registers, the weight rows as the register A
// operand and the staged slots as the shared-memory B operand, in the
// 3xTF32 split a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi (hi = tf32(x)
// rounded to nearest, lo = tf32(x - hi)), which drops only lo * lo,
// about 2^-22 of each term. A k-permutation shared by A and B lets lane
// (g, t) read 32 contiguous bytes of a weight row per 32 k: two 16-byte
// loads straight from device memory into the A fragments, the next 32 k
// in flight while this 32 k is multiplied; the staged chunk is written
// in the permuted order. Sharing one staged slice among 128 rows keeps
// the L2 traffic of staging at S / 128 of the weight bytes. An item
// writes its fp32 partial sums to scratch and takes a ticket (an integer
// atomic per band); the item that takes the last one sums the band's
// K-slices in slice order and runs the epilogue: residual #1 and the sum
// of squares of h1 (C), rsqrt and silu(g) u (D), residual #2 (E). Fixed
// orders and no float atomics: two launches give bit-identical outputs.
// RMSNorm #2 folds into the products: D scales h1 by ln2 as it splits
// the staged rows and its epilogue by rstd = rsqrt(sum h1^2 / d + eps).
//
// The attention phase is the paged-decode body of csrc/paged_decode.cuh,
// shared with csrc/paged_attention.cu, two units at a time per CTA, with
// RoPE applied to q as it is loaded and the split table walk (chunks of
// table entries, merged by the last unit of each item). Sums run in
// another order than torch's, so results agree with the plain version to
// fp32 rounding, not bit for bit.
//
// Measurement hook: with a stamps pointer, thread 0 of CTA 0 records
// %globaltimer at entry, after each phase's grid barrier and after one
// more barrier at the end (the serving path passes null).
#include <cooperative_groups.h>

#include "paged_decode.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pt_paged;

constexpr int kSMax = 32;            // slots the kernel takes
constexpr int kCtaWarps = 8;         // a CTA: two attention units' warps
constexpr int kCtaThreads = 32 * kCtaWarps;
constexpr int kBand = 16 * kCtaWarps;  // weight rows of a work item
constexpr int kStageFloats = 6144;   // a staged chunk: sp x kc floats
constexpr int kMinBlocks = 2;        // CTAs an SM (launch bounds)
constexpr int kPad = 4;              // staged row padding (no bank clash)
// K/V rows in flight a lane in the attention phase over the int8 arena:
// its rows are dequantized in registers, and two (not four) keep the
// phase within the registers of two CTAs an SM (measured on the H100)
constexpr int kInt8Rows = 2;

// The split-K plan of one product: `bands` bands of output rows times
// `ks` K-slices of `kslice` columns (the last may be shorter).
struct Prod {
  int bands, ks, kslice;
};

struct Params {
  int S, sp, nt, d, hd, h, kvh, dh, ff, bs, mb, kc;
  float eps2, scale;
  Prod pa, pc, pd, pe;
  Split split;           // the attention phase's table walk
  const float* x;        // (S, d) layer input
  const float* r1;       // (S, d) RMSNorm #1 of x (the prologue's)
  const float* cos;      // (S, dh) at each slot's position
  const float* sin;
  const int* table;      // (S, mb)
  const int* lengths;    // (S,) = pos + 1
  const float* wq;       // (hd, d)
  const float* wo;       // (d, hd)
  const float* ln2;      // (d,)
  const float* wg;       // (ff, d)
  const float* wu;       // (ff, d)
  const float* wd;       // (d, ff)
  float* q;              // scratch (S, hd)
  float* attn;           // scratch (S, hd)
  float* h1;             // scratch (S, d)
  float* act;            // scratch (S, ff)
  float* sq;             // scratch (C bands, S): sums of h1^2 per band
  float* part;           // scratch: the products' partial sums
  int* work;             // zeroed: the attention phase's unit counter
  int* tickets;          // zeroed, one per band (and per attention item)
  float* out;            // (S, d)
  unsigned long long* stamps;  // (6,) %globaltimer stamps, or null
};

__device__ __forceinline__ void stamp(unsigned long long* stamps, int i) {
  if (stamps && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// q of the scratch, rotated (neox rotate-half) as it is read: the RoPE of
// the JAX kernel's first grid step, x * cos + rot(x) * sin.
struct QRope {
  const float* q;
  const float* cos;
  const float* sin;
  __device__ __forceinline__ float operator()(int slot, int head, int i,
                                              int h, int d) const {
    const float* qh = q + ((size_t)slot * h + head) * d;
    const int half = d >> 1;
    const float x = __ldcg(qh + i);
    const float r = i < half ? -__ldcg(qh + i + half) : __ldcg(qh + i - half);
    return x * cos[slot * d + i] + r * sin[slot * d + i];
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// TF32 with round to nearest (ties away from zero): the 13 low mantissa
// bits cleared after adding half of their range, as the hardware's cvt
// does it. On the bits alone the add would carry a NaN's mantissa (CUDA's
// 0x7fffffff) into the sign and return a zero, so a NaN activation
// would enter the products as 0 and the serving NaN sentinel would never
// see it; cvt keeps a NaN a NaN, and is one instruction.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}


// ---- wgmma, TF32 ------------------------------------------------------------

// Shared-memory descriptor of a K-major B operand without swizzle: core
// matrices of 8 rows x 16 bytes (4 tf32) stored as 128 contiguous bytes,
// `lbo` bytes between the two core matrices along K, `sbo` bytes between
// 8-row groups.
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;   // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy made visible to wgmma's
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns the registers.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
}

// d(64 x 8 NT) += A(64 x 8, registers) B(8 x 8 NT, shared memory), TF32
// with fp32 accumulators. Per warp w of the warpgroup the fragments are
// those of mma.m16n8k8 over rows 16w .. 16w + 15: a0 (row g, k t), a1
// (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4); d[4n +
// e] at row g + 8 (e >= 2), column 8n + 2t + e % 2 (g = lane / 4,
// t = lane % 4).
template <int NT>
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b);
template <>
__device__ __forceinline__ void wgmma_tf32<1>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<2>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<3>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_tf32<4>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Copy columns [k0, k0 + kl) of the S rows of src (row stride K) into xs
// (row stride kc + kPad) with cp.async through L2 (src may have been
// written earlier in this launch), as one commit group; rows S..sp-1 and
// the columns up to the next multiple of 32 are zero-filled.
__device__ __forceinline__ void stage_async(const float* src, int S, int sp,
                                            int K, int k0, int kl, int kc,
                                            float* xs) {
  const int nv = ((kl + 31) & ~31) >> 2;  // float4 columns
  const int stride = kc + kPad;
  for (int i = threadIdx.x; i < sp * nv; i += kCtaThreads) {
    const int s = i / nv, c = (i - s * nv) * 4;
    const bool ok = s < S && c < kl;
    const float* from = ok ? src + (size_t)s * K + k0 + c : src;
    const unsigned to =
        (unsigned)__cvta_generic_to_shared(xs + s * stride + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(to), "l"(from), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The TF32 split of a staged chunk, once for all the CTA's warps, in the
// layout of wgmma's B operand: x = raw (times ln[k0 + c] with ln) of the
// sp rows and ceil32(kl) columns goes to xh = tf32(x) and xl = tf32(x -
// xh) as [32-column block b][step j][k half f][8-row group][row][4],
// where step j of block b takes columns 8i + 4f + j (i = 0..3) of the
// block: the k-permutation of the A fragments. One step is then a K-major
// operand of core matrices 16 * sp bytes apart along K and 128 bytes
// apart along the rows.
__device__ __forceinline__ void split_chunk(const float* raw, int sp, int kl,
                                            int kc, const float* ln, int k0,
                                            float* xh, float* xl) {
  const int nv = ((kl + 31) & ~31) >> 2;  // float4 columns
  const int stride = kc + kPad;
  for (int i = threadIdx.x; i < sp * nv; i += kCtaThreads) {
    const int s = i % sp, c = (i / sp) * 4;
    float4 v = *reinterpret_cast<const float4*>(raw + s * stride + c);
    if (ln && c < kl) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(ln + k0 + c));
      v.x *= w.x;
      v.y *= w.y;
      v.z *= w.z;
      v.w *= w.w;
    }
    // columns c .. c + 3: block c / 32, i = (c % 32) / 8, f = (c % 8) / 4,
    // steps j = 0 .. 3
    const int blk = c >> 5, ii = (c >> 3) & 3, f = (c >> 2) & 1;
    const int base = ((blk * 4) * 2 + f) * sp * 4 + s * 4 + ii;
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t hi, lo;
      split3(x[j], hi, lo);
      const int o = base + j * 2 * sp * 4;
      reinterpret_cast<uint32_t*>(xh)[o] = hi;
      reinterpret_cast<uint32_t*>(xl)[o] = lo;
    }
  }
}

// One split-K product phase: the partial sums of the S rows of src (S, K)
// against the rows of W0 (N, K), or with PAIR of W0 and W1 (the gate and
// up products: a band is 64 rows of each, warpgroup 0 on W0 and 1 on
// W1); with ln, src is scaled by ln[k] (RMSNorm's weight) as it is read.
// Each of the two warpgroups runs 64 weight rows with wgmma. A CTA walks
// its items' K-slices in chunks of kc columns through two staging
// buffers (the more rows share one staged slice, the less of it crosses
// L2): the copy of the next chunk (of this item or the next) runs while
// this one is multiplied. An item's partials go to part[ks][band][s][128];
// the item that finishes a band last hands it to reduce(band), which
// reads them back in slice order.
template <int NT, bool PAIR, typename Reduce>
__device__ __forceinline__ void product_nt(const Params& p, const Prod& P,
                                           const float* src, int K,
                                           const float* ln, const float* W0,
                                           const float* W1, int N,
                                           float* smem,
                                           const Reduce& reduce) {
  __shared__ int last_item;
  const int stride = p.kc + kPad;
  float* const xs0 = smem;                   // raw chunks, two deep
  float* const xs1 = smem + p.sp * stride;
  float* const xh = smem + 2 * p.sp * stride;  // the chunk's TF32 split
  float* const xl = smem + 3 * p.sp * stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int items = P.bands * P.ks;
  auto slice_end = [&](int item) {
    return min((item % P.ks + 1) * P.kslice, K);
  };
  int it = blockIdx.x;
  int c0 = it < items ? (it % P.ks) * P.kslice : 0;
  if (it < items)
    stage_async(src, p.S, p.sp, K, c0, min(p.kc, slice_end(it) - c0), p.kc,
                xs0);
  bool odd = false;
  float acc[16];
  const float* wr[2] = {W0, W0};
  bool rv[2] = {false, false};
  while (it < items) {
    const int band = it / P.ks, ks = it - band * P.ks;
    const int ke = slice_end(it);
    if (c0 == ks * P.kslice) {       // an item's first chunk
      const float* W = PAIR && warp >= kCtaWarps / 2 ? W1 : W0;
      const int r0 =
          PAIR ? band * (kBand / 2) + (warp % (kCtaWarps / 2)) * 16
               : band * kBand + warp * 16;
      // rows r0 + g (fragment half 0) and r0 + 8 + g (half 1) of W
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh + g;
        rv[hh] = row < N;
        wr[hh] = W + (size_t)(rv[hh] ? row : 0) * K;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    }
    // lane (g, t) reads columns k + 8t .. k + 8t + 7 of its rows: the
    // k-permutation under which step j takes columns 8t + j (a0, a1) and
    // 8t + 4 + j (a2, a3)
    float4 wa[2][2];
    auto load = [&](int k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int off = k + 8 * t + 4 * f;
          wa[hh][f] = rv[hh] && off < ke
                          ? __ldcs(reinterpret_cast<const float4*>(wr[hh] +
                                                                   off))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    };
    const int kl = min(p.kc, ke - c0), nb = (kl + 31) >> 5;
    load(c0);                        // in flight while the copy lands
    // the next chunk: of this item, or the first of the next one
    int nit = it, nc0 = c0 + p.kc;
    if (nc0 >= ke) {
      nit = it + gridDim.x;
      nc0 = nit < items ? (nit % P.ks) * P.kslice : 0;
    }
    stage_wait();
    __syncthreads();   // this chunk landed; the other buffer, xh and xl
                       // are free
    if (nit < items)
      stage_async(src, p.S, p.sp, K, nc0, min(p.kc, slice_end(nit) - nc0),
                  p.kc, odd ? xs0 : xs1);
    split_chunk(odd ? xs1 : xs0, p.sp, kl, p.kc, ln, c0, xh, xl);
    fence_proxy_async();
    __syncthreads();
    const uint32_t lbo = 16 * p.sp;   // bytes between the two k halves
    for (int b = 0; b < nb; ++b) {
      uint32_t ah[4][4], al[4][4];   // [step j][a0..a3]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split3(comp(wa[0][0], j), ah[j][0], al[j][0]);
        split3(comp(wa[1][0], j), ah[j][1], al[j][1]);
        split3(comp(wa[0][1], j), ah[j][2], al[j][2]);
        split3(comp(wa[1][1], j), ah[j][3], al[j][3]);
      }
      if (b + 1 < nb) load(c0 + 32 * (b + 1));
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (b * 4 + j) * 2 * p.sp * 4;
        const uint64_t dh = desc_plain(xh + o, lbo, 128);
        const uint64_t dl = desc_plain(xl + o, lbo, 128);
        wgmma_tf32<NT>(acc, al[j], dh);
        wgmma_tf32<NT>(acc, ah[j], dl);
        wgmma_tf32<NT>(acc, ah[j], dh);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ah);
      fence_regs(al);
    }
    if (c0 + p.kc >= ke) {           // the item's last chunk
      // its partial sums: d[4n + e] at row g + 8 (e >= 2) of the warp's
      // 16, slot 8n + 2t + e % 2
      float* pp = p.part + ((size_t)ks * P.bands + band) * p.S * kBand;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = warp * 16 + g + (e >= 2 ? 8 : 0);
          const int s = n * 8 + 2 * t + (e & 1);
          if (s < p.S) pp[s * kBand + lr] = acc[4 * n + e];
        }
      // the ticket: the last item of a band reduces it
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0)
        last_item = atomicAdd(p.tickets + band, 1) == P.ks - 1;
      __syncthreads();
      if (last_item) {
        __threadfence();
        reduce(band);
        if (threadIdx.x == 0) p.tickets[band] = 0;
      }
    }
    it = nit;
    c0 = nc0;
    odd = !odd;
  }
}

// product_nt for the slots' count of 8-slot tiles (a uniform branch).
template <bool PAIR, typename Reduce>
__device__ __forceinline__ void product(const Params& p, const Prod& P,
                                        const float* src, int K,
                                        const float* ln, const float* W0,
                                        const float* W1, int N, float* smem,
                                        const Reduce& reduce) {
  switch (p.nt) {
    case 1:
      product_nt<1, PAIR>(p, P, src, K, ln, W0, W1, N, smem, reduce);
      break;
    case 2:
      product_nt<2, PAIR>(p, P, src, K, ln, W0, W1, N, smem, reduce);
      break;
    case 3:
      product_nt<3, PAIR>(p, P, src, K, ln, W0, W1, N, smem, reduce);
      break;
    default:
      product_nt<4, PAIR>(p, P, src, K, ln, W0, W1, N, smem, reduce);
  }
}

// Sum of a band's K-slices of partial rows lr .. lr + 3 for slot s, in
// slice order (four slices' loads in flight at a time).
__device__ __forceinline__ float4 slices(const Params& p, const Prod& P,
                                         int band, int s, int lr) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p.part + ((size_t)band * p.S + s) * kBand + lr;
  const size_t step = (size_t)P.bands * p.S * kBand;
#pragma unroll 4
  for (int ks = 0; ks < P.ks; ++ks) {
    const float4 w = __ldcg(reinterpret_cast<const float4*>(q + ks * step));
    v.x += w.x;
    v.y += w.y;
    v.z += w.z;
    v.w += w.w;
  }
  return v;
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <typename KV>
__global__ void __launch_bounds__(kCtaThreads, kMinBlocks)
    decode_layer_kernel(Params p, KV kv) {
  extern __shared__ float smem[];
  __shared__ float rstd[kSMax];
  __shared__ int unit[2];
  cg::grid_group grid = cg::this_grid();
  const int S = p.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stamp(p.stamps, 0);

  // A: q = r1 Wq^T. Reducers of a band of 128 columns: warp w takes
  // slots w, w + 8, ...; lane l the float4 of columns 4l .. 4l + 3.
  product<false>(p, p.pa, p.r1, p.d, nullptr, p.wq, nullptr, p.hd, smem,
                 [&](int band) {
                   const int n = band * kBand + 4 * lane;
                   if (n < p.hd)
                     for (int s = warp; s < S; s += kCtaWarps)
                       *reinterpret_cast<float4*>(p.q + (size_t)s * p.hd +
                                                  n) =
                           slices(p, p.pa, band, s, 4 * lane);
                 });
  grid.sync();
  stamp(p.stamps, 1);

  // B: attention of RoPE(q) over each slot's blocks, into attn. The CTA
  // runs two units at a time, one per half (four warps, a named barrier
  // each); units (item, chunk) are handed out by a counter, so the
  // ragged ones balance.
  {
    const QRope qload{p.q, p.cos, p.sin};
    const int half = threadIdx.x / kThreads;
    const UnitThreads threads{half + 1};
    float* hsmem = smem + half * item_smem_floats<1>(p.dh);
    const int nc = p.split.nc;
    const int units = S * p.h * nc;   // G = 1: one query head per item
    for (;;) {
      if (threads.tid() == 0) unit[half] = atomicAdd(p.work, 1);
      threads.sync();
      const int u = unit[half];       // decode_item ends in a barrier
      if (u >= units) break;
      decode_item<float, KV, 1, KV::kInt8 ? kInt8Rows : 4>(
          u / nc, u % nc, p.split, qload, kv, p.table, p.lengths, p.attn,
          p.h, p.kvh, p.dh, p.bs, p.mb, p.scale, hsmem, threads);
    }
  }
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.work = 0;
  stamp(p.stamps, 2);

  // C: h1 = x + attn Wo^T, and each slot's sum of h1^2 over the band (a
  // warp holds a slot's 128 columns)
  product<false>(p, p.pc, p.attn, p.hd, nullptr, p.wo, nullptr, p.d, smem,
                 [&](int band) {
                   const int n = band * kBand + 4 * lane;
                   for (int s = warp; s < S; s += kCtaWarps) {
                     float sq = 0.f;
                     if (n < p.d) {
                       const size_t o = (size_t)s * p.d + n;
                       const float4 v = add4(
                           *reinterpret_cast<const float4*>(p.x + o),
                           slices(p, p.pc, band, s, 4 * lane));
                       *reinterpret_cast<float4*>(p.h1 + o) = v;
                       sq = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
                     }
                     sq = warp_sum(sq);
                     if (lane == 0) p.sq[band * S + s] = sq;
                   }
                 });
  grid.sync();
  stamp(p.stamps, 3);

  // D: act = silu(g) * u with g, u = rms2(h1) Wg^T, rms2(h1) Wu^T: the
  // products of h1 * ln2, scaled by rstd in the reduction. Each CTA
  // first sums each slot's squares over the o product's bands in a
  // fixed order: warp w the bands w, w + 8, ..., then the eight warps.
  {
    float ss = 0.f;
    if (lane < S) {
#pragma unroll 8
      for (int b = warp; b < p.pc.bands; b += kCtaWarps)
        ss += __ldcg(p.sq + b * S + lane);
    }
    float* part_ss = smem;           // (kCtaWarps, kSMax)
    part_ss[warp * kSMax + lane] = ss;
    __syncthreads();
    if (threadIdx.x < S) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kCtaWarps; ++w)
        t += part_ss[w * kSMax + threadIdx.x];
      rstd[threadIdx.x] = rsqrtf(t / (float)p.d + p.eps2);
    }
    __syncthreads();
  }
  product<true>(p, p.pd, p.h1, p.d, p.ln2, p.wg, p.wu, p.ff, smem,
                [&](int band) {
                  // 16 threads hold a slot's 64 gate and 64 up columns
                  const int c16 = threadIdx.x & 15, s16 = threadIdx.x >> 4;
                  const int n = band * (kBand / 2) + 4 * c16;
                  if (n < p.ff)
                    for (int s = s16; s < S; s += kCtaThreads / 16) {
                      const float r = rstd[s];
                      const float4 g4 = slices(p, p.pd, band, s, 4 * c16);
                      const float4 u4 =
                          slices(p, p.pd, band, s, kBand / 2 + 4 * c16);
                      const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
                      const float us[4] = {u4.x, u4.y, u4.z, u4.w};
                      float a[4];
#pragma unroll
                      for (int e = 0; e < 4; ++e) {
                        const float gr = gs[e] * r, ur = us[e] * r;
                        a[e] = gr / (1.f + expf(-gr)) * ur;
                      }
                      *reinterpret_cast<float4*>(p.act + (size_t)s * p.ff +
                                                 n) =
                          make_float4(a[0], a[1], a[2], a[3]);
                    }
                });
  grid.sync();
  stamp(p.stamps, 4);

  // E: out = h1 + act Wd^T
  product<false>(p, p.pe, p.act, p.ff, nullptr, p.wd, nullptr, p.d, smem,
                 [&](int band) {
                   const int n = band * kBand + 4 * lane;
                   if (n < p.d)
                     for (int s = warp; s < S; s += kCtaWarps) {
                       const size_t o = (size_t)s * p.d + n;
                       *reinterpret_cast<float4*>(p.out + o) = add4(
                           __ldcg(reinterpret_cast<const float4*>(p.h1 + o)),
                           slices(p, p.pe, band, s, 4 * lane));
                     }
                 });
  if (p.stamps) {
    grid.sync();
    stamp(p.stamps, 5);
  }
}

// Slots padded to whole n-tiles of 8, and the staged chunk of K.
int padded_slots(int S) { return (S + 7) & ~7; }
int stage_chunk(int sp) { return (kStageFloats / sp) & ~31; }

size_t smem_bytes(int S, int dh) {
  const int sp = padded_slots(S);
  // two raw chunks and the split of one
  const size_t stage = 4 * (size_t)sp * (stage_chunk(sp) + kPad);
  const size_t item = 2 * item_smem_floats<1>(dh);   // two units
  return sizeof(float) * (stage > item ? stage : item);
}

// Shared memory attribute and occupancy of one instance: the grid size
// of a cooperative launch (CTAs that fit at once), or a CUDA error < 0.
template <typename KV>
int grid_size(size_t smem) {
  auto kernel = decode_layer_kernel<KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kCtaThreads, smem)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return per_sm * sms;
}

bool valid_prod(const Prod& P, int N, int K, int rows) {
  return P.bands == (N + rows - 1) / rows && P.ks >= 1 && P.kslice >= 32 &&
         P.kslice % 32 == 0 && (long long)P.ks * P.kslice >= K &&
         (long long)(P.ks - 1) * P.kslice < K;
}

template <typename KV>
int launch(Params p, KV kv, const int* plan, cudaStream_t stream,
           int* grid_out) {
  const int lpp = p.dh / KV::V;
  if (p.S < 1 || p.S > kSMax || p.dh % KV::V || lpp > 32 ||
      (lpp & (lpp - 1)) || p.kvh <= 0 || p.h % p.kvh || p.dh % 2 ||
      p.d % 4 || p.hd % 4 || p.ff % 4 || p.hd != p.h * p.dh || !plan)
    return (int)cudaErrorInvalidValue;
  p.sp = padded_slots(p.S);
  p.nt = p.sp / 8;
  p.kc = stage_chunk(p.sp);
  p.pa = {plan[0], plan[1], plan[2]};
  p.pc = {plan[3], plan[4], plan[5]};
  p.pd = {plan[6], plan[7], plan[8]};
  p.pe = {plan[9], plan[10], plan[11]};
  p.split.ce = plan[12];
  p.split.nc = plan[13];
  p.split.part = p.part;
  p.split.tickets = p.tickets;
  if (!valid_prod(p.pa, p.hd, p.d, kBand) ||
      !valid_prod(p.pc, p.d, p.hd, kBand) ||
      !valid_prod(p.pd, p.ff, p.d, kBand / 2) ||
      !valid_prod(p.pe, p.d, p.ff, kBand) || p.split.ce < 1 ||
      p.split.nc < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.S, p.dh);
  const int grid = grid_size<KV>(smem);
  if (grid < 0) return -grid;
  if (grid_out) *grid_out = grid;
  void* args[] = {&p, &kv};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)decode_layer_kernel<KV>, dim3(grid), dim3(kCtaThreads), args,
      smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

Params make_params(int S, int d, int h, int kvh, int dh, int ff, int bs,
                   int mb, float eps2, float scale, const void* x,
                   const void* r1, const void* cos, const void* sin,
                   const void* table, const void* lengths, const void* wq,
                   const void* wo, const void* ln2, const void* wg,
                   const void* wu, const void* wd, void* const* scratch,
                   void* tickets, void* out, void* stamps) {
  Params p{};
  p.S = S;
  p.d = d;
  p.hd = h * dh;
  p.h = h;
  p.kvh = kvh;
  p.dh = dh;
  p.ff = ff;
  p.bs = bs;
  p.mb = mb;
  p.eps2 = eps2;
  p.scale = scale;
  p.x = static_cast<const float*>(x);
  p.r1 = static_cast<const float*>(r1);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.wq = static_cast<const float*>(wq);
  p.wo = static_cast<const float*>(wo);
  p.ln2 = static_cast<const float*>(ln2);
  p.wg = static_cast<const float*>(wg);
  p.wu = static_cast<const float*>(wu);
  p.wd = static_cast<const float*>(wd);
  p.q = static_cast<float*>(scratch[0]);
  p.attn = static_cast<float*>(scratch[1]);
  p.h1 = static_cast<float*>(scratch[2]);
  p.act = static_cast<float*>(scratch[3]);
  p.sq = static_cast<float*>(scratch[4]);
  p.part = static_cast<float*>(scratch[5]);
  p.work = static_cast<int*>(tickets);
  p.tickets = p.work + 1;
  p.out = static_cast<float*>(out);
  p.stamps = static_cast<unsigned long long*>(stamps);
  return p;
}

}  // namespace

// The grid a launch for S slots and head_dim dh takes (int8: 0 for the
// fp32 arena, 1 for int8), which the host's split-K and table-walk plans
// are made for. Returns the CUDA error (0 = cudaSuccess).
extern "C" int pt_decode_layer_grid(int S, int dh, int int8, int* grid) {
  if (S < 1 || S > kSMax || dh < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, dh);
  const int g = int8 ? grid_size<Int8KV>(smem)
                     : grid_size<DenseKV<float>>(smem);
  if (g < 0) return -g;
  *grid = g;
  return 0;
}

// One decode layer for S slots over the fp32 arena (mode "paged"). All
// tensors fp32 and contiguous except table and lengths (int32): x/r1/out
// (S, d); cos/sin (S, dh) at each slot's position; arenas (nb, bs, kvh,
// dh); table (S, mb); lengths (S,) = pos + 1; ln2 (d,); wq (h*dh, d), wo
// (d, h*dh), wg/wu (ff, d), wd (d, ff) as nn.Linear stores them. plan:
// 14 host ints, (bands, ks, kslice) of the q, o, gate/up and down
// products (bands of 128 rows, 64 of each for gate/up) and the attention
// walk's (ce, nc). scratch: six device pointers, q (S, h*dh), attn
// (S, h*dh), h1 (S, d), act (S, ff), sq (o bands, S) and the partial
// sums (the largest of ks * bands * S * 128 over the products and
// S * h * nc * (dh + 2)); tickets: zeroed ints, the attention phase's
// unit counter and then one for each band of a product and each of the
// S * h attention items (the kernel leaves them zero). 16-byte aligned
// pointers (the Python wrapper
// checks). stamps: null, or 6 uint64 for the measurement hook. Writes
// the grid size it launched into *grid_out. Returns the CUDA error (0 =
// cudaSuccess; cudaErrorCooperativeLaunchTooLarge when no CTA fits an
// SM).
extern "C" int pt_decode_layer(int S, int d, int h, int kvh, int dh, int ff,
                               int bs, int mb, float eps2, float scale,
                               const void* x, const void* r1, const void* cos,
                               const void* sin, const void* k_arena,
                               const void* v_arena, const void* table,
                               const void* lengths, const void* wq,
                               const void* wo, const void* ln2,
                               const void* wg, const void* wu,
                               const void* wd, const int* plan,
                               void* const* scratch, void* tickets,
                               void* out, void* stamps, int* grid_out,
                               void* stream) {
  Params p = make_params(S, d, h, kvh, dh, ff, bs, mb, eps2, scale, x, r1,
                         cos, sin, table, lengths, wq, wo, ln2, wg, wu, wd,
                         scratch, tickets, out, stamps);
  DenseKV<float> kv{static_cast<const float*>(k_arena),
                    static_cast<const float*>(v_arena)};
  return launch(p, kv, plan, static_cast<cudaStream_t>(stream), grid_out);
}

// The same over the int8 arena (mode "paged_int8"): int8 codes (nb, bs,
// kvh, dh) and fp32 absmax scales (nb, bs, kvh).
extern "C" int pt_decode_layer_int8(
    int S, int d, int h, int kvh, int dh, int ff, int bs, int mb, float eps2,
    float scale, const void* x, const void* r1, const void* cos,
    const void* sin, const void* k_codes, const void* v_codes,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lengths, const void* wq, const void* wo, const void* ln2,
    const void* wg, const void* wu, const void* wd, const int* plan,
    void* const* scratch, void* tickets, void* out, void* stamps,
    int* grid_out, void* stream) {
  Params p = make_params(S, d, h, kvh, dh, ff, bs, mb, eps2, scale, x, r1,
                         cos, sin, table, lengths, wq, wo, ln2, wg, wu, wd,
                         scratch, tickets, out, stamps);
  Int8KV kv{static_cast<const int8_t*>(k_codes),
            static_cast<const int8_t*>(v_codes),
            static_cast<const float*>(k_scales),
            static_cast<const float*>(v_scales)};
  return launch(p, kv, plan, static_cast<cudaStream_t>(stream), grid_out);
}
