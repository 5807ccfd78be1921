// The decode-layer megakernel for Hopper (sm_90a): one cooperative launch
// per Llama decode layer per decode step, over every slot at once.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_layer.py
// `_mega_kernel` (pallas_call in `decode_layer_paged_kernel`), for the
// fp32 arena (mode "paged") and the int8 arena ("paged_int8"). For S
// slots of hidden state x (S, d) it computes, after the torch prologue
// has written this step's k and v into the arena (ops/decode_layer.py):
// RMSNorm #1, the q product and RoPE, paged attention over each slot's
// block table (int8 codes dequantized in registers), the o product and
// residual #1, RMSNorm #2, SwiGLU (gate and up products), the down
// product and residual #2. Weights are the (out, in) rows of nn.Linear,
// fp32, streamed from device memory.
//
// Why not the TPU shape: the TPU runs a grid of (S, max_blocks) with one
// slot's whole weight set resident in VMEM. At Llama-2-7B width that set
// is 675.3 MB a layer, and on this card the shape would stream it once
// per slot on only S CTAs. Here every weight byte is read once per step
// for all S slots.
//
// Bound: bytes. Per layer the weights (4 * (2 d^2 + 3 d ff) + norms, 675.3
// MB at 7B width: 0.2016 ms at 3.35 TB/s) plus the KV of the step; the
// products are GEMV-shaped (S <= 32 rows): 2 S (2 d^2 + 3 d ff) fp32
// operations, 10.8 GFLOP at S = 32, 0.16 ms at 67 TFLOP/s.
//
// Design. A persistent grid (the occupancy limit times the SM count,
// launched with cudaLaunchCooperativeKernel) runs five phases separated
// by grid-wide barriers (cooperative_groups::this_grid().sync()):
//   A  q = rms1(x) Wq^T              (columns of q in tiles)
//   B  attn = paged attention of RoPE(q) (work items: slot, head)
//   C  h1 = x + attn Wo^T
//   D  act = silu(rms2(h1) Wg^T) * (rms2(h1) Wu^T)
//   E  out = h1 + act Wd^T
// The intermediates (q, attn, h1, act) live in a few hundred KB of device
// scratch, which L2 holds. A product phase walks tiles of output columns:
// each warp owns 4 weight rows, 8 lanes on each row reading 16 bytes at a
// time (128 contiguous bytes a row per load), each lane keeping one
// partial sum per slot (up to kSMax = 32). The S input rows are staged
// through shared memory in chunks along K (the rows are too long to fit
// whole: 8 x 11008 fp32 for the down product is 352 KB), and the 8 lanes
// of a row read the same staged vector, a broadcast. RMSNorm folds into
// the staging: a staged element is x * ln[k], the sum of squares of x
// accumulates as the chunks pass, and the epilogue scales the dot product
// by rsqrt(mean + eps). The attention phase is the paged-decode body of
// csrc/paged_decode.cuh, shared with csrc/paged_attention.cu, with RoPE
// applied to q as it is loaded. Sums run in another order than torch's
// (per-lane partial sums over K, then a shuffle tree), so results agree
// with the plain version to fp32 rounding, not bit for bit. Plain loads,
// no wgmma or TMA yet: making it fast is later work.
#include <cooperative_groups.h>

#include "paged_decode.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pt_paged;

constexpr int kSMax = 32;                      // slots the kernel takes
constexpr int kLK = 8;                         // lanes on one weight row
constexpr int kRowsPerWarp = 32 / kLK;         // 4
constexpr int kTileRows = kWarps * kRowsPerWarp;  // 16 rows per CTA tile
constexpr int kStageFloats = 8192;             // 32 KB of staged inputs

struct Params {
  int S, d, hd, h, kvh, dh, ff, bs, mb, kc;
  float eps1, eps2, scale;
  const float* x;        // (S, d) layer input
  const float* cos;      // (S, dh) at each slot's position
  const float* sin;
  const int* table;      // (S, mb)
  const int* lengths;    // (S,) = pos + 1
  const float* ln1;      // (d,)
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
  float* out;            // (S, d)
};

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

// Stage columns [k0, k0 + kl) of the S rows of src (row stride K) into xs
// (row stride kc). With ln, a staged element is x * ln[k] and each row's
// sum of squares of x is added into stat[s] (one warp owns a row, so the
// order is fixed). src may have been written earlier in this launch, so
// it is read through L2 (__ldcg), never the non-coherent path.
__device__ __forceinline__ void stage(const float* src, int S, int K, int k0,
                                      int kl, int kc, const float* ln,
                                      float* xs, float* stat) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += kWarps) {
    float sq = 0.f;
    for (int c = lane * 4; c < kl; c += 128) {
      float4 v = __ldcg(reinterpret_cast<const float4*>(
          src + (size_t)s * K + k0 + c));
      if (ln) {
        sq += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
        const float4 w = *reinterpret_cast<const float4*>(ln + k0 + c);
        v.x *= w.x;
        v.y *= w.y;
        v.z *= w.z;
        v.w *= w.w;
      }
      *reinterpret_cast<float4*>(xs + s * kc + c) = v;
    }
    if (ln) {
      sq = warp_sum(sq);
      if (lane == 0) stat[s] += sq;
    }
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// One product phase: out[s, n] = sum_k in[s, k] W[n, k] for the S rows of
// src (S, K) against N weight rows (N, K), handed to epi(s, n, value,
// rstd[s]) by one lane. PAIR: the gate and up products at once, output
// column n pairing row n of W0 (gate) with row n of W1 (up); epi then
// gets (s, n, gate, up, rstd). With ln the inputs are RMS-normalised:
// staged as x * ln[k], the epilogue's rstd = rsqrt(sum x^2 / K + eps).
template <bool PAIR, typename Epi>
__device__ __forceinline__ void product_phase(
    const float* src, int S, int K, const float* ln, float eps,
    const float* W0, const float* W1, int N, int kc, float* smem,
    const Epi& epi) {
  float* stat = smem;                 // (kSMax,) sums of squares
  float* xs = smem + kSMax;           // (S, kc) staged inputs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / kLK, ql = lane % kLK;
  const int cols = PAIR ? kTileRows / 2 : kTileRows;
  const int ntiles = (N + cols - 1) / cols;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int n;
    const float* W;
    if (PAIR) {
      // groups 0, 1: gate rows n0, n0 + 1; groups 2, 3: up rows n0, n0 + 1
      n = tile * cols + warp * 2 + (grp & 1);
      W = grp < 2 ? W0 : W1;
    } else {
      n = tile * cols + warp * kRowsPerWarp + grp;
      W = W0;
    }
    const bool valid = n < N;
    const float* wrow = W + (size_t)(valid ? n : 0) * K;
    float acc[kSMax];
#pragma unroll
    for (int s = 0; s < kSMax; ++s) acc[s] = 0.f;
    __syncthreads();                   // the previous tile's epilogue
    if (threadIdx.x < kSMax) stat[threadIdx.x] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kc) {
      const int kl = min(kc, K - k0);
      __syncthreads();
      stage(src, S, K, k0, kl, kc, ln, xs, stat);
      __syncthreads();
      int c = ql * 4;
      // four 16-byte weight loads in flight per lane
      for (; c + 3 * kLK * 4 < kl; c += 4 * kLK * 4) {
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = valid ? __ldcs(reinterpret_cast<const float4*>(
                             wrow + k0 + c + u * kLK * 4))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < kSMax; ++s) {
          if (s < S) {
            const float* xr = xs + s * kc + c;
            float a = acc[s];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              a += dot4(w[u], *reinterpret_cast<const float4*>(
                                  xr + u * kLK * 4));
            acc[s] = a;
          }
        }
      }
      for (; c < kl; c += kLK * 4) {
        const float4 w = valid ? __ldcs(reinterpret_cast<const float4*>(
                                     wrow + k0 + c))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < kSMax; ++s)
          if (s < S)
            acc[s] += dot4(w, *reinterpret_cast<const float4*>(
                                  xs + s * kc + c));
      }
    }
    // the kLK lanes of a row hold partial sums over K: a shuffle tree
#pragma unroll
    for (int s = 0; s < kSMax; ++s)
#pragma unroll
      for (int o = kLK >> 1; o > 0; o >>= 1)
        acc[s] += __shfl_xor_sync(kFull, acc[s], o);
    if (PAIR) {
      // the up sums come from the lanes 16 above
#pragma unroll
      for (int s = 0; s < kSMax; ++s) {
        const float up = __shfl_down_sync(kFull, acc[s], 16);
        if (s < S && grp < 2 && valid && (s % kLK) == ql) {
          const float r = ln ? rsqrtf(stat[s] / (float)K + eps) : 1.f;
          epi(s, n, acc[s], up, r);
        }
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSMax; ++s)
        if (s < S && valid && (s % kLK) == ql) {
          const float r = ln ? rsqrtf(stat[s] / (float)K + eps) : 1.f;
          epi(s, n, acc[s], 0.f, r);
        }
    }
  }
}

template <typename KV>
__global__ void __launch_bounds__(kThreads, 4)
    decode_layer_kernel(Params p, KV kv) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int S = p.S;

  // A: q = rms1(x) Wq^T
  product_phase<false>(
      p.x, S, p.d, p.ln1, p.eps1, p.wq, nullptr, p.hd, p.kc, smem,
      [&](int s, int n, float v, float, float r) {
        p.q[(size_t)s * p.hd + n] = v * r;
      });
  grid.sync();

  // B: attention of RoPE(q) over each slot's blocks, into attn
  {
    const QRope qload{p.q, p.cos, p.sin};
    const int items = S * p.h;       // G = 1: one query head per item
    for (int item = blockIdx.x; item < items; item += gridDim.x)
      decode_item<float, KV, 1>(item, qload, kv, p.table, p.lengths,
                                p.attn, p.h, p.kvh, p.dh, p.bs, p.mb,
                                p.scale, smem);
  }
  grid.sync();

  // C: h1 = x + attn Wo^T
  product_phase<false>(
      p.attn, S, p.hd, nullptr, 0.f, p.wo, nullptr, p.d, p.kc, smem,
      [&](int s, int n, float v, float, float) {
        p.h1[(size_t)s * p.d + n] = p.x[(size_t)s * p.d + n] + v;
      });
  grid.sync();

  // D: act = silu(g) * u with g, u = rms2(h1) Wg^T, rms2(h1) Wu^T
  product_phase<true>(
      p.h1, S, p.d, p.ln2, p.eps2, p.wg, p.wu, p.ff, p.kc, smem,
      [&](int s, int n, float g, float u, float r) {
        const float gr = g * r, ur = u * r;
        p.act[(size_t)s * p.ff + n] = gr / (1.f + expf(-gr)) * ur;
      });
  grid.sync();

  // E: out = h1 + act Wd^T
  product_phase<false>(
      p.act, S, p.ff, nullptr, 0.f, p.wd, nullptr, p.d, p.kc, smem,
      [&](int s, int n, float v, float, float) {
        p.out[(size_t)s * p.d + n] = __ldcg(p.h1 + (size_t)s * p.d + n) + v;
      });
}

template <typename KV>
int launch(Params p, KV kv, cudaStream_t stream, int* grid_out) {
  const int lpp = p.dh / KV::V;
  if (p.S < 1 || p.S > kSMax || p.dh % KV::V || lpp > 32 ||
      (lpp & (lpp - 1)) || p.kvh <= 0 || p.h % p.kvh || p.dh % 2 ||
      p.d % 4 || p.hd % 4 || p.ff % 4 || p.hd != p.h * p.dh)
    return (int)cudaErrorInvalidValue;
  // the staging chunk: as much of K as 32 KB holds for S rows, a
  // multiple of one row's 32-float load width, no longer than the
  // longest K
  const int kmax = max(max(p.d, p.hd), p.ff);
  int kc = (kStageFloats / p.S) / (kLK * 4) * (kLK * 4);
  kc = min(kc, (kmax + kLK * 4 - 1) / (kLK * 4) * (kLK * 4));
  p.kc = kc;
  const size_t stage_floats = kSMax + (size_t)p.S * kc;
  const size_t item_floats = item_smem_floats<1>(p.dh);
  const size_t smem = sizeof(float) * max(stage_floats, item_floats);
  auto kernel = decode_layer_kernel<KV>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms;
  if (grid_out) *grid_out = grid;
  void* args[] = {&p, &kv};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

Params make_params(int S, int d, int h, int kvh, int dh, int ff, int bs,
                   int mb, float eps1, float eps2, float scale,
                   const void* x, const void* cos, const void* sin,
                   const void* table, const void* lengths, const void* ln1,
                   const void* wq, const void* wo, const void* ln2,
                   const void* wg, const void* wu, const void* wd,
                   void* scratch, void* out) {
  Params p;
  p.S = S;
  p.d = d;
  p.hd = h * dh;
  p.h = h;
  p.kvh = kvh;
  p.dh = dh;
  p.ff = ff;
  p.bs = bs;
  p.mb = mb;
  p.kc = 0;
  p.eps1 = eps1;
  p.eps2 = eps2;
  p.scale = scale;
  p.x = static_cast<const float*>(x);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.ln1 = static_cast<const float*>(ln1);
  p.wq = static_cast<const float*>(wq);
  p.wo = static_cast<const float*>(wo);
  p.ln2 = static_cast<const float*>(ln2);
  p.wg = static_cast<const float*>(wg);
  p.wu = static_cast<const float*>(wu);
  p.wd = static_cast<const float*>(wd);
  // scratch: q (S, hd), attn (S, hd), h1 (S, d), act (S, ff), in order
  float* sc = static_cast<float*>(scratch);
  p.q = sc;
  p.attn = p.q + (size_t)S * p.hd;
  p.h1 = p.attn + (size_t)S * p.hd;
  p.act = p.h1 + (size_t)S * d;
  p.out = static_cast<float*>(out);
  return p;
}

}  // namespace

// One decode layer for S slots over the fp32 arena (mode "paged"). All
// tensors fp32 and contiguous except table and lengths (int32): x/out
// (S, d); cos/sin (S, dh) at each slot's position; arenas (nb, bs, kvh,
// dh); table (S, mb); lengths (S,) = pos + 1; ln1/ln2 (d,); wq (h*dh, d),
// wo (d, h*dh), wg/wu (ff, d), wd (d, ff) as nn.Linear stores them;
// scratch of S * (2 h dh + d + ff) floats. 16-byte aligned pointers (the
// Python wrapper checks). Writes the grid size it launched into
// *grid_out. Returns the CUDA error (0 = cudaSuccess;
// cudaErrorCooperativeLaunchTooLarge when no CTA fits an SM).
extern "C" int pt_decode_layer(int S, int d, int h, int kvh, int dh, int ff,
                               int bs, int mb, float eps1, float eps2,
                               float scale, const void* x, const void* cos,
                               const void* sin, const void* k_arena,
                               const void* v_arena, const void* table,
                               const void* lengths, const void* ln1,
                               const void* wq, const void* wo,
                               const void* ln2, const void* wg,
                               const void* wu, const void* wd,
                               void* scratch, void* out, int* grid_out,
                               void* stream) {
  Params p = make_params(S, d, h, kvh, dh, ff, bs, mb, eps1, eps2, scale, x,
                         cos, sin, table, lengths, ln1, wq, wo, ln2, wg,
                         wu, wd, scratch, out);
  DenseKV<float> kv{static_cast<const float*>(k_arena),
                    static_cast<const float*>(v_arena)};
  return launch(p, kv, static_cast<cudaStream_t>(stream), grid_out);
}

// The same over the int8 arena (mode "paged_int8"): int8 codes (nb, bs,
// kvh, dh) and fp32 absmax scales (nb, bs, kvh).
extern "C" int pt_decode_layer_int8(
    int S, int d, int h, int kvh, int dh, int ff, int bs, int mb, float eps1,
    float eps2, float scale, const void* x, const void* cos, const void* sin,
    const void* k_codes, const void* v_codes, const void* k_scales,
    const void* v_scales, const void* table, const void* lengths,
    const void* ln1, const void* wq, const void* wo, const void* ln2,
    const void* wg, const void* wu, const void* wd, void* scratch, void* out,
    int* grid_out, void* stream) {
  Params p = make_params(S, d, h, kvh, dh, ff, bs, mb, eps1, eps2, scale, x,
                         cos, sin, table, lengths, ln1, wq, wo, ln2, wg,
                         wu, wd, scratch, out);
  Int8KV kv{static_cast<const int8_t*>(k_codes),
            static_cast<const int8_t*>(v_codes),
            static_cast<const float*>(k_scales),
            static_cast<const float*>(v_scales)};
  return launch(p, kv, static_cast<cudaStream_t>(stream), grid_out);
}
