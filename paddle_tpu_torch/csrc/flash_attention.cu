// Flash attention forward and two-pass backward for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py
// `_flash_fwd_kernel`, `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`
// (pallas_call in `_flash_call`, reached through `flash_block`). Same
// arithmetic as the TPU kernels:
//   forward  s = (q*scale)·kᵀ, banded; online softmax in fp32 with the
//            fully-masked-row guards (`neg`, lsafe = max(l, 1e-30));
//            o = acc/lsafe in q's dtype, lse = m + log(lsafe) in fp32.
//   dq       s = (q·kᵀ)*scale, p = exp(s - lse), dp = do·vᵀ,
//            ds = p*(dp - delta)*scale, dq = Σ ds·k.
//   dkv      the same p and ds, dv = Σ pᵀ·do, dk = Σ dsᵀ·q.
// delta = rowsum(do·o) - dlse comes in from the caller (a torch
// expression, as in the TPU wrapper), so the lse cotangent costs nothing
// here.
//
// Layout: q/o/dq (b, sq, h, d), k/v/dk/dv (b, sk, hk, d) contiguous — the
// public bshd layout, read with a row stride, so no transposes and no
// head_dim padding (the TPU's (bh, s, 128) lse broadcast and its 128-lane
// padding are gone). lse and delta are (b, h, sq) fp32. GQA: q head i
// reads kv head i / (h / hk); K/V are never repeated.
//
// What changes from the TPU: the TPU grid ran in order and each program
// held whole (s, d) K/V in VMEM. Here blocks run in parallel with at most
// 227 KB of shared memory, so every kernel stages 64-row tiles:
//   fwd  one CTA per (q tile of 64, batch·head); loops over K/V tiles.
//   dq   one CTA per (q tile, batch·head); loops over K/V tiles.
//   dkv  one CTA per (k tile, batch·KV head); loops over the rep q heads
//        of its group and over the q tiles, so dk/dv are summed over the
//        group in registers and written once: the TPU's (b, h, sk, d)
//        fp32 temporaries and its group sum never exist.
// Causal: the tile loops stop at the diagonal tile; a window starts them
// at the band. Tiles past the band are never visited, which gives the
// same result as masking them (their p is exactly 0). Causal alignment is
// top-left (qpos >= kpos), as `_band_mask`; the wrapper only lets causal
// calls with sq == sk through, where both alignments agree.
//
// Bound: operations (137 GFLOP for a causal forward at b=4, s=2048,
// h=32, d=128 against 989 TFLOP/s bf16). Two simple versions, chosen by
// dtype:
//   fp32  256 threads, each owning a 4x4 patch of the 64x64 score tile
//         and a 4 x d/16 patch of the output: scalar fp32 FMAs out of
//         shared memory (rows padded to d+1 floats so that the patch
//         reads are free of bank conflicts), full fp32 products as the
//         TPU kernels' fp32 path.
//   bf16  the same tiles on the tensor cores through nvcuda::wmma
//         (mma.sync, bf16 operands, fp32 accumulation), see below.
// Neither uses wgmma, TMA or warp specialisation yet: that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSP = kTile + 1; // pitch of a 64x64 score tile in smem
constexpr int kMaxCols = 8;    // d / 16 output columns per thread, d <= 128

// Rows [row0, row0 + 64) of a (seq, d) fp32 slice with row stride `rs`
// elements into smem times mul, pitch d+1; rows at or past `rows` are
// zero. 16-byte global loads.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          size_t rs, int row0, int rows,
                                          int d, float mul) {
  const int cpr = d / 4;
  const int pitch = d + 1;
  for (int e = threadIdx.x; e < kTile * cpr; e += kThreads) {
    const int r = e / cpr, c = (e - r * cpr) * 4;
    float* out = dst + r * pitch + c;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * rs +
                                             c);
    out[0] = val.x * mul;
    out[1] = val.y * mul;
    out[2] = val.z * mul;
    out[3] = val.w * mul;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool keep(int qpos, int kpos, int sq, int sk,
                                     int causal, int window) {
  bool k = qpos < sq && kpos < sk;
  if (causal) k = k && qpos >= kpos;
  if (window > 0) k = k && (qpos - kpos) < window;
  return k;
}

// k tiles [*begin, *end) that q tile qt sees
__device__ __forceinline__ void k_range(int qt, int sk, int causal,
                                        int window, int* begin, int* end) {
  const int q0 = qt * kTile;
  int e = (sk + kTile - 1) / kTile;
  int b = 0;
  if (causal) e = min(e, (q0 + kTile - 1) / kTile + 1);
  if (window > 0) {
    const int kmin = q0 - window + 1;
    b = kmin > 0 ? kmin / kTile : 0;
  }
  *begin = b;
  *end = e;
}

// q tiles [*begin, *end) that see k tile kt
__device__ __forceinline__ void q_range(int kt, int sq, int causal,
                                        int window, int* begin, int* end) {
  const int k0 = kt * kTile;
  int b = 0, e = (sq + kTile - 1) / kTile;
  if (causal) b = k0 / kTile;
  if (window > 0) e = min(e, (k0 + kTile - 1 + window - 1) / kTile + 1);
  *begin = b;
  *end = e;
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int h, int hk, int sq, int sk,
                     int d, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int pitch = d + 1;
  float* q_s = smem;                   // 64 x pitch, q * scale
  float* kv_s = q_s + kTile * pitch;   // 64 x pitch, K then V
  float* p_s = kv_s + kTile * pitch;   // 64 x kSP probabilities

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nj = d / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal rows first
  const int q0 = qt * kTile;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const float* qb = q + (size_t)b * sq * qrs + (size_t)hh * d;
  const float* kb = k + (size_t)b * sk * krs + (size_t)kh * d;
  const float* vb = v + (size_t)b * sk * krs + (size_t)kh * d;

  load_tile(q_s, qb, qrs, q0, sq, d, scale);
  float m[4], l[4], acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;
  }
  int kt0, kt1;
  k_range(qt, sk, causal, window, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                   // kv_s / p_s readers are done
    load_tile(kv_s, kb, krs, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * pitch + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * pitch + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!keep(qpos, k0 + tx + 16 * j, sq, sk, causal, window))
          s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const bool neg = m_new == -CUDART_INF_F;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = neg ? 0.f : expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kSP + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = neg ? 1.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                   // K readers done, p_s written
    load_tile(kv_s, vb, krs, k0, sk, d, 1.f);
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4], vv[kMaxCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        vv[j] = j < nj ? kv_s[kk * pitch + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  float* ob = o + (size_t)b * sq * qrs + (size_t)hh * d;
  float* lb = lse + (size_t)bh * sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < nj) ob[(size_t)row * qrs + tx + 16 * j] =
                      acc[i][j] / lsafe;
    if (tx == 0) lb[row] = m[i] + logf(lsafe);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int h, int hk, int sq, int sk,
                        int d, float scale, int causal, int window) {
  extern __shared__ float smem[];
  const int pitch = d + 1;
  float* q_s = smem;
  float* do_s = q_s + kTile * pitch;
  float* k_s = do_s + kTile * pitch;
  float* v_s = k_s + kTile * pitch;
  float* ds_s = v_s + kTile * pitch;   // 64 x kSP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nj = d / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const size_t qoff = (size_t)b * sq * qrs + (size_t)hh * d;
  const float* kb = k + (size_t)b * sk * krs + (size_t)kh * d;
  const float* vb = v + (size_t)b * sk * krs + (size_t)kh * d;

  load_tile(q_s, q + qoff, qrs, q0, sq, d, 1.f);
  load_tile(do_s, dout + qoff, qrs, q0, sq, d, 1.f);
  float lse_r[4], delta_r[4], acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < sq ? lse[(size_t)bh * sq + row] : 0.f;
    delta_r[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[i][j] = 0.f;
  }
  int kt0, kt1;
  k_range(qt, sk, causal, window, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(k_s, kb, krs, k0, sk, d, 1.f);
    load_tile(v_s, vb, krs, k0, sk, d, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * pitch + dd];
        dov[i] = do_s[(ty + 16 * i) * pitch + dd];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * pitch + dd];
        vv[j] = v_s[(tx + 16 * j) * pitch + dd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = keep(qpos, kpos, sq, sk, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        ds_s[(ty + 16 * i) * kSP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4], kv[kMaxCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        kv[j] = j < nj ? k_s[kk * pitch + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }
  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (j < nj) dqb[(size_t)row * qrs + tx + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int h,
                         int hk, int sq, int sk, int d, float scale,
                         int causal, int window) {
  extern __shared__ float smem[];
  const int pitch = d + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * pitch;
  float* q_s = v_s + kTile * pitch;
  float* do_s = q_s + kTile * pitch;
  float* pt_s = do_s + kTile * pitch;  // pᵀ, 64 (k rows) x kSP (q cols)
  float* dst_s = pt_s + kTile * kSP;   // dsᵀ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nj = d / 16;
  const int kt = blockIdx.x;           // early k tiles see the most q rows
  const int k0 = kt * kTile;
  const int bkh = blockIdx.y, b = bkh / hk, kh = bkh % hk;
  const int rep = h / hk;
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const size_t koff = (size_t)b * sk * krs + (size_t)kh * d;

  load_tile(k_s, k + koff, krs, k0, sk, d, 1.f);
  load_tile(v_s, v + koff, krs, k0, sk, d, 1.f);
  float dk_acc[4][kMaxCols], dv_acc[4][kMaxCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  int qt0, qt1;
  q_range(kt, sq, causal, window, &qt0, &qt1);
  for (int g = 0; g < rep; ++g) {
    const int hh = kh * rep + g;
    const size_t qoff = (size_t)b * sq * qrs + (size_t)hh * d;
    const float* lb = lse + ((size_t)b * h + hh) * sq;
    const float* db = delta + ((size_t)b * h + hh) * sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile(q_s, q + qoff, qrs, q0, sq, d, 1.f);
      load_tile(do_s, dout + qoff, qrs, q0, sq, d, 1.f);
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = k_s[(ty + 16 * i) * pitch + dd];
          vv[i] = v_s[(ty + 16 * i) * pitch + dd];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = q_s[(tx + 16 * j) * pitch + dd];
          dov[j] = do_s[(tx + 16 * j) * pitch + dd];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const float lse_c = qpos < sq ? lb[qpos] : 0.f;
        const float delta_c = qpos < sq ? db[qpos] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + ty + 16 * i;
          const float p = keep(qpos, kpos, sq, sk, causal, window)
                              ? expf(st[i][j] * scale - lse_c)
                              : 0.f;
          pt_s[(ty + 16 * i) * kSP + tx + 16 * j] = p;
          dst_s[(ty + 16 * i) * kSP + tx + 16 * j] =
              p * (dpt[i][j] - delta_c) * scale;
        }
      }
      __syncthreads();
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], dsv[4], dov[kMaxCols], qv[kMaxCols];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * kSP + qq];
          dsv[i] = dst_s[(ty + 16 * i) * kSP + qq];
        }
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) {
          dov[j] = j < nj ? do_s[qq * pitch + tx + 16 * j] : 0.f;
          qv[j] = j < nj ? q_s[qq * pitch + tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kMaxCols; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j >= nj) continue;
      const size_t at = koff + (size_t)row * krs + tx + 16 * j;
      dk[at] = dk_acc[i][j];
      dv[at] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three kernels on the tensor cores (nvcuda::wmma, bf16
// m16n16k16 with fp32 accumulation). 128 threads = 4 warps per CTA; warp
// w owns rows [16w, 16w + 16) of its 64-row tile in every product and in
// the softmax, so the phases inside a tile need only __syncwarp; the CTA
// syncs only around the shared K/V (or Q/dO) tile loads. Tiles stay bf16
// in shared memory (rows padded by 8 elements); scores, the dP tile and
// the O accumulator are fp32. The probabilities (and ds in the backward)
// are rounded to bf16 before the products they feed, as the TPU kernels'
// MXU products of bf16 operands are; their sums stay fp32. Two CTAs fit
// on an SM.
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBt = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kWThreads = 128;  // 4 warps
constexpr int kSF = kTile + 4;  // pitch of a 64x64 fp32 tile
constexpr int kSB = kTile + 8;  // pitch of a 64x64 bf16 tile

// rows [row0, row0 + 64) of a (seq, d) bf16 slice with row stride `rs`
// into smem with pitch d + 8, 16-byte copies; rows past `rows` are zero
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          size_t rs, int row0, int rows,
                                          int d) {
  const int cpr = d / 8, pitch = d + 8;
  for (int e = threadIdx.x; e < kTile * cpr; e += blockDim.x) {
    const int r = e / cpr, c = (e - r * cpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
  }
}

// out(16w.., 64 cols) = A(16w.., :kdim) · B(64 rows, :kdim)ᵀ, fp32 into smem
__device__ __forceinline__ void warp_abt(float* out, const bf16* a,
                                         const bf16* b, int ld, int kdim,
                                         int warp) {
  for (int j = 0; j < kTile / 16; ++j) {
    FragC c;
    wm::fill_fragment(c, 0.f);
    for (int kk = 0; kk < kdim / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wm::load_matrix_sync(fa, a + warp * 16 * ld + kk * 16, ld);
      wm::load_matrix_sync(fb, b + j * 16 * ld + kk * 16, ld);
      wm::mma_sync(c, fa, fb, c);
    }
    wm::store_matrix_sync(out + warp * 16 * kSF + j * 16, c, kSF,
                          wm::mem_row_major);
  }
}

// 8 fp32 values -> 8 bf16 in one 16-byte store
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* v) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

// each lane writes side of one staged fp32 row (pitch d + 4) to global bf16
__device__ __forceinline__ void write_rows(bf16* dst, size_t rs,
                                           const float* st, int row0,
                                           int rows, int d, float mul_row) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), c0 = (lane & 1) * (d / 2);
  if (row0 + r >= rows) return;
  for (int c = c0; c < c0 + d / 2; c += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = st[r * (d + 4) + c + i] * mul_row;
    store8_bf16(dst + (size_t)(row0 + r) * rs + c, v);
  }
}

// the warp's 16 rows of d/16 accumulators into fp32 staging (pitch d + 4)
__device__ __forceinline__ void stage_rows(float* st,
                                           const FragC (&acc)[kMaxCols],
                                           int d, int warp) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
    if (j < d / 16)
      wm::store_matrix_sync(st + warp * 16 * (d + 4) + j * 16, acc[j], d + 4,
                            wm::mem_row_major);
  __syncwarp();
}

__global__ void __launch_bounds__(kWThreads, 2)
    flash_fwd_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int h, int hk, int sq, int sk,
                   int d, float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = d + 8, lo = d + 4, nd = d / 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile * ld;
  bf16* v_s = k_s + kTile * ld;
  float* s_s = reinterpret_cast<float*>(v_s + kTile * ld);   // 64 x kSF
  bf16* p_s = reinterpret_cast<bf16*>(s_s + kTile * kSF);    // 64 x kSB
  float* o_s = reinterpret_cast<float*>(p_s + kTile * kSB);  // 64 x lo
  float* m_s = o_s + kTile * lo;
  float* l_s = m_s + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), side = lane & 1;
  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal rows first
  const int q0 = qt * kTile, qpos = q0 + r;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const size_t qoff = (size_t)b * sq * qrs + (size_t)hh * d;
  const bf16* kb = k + (size_t)b * sk * krs + (size_t)kh * d;
  const bf16* vb = v + (size_t)b * sk * krs + (size_t)kh * d;

  copy_tile(q_s, q + qoff, qrs, q0, sq, d);
  for (int e = threadIdx.x; e < kTile * lo; e += kWThreads) o_s[e] = 0.f;
  if (threadIdx.x < kTile) {
    m_s[threadIdx.x] = -CUDART_INF_F;
    l_s[threadIdx.x] = 0.f;
  }
  int kt0, kt1;
  k_range(qt, sk, causal, window, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                   // K/V readers are done
    copy_tile(k_s, kb, krs, k0, sk, d);
    copy_tile(v_s, vb, krs, k0, sk, d);
    __syncthreads();
    warp_abt(s_s, q_s, k_s, ld, d, warp);
    __syncwarp();
    float sv[32], mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = side * 32 + c;
      float x = s_s[r * kSF + col] * scale;
      if (!keep(qpos, k0 + col, sq, sk, causal, window)) x = -CUDART_INF_F;
      sv[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    const bool neg = m_new == -CUDART_INF_F;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = neg ? 0.f : expf(sv[c] - m_new);
      p_s[r * kSB + side * 32 + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = neg ? 1.f : expf(m_old - m_new);
    for (int c = side * (d / 2); c < (side + 1) * (d / 2); ++c)
      o_s[r * lo + c] *= alpha;
    __syncwarp();                      // both lanes of the row read m_s
    if (side == 0) {
      m_s[r] = m_new;
      l_s[r] = l_s[r] * alpha + sum;
    }
    __syncwarp();
    for (int j = 0; j < nd; ++j) {
      FragC c;
      float* op = o_s + warp * 16 * lo + j * 16;
      wm::load_matrix_sync(c, op, lo, wm::mem_row_major);
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA fa;
        FragB fb;
        wm::load_matrix_sync(fa, p_s + warp * 16 * kSB + kk * 16, kSB);
        wm::load_matrix_sync(fb, v_s + kk * 16 * ld + j * 16, ld);
        wm::mma_sync(c, fa, fb, c);
      }
      wm::store_matrix_sync(op, c, lo, wm::mem_row_major);
    }
  }
  __syncwarp();
  const float lsafe = fmaxf(l_s[r], 1e-30f);
  write_rows(o + qoff, qrs, o_s, q0, sq, d, 1.f / lsafe);
  if (side == 0 && qpos < sq)
    lse[(size_t)bh * sq + qpos] = m_s[r] + logf(lsafe);
}

__global__ void __launch_bounds__(kWThreads, 2)
    flash_bwd_dq_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int h, int hk, int sq, int sk, int d, float scale,
                      int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = d + 8, nd = d / 16;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile * ld;
  bf16* k_s = do_s + kTile * ld;
  bf16* v_s = k_s + kTile * ld;
  float* f_s = reinterpret_cast<float*>(v_s + kTile * ld);   // 64 x kSF
  bf16* ds_s = reinterpret_cast<bf16*>(f_s + kTile * kSF);   // 64 x kSB

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), side = lane & 1;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kTile, qpos = q0 + r;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const size_t qoff = (size_t)b * sq * qrs + (size_t)hh * d;
  const bf16* kb = k + (size_t)b * sk * krs + (size_t)kh * d;
  const bf16* vb = v + (size_t)b * sk * krs + (size_t)kh * d;

  copy_tile(q_s, q + qoff, qrs, q0, sq, d);
  copy_tile(do_s, dout + qoff, qrs, q0, sq, d);
  const float lse_r = qpos < sq ? lse[(size_t)bh * sq + qpos] : 0.f;
  const float delta_r = qpos < sq ? delta[(size_t)bh * sq + qpos] : 0.f;
  FragC acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) wm::fill_fragment(acc[j], 0.f);
  int kt0, kt1;
  k_range(qt, sk, causal, window, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    copy_tile(k_s, kb, krs, k0, sk, d);
    copy_tile(v_s, vb, krs, k0, sk, d);
    __syncthreads();
    warp_abt(f_s, q_s, k_s, ld, d, warp);             // s = q·kᵀ
    __syncwarp();
    float pv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = side * 32 + c;
      pv[c] = keep(qpos, k0 + col, sq, sk, causal, window)
                  ? expf(f_s[r * kSF + col] * scale - lse_r)
                  : 0.f;
    }
    __syncwarp();
    warp_abt(f_s, do_s, v_s, ld, d, warp);            // dp = do·vᵀ
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = side * 32 + c;
      ds_s[r * kSB + col] = __float2bfloat16(
          pv[c] * (f_s[r * kSF + col] - delta_r) * scale);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j >= nd) break;
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA fa;
        FragB fb;
        wm::load_matrix_sync(fa, ds_s + warp * 16 * kSB + kk * 16, kSB);
        wm::load_matrix_sync(fb, k_s + kk * 16 * ld + j * 16, ld);
        wm::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
  }
  __syncthreads();                     // q_s/do_s become the staging rows
  float* st = reinterpret_cast<float*>(q_s);          // 64 x (d + 4)
  stage_rows(st, acc, d, warp);
  write_rows(dq + qoff, qrs, st, q0, sq, d, 1.f);
}

__global__ void __launch_bounds__(kWThreads, 2)
    flash_bwd_dkv_wmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int h, int hk, int sq, int sk,
                       int d, float scale, int causal, int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ld = d + 8, nd = d / 16;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * ld;
  bf16* q_s = v_s + kTile * ld;
  bf16* do_s = q_s + kTile * ld;
  float* f_s = reinterpret_cast<float*>(do_s + kTile * ld);  // 64 x kSF
  bf16* pt_s = reinterpret_cast<bf16*>(f_s + kTile * kSF);   // pᵀ, 64 x kSB
  bf16* dst_s = pt_s + kTile * kSB;                          // dsᵀ
  float* lse_s = reinterpret_cast<float*>(dst_s + kTile * kSB);
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = warp * 16 + (lane >> 1), side = lane & 1;
  const int kt = blockIdx.x;           // early k tiles see the most q rows
  const int k0 = kt * kTile, kpos = k0 + r;
  const int bkh = blockIdx.y, b = bkh / hk, kh = bkh % hk;
  const int rep = h / hk;
  const size_t qrs = (size_t)h * d, krs = (size_t)hk * d;
  const size_t koff = (size_t)b * sk * krs + (size_t)kh * d;

  copy_tile(k_s, k + koff, krs, k0, sk, d);
  copy_tile(v_s, v + koff, krs, k0, sk, d);
  FragC dk_acc[kMaxCols], dv_acc[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    wm::fill_fragment(dk_acc[j], 0.f);
    wm::fill_fragment(dv_acc[j], 0.f);
  }
  int qt0, qt1;
  q_range(kt, sq, causal, window, &qt0, &qt1);
  for (int g = 0; g < rep; ++g) {
    const int hh = kh * rep + g;
    const size_t qoff = (size_t)b * sq * qrs + (size_t)hh * d;
    const float* lb = lse + ((size_t)b * h + hh) * sq;
    const float* db = delta + ((size_t)b * h + hh) * sq;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      copy_tile(q_s, q + qoff, qrs, q0, sq, d);
      copy_tile(do_s, dout + qoff, qrs, q0, sq, d);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < sq ? lb[row] : 0.f;
        delta_s[threadIdx.x] = row < sq ? db[row] : 0.f;
      }
      __syncthreads();
      warp_abt(f_s, k_s, q_s, ld, d, warp);           // sᵀ = k·qᵀ
      __syncwarp();
      float pv[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = side * 32 + c;
        pv[c] = keep(q0 + col, kpos, sq, sk, causal, window)
                    ? expf(f_s[r * kSF + col] * scale - lse_s[col])
                    : 0.f;
        pt_s[r * kSB + col] = __float2bfloat16(pv[c]);
      }
      __syncwarp();
      warp_abt(f_s, v_s, do_s, ld, d, warp);          // dpᵀ = v·doᵀ
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = side * 32 + c;
        dst_s[r * kSB + col] = __float2bfloat16(
            pv[c] * (f_s[r * kSF + col] - delta_s[col]) * scale);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j >= nd) break;
        for (int kk = 0; kk < kTile / 16; ++kk) {
          FragA fa;
          FragB fb;
          wm::load_matrix_sync(fa, pt_s + warp * 16 * kSB + kk * 16, kSB);
          wm::load_matrix_sync(fb, do_s + kk * 16 * ld + j * 16, ld);
          wm::mma_sync(dv_acc[j], fa, fb, dv_acc[j]);
          wm::load_matrix_sync(fa, dst_s + warp * 16 * kSB + kk * 16, kSB);
          wm::load_matrix_sync(fb, q_s + kk * 16 * ld + j * 16, ld);
          wm::mma_sync(dk_acc[j], fa, fb, dk_acc[j]);
        }
      }
    }
  }
  float* st = reinterpret_cast<float*>(q_s);          // 64 x (d + 4)
  __syncthreads();                     // q_s/do_s become the staging rows
  stage_rows(st, dk_acc, d, warp);
  write_rows(dk + koff, krs, st, k0, sk, d, 1.f);
  __syncwarp();                        // the warp's rows were read
  stage_rows(st, dv_acc, d, warp);
  write_rows(dv + koff, krs, st, k0, sk, d, 1.f);
}

size_t wmma_fwd_bytes(int d) {
  return 3 * 2 * (size_t)kTile * (d + 8) + 4 * (size_t)kTile * kSF +
         2 * (size_t)kTile * kSB + 4 * (size_t)kTile * (d + 4) +
         2 * 4 * kTile;
}
size_t wmma_dq_bytes(int d) {
  return 4 * 2 * (size_t)kTile * (d + 8) + 4 * (size_t)kTile * kSF +
         2 * (size_t)kTile * kSB;
}
size_t wmma_dkv_bytes(int d) {
  return 4 * 2 * (size_t)kTile * (d + 8) + 4 * (size_t)kTile * kSF +
         2 * 2 * (size_t)kTile * kSB + 2 * 4 * kTile;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t tile_bytes(int d) { return sizeof(float) * kTile * (size_t)(d + 1); }
size_t score_bytes() { return sizeof(float) * kTile * (size_t)kSP; }

int fwd_f32(const void* q, const void* k, const void* v, void* o,
            void* lse, int b, int h, int hk, int sq, int sk, int d,
            float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = 2 * tile_bytes(d) + score_bytes();
  int err = set_smem(flash_fwd_kernel, smem);
  if (err) return err;
  dim3 grid((sq + kTile - 1) / kTile, b * h);
  flash_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), h, hk, sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

int bwd_dq_f32(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dq, int b, int h, int hk, int sq, int sk, int d,
               float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(d) + score_bytes();
  int err = set_smem(flash_bwd_dq_kernel, smem);
  if (err) return err;
  dim3 grid((sq + kTile - 1) / kTile, b * h);
  flash_bwd_dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), h, hk, sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

int bwd_dkv_f32(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int b, int h, int hk, int sq, int sk,
                int d, float scale, int causal, int window,
                cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(d) + 2 * score_bytes();
  int err = set_smem(flash_bwd_dkv_kernel, smem);
  if (err) return err;
  dim3 grid((sk + kTile - 1) / kTile, b * hk);
  flash_bwd_dkv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), h, hk, sq, sk, d,
      scale, causal, window);
  return (int)cudaGetLastError();
}

int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             void* lse, int b, int h, int hk, int sq, int sk, int d,
             float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = wmma_fwd_bytes(d);
  int err = set_smem(flash_fwd_wmma, smem);
  if (err) return err;
  dim3 grid((sq + kTile - 1) / kTile, b * h);
  flash_fwd_wmma<<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), h, hk, sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

int bwd_dq_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int b, int h, int hk, int sq, int sk, int d,
                float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = wmma_dq_bytes(d);
  int err = set_smem(flash_bwd_dq_wmma, smem);
  if (err) return err;
  dim3 grid((sq + kTile - 1) / kTile, b * h);
  flash_bwd_dq_wmma<<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), h, hk, sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

int bwd_dkv_bf16(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int b, int h, int hk, int sq, int sk,
                 int d, float scale, int causal, int window,
                 cudaStream_t stream) {
  const size_t smem = wmma_dkv_bytes(d);
  int err = set_smem(flash_bwd_dkv_wmma, smem);
  if (err) return err;
  dim3 grid((sk + kTile - 1) / kTile, b * hk);
  flash_bwd_dkv_wmma<<<grid, kWThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, hk, sq, sk, d,
      scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv share it;
// lse and delta are float32 (b, h, sq)). q/o/do/dq (b, sq, h, d) and
// k/v/dk/dv (b, sk, hk, d) contiguous and 16-byte aligned; d a multiple
// of 16 up to 128; h a multiple of hk; causal needs sq == sk; window 0
// means none (the Python wrapper checks all of it). Each returns the
// CUDA error of its launch (0 = cudaSuccess).
extern "C" int pt_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, void* o, void* lse, int b, int h,
                            int hk, int sq, int sk, int d, float scale,
                            int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_f32(q, k, v, o, lse, b, h, hk, sq, sk, d, scale, causal,
                   window, s);
  if (dtype == 1)
    return fwd_bf16(q, k, v, o, lse, b, h, hk, sq, sk, d, scale, causal,
                    window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int b, int h, int hk, int sq, int sk, int d,
                               float scale, int causal, int window,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dq_f32(q, k, v, dout, lse, delta, dq, b, h, hk, sq, sk, d,
                      scale, causal, window, s);
  if (dtype == 1)
    return bwd_dq_bf16(q, k, v, dout, lse, delta, dq, b, h, hk, sq, sk, d,
                       scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int b, int h, int hk, int sq, int sk,
                                int d, float scale, int causal, int window,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dkv_f32(q, k, v, dout, lse, delta, dk, dv, b, h, hk, sq, sk,
                       d, scale, causal, window, s);
  if (dtype == 1)
    return bwd_dkv_bf16(q, k, v, dout, lse, delta, dk, dv, b, h, hk, sq, sk,
                        d, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
