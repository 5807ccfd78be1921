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
// public bshd layout, so no transposes. lse and delta are (b, h, sq)
// fp32. GQA: q head i reads kv head i / (h / hk); K/V are never repeated.
//
// What changes from the TPU: the TPU grid ran in order and each program
// held whole (s, d) K/V in VMEM. Here blocks run in parallel with at most
// 227 KB of shared memory, so every kernel streams tiles:
//   fwd  one CTA per (q tile, batch·head); loops over K/V tiles.
//   dq   one CTA per (q tile, batch·head); loops over K/V tiles.
//   dkv  one CTA per (k tile, batch·KV head); loops over the rep q heads
//        of its group and over the q tiles, so dk/dv are summed over the
//        group in registers and written once: no atomics, deterministic,
//        and the TPU's (b, h, sk, d) fp32 temporaries never exist.
// Causal: the tile loops stop at the diagonal tile; a window starts them
// at the band. Tiles past the band are never visited, which gives the
// same result as masking them (their p is exactly 0); masks are applied
// only on tiles that cross the diagonal, the window's edge or the ragged
// end. Causal alignment is top-left (qpos >= kpos), as `_band_mask`; the
// wrapper only lets causal calls with sq == sk through, where both
// alignments agree.
//
// Bound: operations (137 GFLOP for a causal forward at b=4, s=2048,
// h=32, d=128 against 989 TFLOP/s bf16; the backward 2.5x that). Two
// versions, chosen by dtype:
//   fp32  simple scalar kernels (64x64 tiles, 256 threads each owning a
//         4x4 patch of the scores): full fp32 products as the TPU
//         kernels' fp32 path. Training runs bf16, so no main path runs
//         them.
//   bf16  the main path, built for this card's tensor cores (below):
//         wgmma products, a TMA-fed ring of tiles, accumulators in
//         registers, one producer warp and two consumer warpgroups.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

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

// without short-circuits, so an unrolled loop over it does not branch
__device__ __forceinline__ bool keep(int qpos, int kpos, int sq, int sk,
                                     int causal, int window) {
  return (qpos < sq) & (kpos < sk) & (!causal | (qpos >= kpos)) &
         ((window <= 0) | (qpos - kpos < window));
}

// key tiles [*begin, *end) of width bn that the q rows [q0, q0 + bm) see
__device__ __forceinline__ void k_range(int q0, int bm, int bn, int sk,
                                        int causal, int window, int* begin,
                                        int* end) {
  int e = (sk + bn - 1) / bn;
  int b = 0;
  if (causal) e = min(e, (q0 + bm - 1) / bn + 1);
  if (window > 0) {
    const int kmin = q0 - window + 1;
    b = kmin > 0 ? kmin / bn : 0;
  }
  *begin = b;
  *end = e;
}

// q tiles [*begin, *end) of width bq that see the keys [k0, k0 + bk)
__device__ __forceinline__ void q_range(int k0, int bk, int bq, int sq,
                                        int causal, int window, int* begin,
                                        int* end) {
  int b = 0, e = (sq + bq - 1) / bq;
  if (causal) b = k0 / bq;
  if (window > 0) e = min(e, (k0 + bk - 1 + window - 1) / bq + 1);
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
  k_range(q0, kTile, kTile, sk, causal, window, &kt0, &kt1);
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
  k_range(q0, kTile, kTile, sk, causal, window, &kt0, &kt1);
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
  q_range(k0, kTile, kTile, sq, causal, window, &qt0, &qt1);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
//
// fwd and dq: 288 threads per CTA. Warpgroups 0 and 1 consume (each owns
// 64 rows of the CTA's 128 q rows in every product); warp 8 produces: it
// keeps a ring of K/V stages filled with TMA (128-byte swizzled boxes of
// 64 columns, completion on mbarriers: `full` when a stage has landed,
// `empty` when all 256 consumer threads are done with it), so the next
// tiles load while the tensor cores work on this one. Nine warps on an
// SM put three on one of its four register partitions, which caps every
// thread at 168 registers (ptxas compiles the consumers to that budget
// whatever setmaxnreg would hand them), enough for S, O and P at d = 128.
// dkv needs more (dK and dV alone are 128 registers a thread at d = 128):
// one warpgroup of 64 keys per CTA, two CTAs per SM, 255 registers, and
// its warp 0 issues the TMA loads a stage ahead (see flash_dkv_sm90).
//
// Every product is a wgmma m64nNk16 with fp32 accumulators in registers:
// S = Q·Kᵀ (and dP = dO·Vᵀ, their transposes in dkv) from two shared-
// memory descriptors (K-major); the probabilities p (ds in the backward)
// are rounded to bf16 in registers, where the accumulator's layout is
// already the register A operand's, and multiply V (dO, Q, K) read as an
// MN-major descriptor of the same swizzled tile. The softmax runs on the
// accumulator registers: a row lives in one quad of lanes (two shuffles
// per reduction), exp2 (one MUFU instruction) with log2(e) folded into
// the scale, masks applied without branches and only on tiles that need
// them. O, dQ, dK and dV stay in registers for the whole loop and are
// written once.
//
// Rounding sites are the PR 2 kernels': p and ds rounded to bf16 before
// the products they feed, every sum in fp32. Head dims other than 64 and
// 128 run as the next of them (DP): TMA fills the columns past d with
// zeros, so they add nothing to S and dP, and the stores skip them.
// Tiles: fwd 128 q x 128 keys, dq 128 q x 64 keys, dkv 64 keys x 64 q.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreadsH = 288;   // + the producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// no pair of [qlo, qhi] x [klo, khi] is masked
__device__ __forceinline__ bool full_tile(int qlo, int qhi, int klo, int khi,
                                          int sq, int sk, int causal,
                                          int window) {
  if (qhi >= sq || khi >= sk) return false;
  if (causal && khi > qlo) return false;
  if (window > 0 && qhi - klo >= window) return false;
  return true;
}

// descriptor of k step kk (16 columns) of rows [r0, r0 + 64) of a K-major
// tile of `rows` rows at `t`, stored as 64-column boxes of rows x 128 B
__device__ __forceinline__ uint64_t kmajor(uint32_t t, int rows, int r0,
                                           int kk) {
  return desc_sw128(t + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32,
                    16);
}

// descriptor of k step kk (16 rows) of a tile of `rows` rows at `t` read
// MN-major (its columns are the product's N)
__device__ __forceinline__ uint64_t mnmajor(uint32_t t, int rows, int kk) {
  return desc_sw128(t + kk * 2048, rows * 128);
}

// rows [row0, row0 + rows) of one head, all DP columns, as DP / 64 boxes
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int nbox, int rows,
                                          int head, int row0, int batch) {
  for (int c = 0; c < nbox; ++c)
    tma_load_4d(dst + c * rows * 128, map, bar, c * 64, head, row0, batch);
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc) {
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, acc);
  else wgmma_ss_n64(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, b, 1);
  else wgmma_rs_n64(d, a, b, 1);
}

// accumulator columns [16kk, 16kk + 16) as the bf16 A fragment of k step kk
template <int N>
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&s)[N], int kk) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// the thread's two rows (tensor rows row[0], row[1]) of a (64 x DP)
// accumulator, times mul, to bf16 rows of a bshd tensor (row stride rs
// elements); rows at or past `rows` and columns at or past d are skipped
template <int DP>
__device__ __forceinline__ void store_rows(bf16* dst, size_t rs,
                                           const float (&acc)[DP / 2],
                                           const int (&row)[2], int rows,
                                           int d, const float (&mul)[2]) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= rows) continue;
    bf16* out = dst + (size_t)row[r] * rs;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < d)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mul[r],
                                  acc[4 * j + 2 * r + 1] * mul[r]);
  }
}

// Ring depths in stages (K/V tiles; Q/dO tiles in dkv, sized so that two
// CTAs fit on an SM).
__host__ __device__ constexpr int fwd_stages(int dp) {
  return dp == 128 ? 3 : 5;
}
__host__ __device__ constexpr int dq_stages(int dp) {
  return dp == 128 ? 4 : 8;
}
__host__ __device__ constexpr int dkv_stages(int dp) {
  return dp == 128 ? 2 : 4;
}

template <int DP>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, float* __restrict__ lse, int h,
                   int hk, int sq, int sk, int d, float scale, int causal,
                   int window) {
  constexpr int BM = 128, BN = 128, NB = DP / 64, S = fwd_stages(DP);
  constexpr uint32_t kQBytes = BM * DP * 2, kKBytes = BN * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;
  const uint32_t v_s = k_s + S * kKBytes;
  // K is released when S = Q·Kᵀ is done, V when P·V is
  const uint32_t q_bar = v_s + S * kKBytes;
  const uint32_t fullk = q_bar + 8, fullv = fullk + 8 * S,
                 emptyk = fullv + 8 * S, emptyv = emptyk + 8 * S;

  const int qt = gridDim.x - 1 - blockIdx.x;   // long causal rows first
  const int q0 = qt * BM;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  int kt0, kt1;
  k_range(q0, BM, BN, sk, causal, window, &kt0, &kt1);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(fullk + 8 * s, 1);
      mbar_init(fullv + 8 * s, 1);
      mbar_init(emptyk + 8 * s, kConsumers);
      mbar_init(emptyv + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler (as CUTLASS computes it)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    // ---- producer ----
    if (threadIdx.x != kConsumers) return;
    mbar_arrive_expect_tx(q_bar, kQBytes);
    load_rows(q_s, &tq, q_bar, NB, BM, hh, q0, b);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int st = i % S, use = i / S;
      if (use > 0) mbar_wait(emptyk + 8 * st, (use - 1) & 1);
      mbar_arrive_expect_tx(fullk + 8 * st, kKBytes);
      load_rows(k_s + st * kKBytes, &tk, fullk + 8 * st, NB, BN, kh,
                kt * BN, b);
      if (use > 0) mbar_wait(emptyv + 8 * st, (use - 1) & 1);
      mbar_arrive_expect_tx(fullv + 8 * st, kKBytes);
      load_rows(v_s + st * kKBytes, &tv, fullv + 8 * st, NB, BN, kh,
                kt * BN, b);
    }
  } else {
    // ---- consumers ----
    const int wg = role, warp = (threadIdx.x >> 5) & 3,
              lane = threadIdx.x & 31;
    const int row0 = 64 * wg + 16 * warp + (lane >> 2);  // + 8 for e & 2
    const int cq = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    float oacc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) oacc[e] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int st = i % S;
      const uint32_t par = (i / S) & 1;
      const int k0 = kt * BN;
      const uint32_t kst = k_s + st * kKBytes, vst = v_s + st * kKBytes;
      float s[BN / 2];
      mbar_wait(fullk + 8 * st, par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<BN>(s, kmajor(q_s, BM, 64 * wg, kk), kmajor(kst, BN, 0, kk),
                   kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(emptyk + 8 * st);
      const bool full = full_tile(q0, q0 + BM - 1, k0, k0 + BN - 1, sq, sk,
                                  causal, window);
      // an unmasked tile with a positive scale takes the row max of the
      // raw scores and folds the scale into the exponent's FFMA; other
      // tiles scale first, then mask to -inf
      const bool fast = full && sl2 > 0.f;
      const float mul = fast ? sl2 : 1.f;
      if (!fast) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) s[e] *= sl2;
      }
      if (!full) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          s[e] = keep(q0 + row0 + 4 * (e & 2), k0 + 8 * (e >> 2) + cq + (e & 1),
                      sq, sk, causal, window)
                     ? s[e]
                     : -CUDART_INF_F;
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * mul);
        // the `neg` guard: a row masked so far keeps p = 0 (2^-inf); its
        // l and o are 0, so alpha's value does not matter there
        const float mref = m_new == -CUDART_INF_F ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = ex2(fmaf(s[4 * j + 2 * r + c], mul, -mref));
            s[4 * j + 2 * r + c] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[r] = ex2(m[r] - mref);
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) oacc[e] *= alpha[(e >> 1) & 1];
      uint32_t pf[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a_frag(pf[kk], s, kk);
      mbar_wait(fullv + 8 * st, par);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_rs<DP>(oacc, pf[kk], mnmajor(vst, BN, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      mbar_arrive(emptyv + 8 * st);
    }
    const int rows[2] = {q0 + row0, q0 + row0 + 8};
    float inv[2];
    float* lb = lse + (size_t)bh * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lsafe = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / lsafe;
      if ((lane & 3) == 0 && rows[r] < sq)
        lb[rows[r]] = m[r] * kLn2 + logf(lsafe);
    }
    store_rows<DP>(o + ((size_t)b * sq * h + hh) * d, (size_t)h * d, oacc,
                   rows, sq, d, inv);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreadsH, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int h, int hk, int sq, int sk, int d, float scale,
                  int causal, int window) {
  constexpr int BM = 128, BN = 64, NB = DP / 64, S = dq_stages(DP);
  constexpr uint32_t kQBytes = BM * DP * 2, kKBytes = BN * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t k_s = do_s + kQBytes;
  const uint32_t v_s = k_s + S * kKBytes;
  const uint32_t res_bar = v_s + S * kKBytes;
  const uint32_t full = res_bar + 8, empty = full + 8 * S;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int bh = blockIdx.y, b = bh / h, hh = bh % h, kh = hh / (h / hk);
  int kt0, kt1;
  k_range(q0, BM, BN, sk, causal, window, &kt0, &kt1);

  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler (as CUTLASS computes it)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    if (threadIdx.x != kConsumers) return;
    mbar_arrive_expect_tx(res_bar, 2 * kQBytes);
    load_rows(q_s, &tq, res_bar, NB, BM, hh, q0, b);
    load_rows(do_s, &tdo, res_bar, NB, BM, hh, q0, b);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int st = i % S, use = i / S;
      if (use > 0) mbar_wait(empty + 8 * st, (use - 1) & 1);
      mbar_arrive_expect_tx(full + 8 * st, 2 * kKBytes);
      load_rows(k_s + st * kKBytes, &tk, full + 8 * st, NB, BN, kh, kt * BN,
                b);
      load_rows(v_s + st * kKBytes, &tv, full + 8 * st, NB, BN, kh, kt * BN,
                b);
    }
  } else {
    const int wg = role, warp = (threadIdx.x >> 5) & 3,
              lane = threadIdx.x & 31;
    const int row0 = 64 * wg + 16 * warp + (lane >> 2);
    const int cq = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    const int rows[2] = {q0 + row0, q0 + row0 + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < sq;
      lse2[r] = in ? lse[(size_t)bh * sq + rows[r]] * kLog2e : 0.f;
      dl[r] = in ? delta[(size_t)bh * sq + rows[r]] : 0.f;
    }
    float acc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.f;
    mbar_wait(res_bar, 0);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int st = i % S;
      const int k0 = kt * BN;
      const uint32_t kst = k_s + st * kKBytes, vst = v_s + st * kKBytes;
      float s[BN / 2], dp[BN / 2];
      mbar_wait(full + 8 * st, (i / S) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<BN>(s, kmajor(q_s, BM, 64 * wg, kk), kmajor(kst, BN, 0, kk),
                   kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        mma_ss<BN>(dp, kmajor(do_s, BM, 64 * wg, kk), kmajor(vst, BN, 0, kk),
                   kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      const bool whole = full_tile(q0, q0 + BM - 1, k0, k0 + BN - 1, sq, sk,
                                   causal, window);
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        s[e] = ex2(fmaf(s[e], sl2, -lse2[(e >> 1) & 1]));
      if (!whole) {
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          s[e] = keep(rows[(e >> 1) & 1], k0 + 8 * (e >> 2) + cq + (e & 1),
                      sq, sk, causal, window)
                     ? s[e]
                     : 0.f;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e)
        dp[e] = s[e] * (dp[e] - dl[(e >> 1) & 1]) * scale;
      uint32_t df[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) to_a_frag(df[kk], dp, kk);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_rs<DP>(acc, df[kk], mnmajor(kst, BN, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * st);
    }
    const float one[2] = {1.f, 1.f};
    store_rows<DP>(dq + ((size_t)b * sq * h + hh) * d, (size_t)h * d, acc,
                   rows, sq, d, one);
  }
}

// dkv runs one warpgroup a CTA and two CTAs an SM: eight warps an SM
// leave each thread 255 registers (dK and dV alone hold DP of them),
// where the layout of fwd and dq caps every thread at 168. Warp 0 issues
// the TMA loads a stage ahead and writes the stage's lse and delta.
template <int DP>
__global__ void __launch_bounds__(128, 2)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int h, int hk, int sq, int sk,
                   int d, float scale, int causal, int window) {
  constexpr int BK = 64, BQ = 64, NB = DP / 64, S = dkv_stages(DP);
  constexpr uint32_t kKBytes = BK * DP * 2, kQBytes = BQ * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t v_s = k_s + kKBytes;
  const uint32_t q_s = v_s + kKBytes;
  const uint32_t do_s = q_s + S * kQBytes;
  const uint32_t stats = do_s + S * kQBytes;  // lse·log2(e), delta per stage
  const uint32_t res_bar = stats + S * 2 * BQ * 4;
  const uint32_t full = res_bar + 8, empty = full + 8 * S;
  float* stats_p = reinterpret_cast<float*>(smem_raw + (stats -
                                                        smem_u32(smem_raw)));

  const int kt = blockIdx.x;           // early k tiles see the most q rows
  const int k0 = kt * BK;
  const int bkh = blockIdx.y, b = bkh / hk, kh = bkh % hk;
  const int rep = h / hk;
  int qt0, qt1;
  q_range(k0, BK, BQ, sq, causal, window, &qt0, &qt1);
  const int nq = qt1 - qt0, total = rep * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(res_bar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1 + 32);   // expect_tx + warp 0's stats
      mbar_init(empty + 8 * s, 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // warp 0: the loads of stage j (q tile j % nq of head j / nq)
  auto issue = [&](int j) {
    const int hh = kh * rep + j / nq, q0 = (qt0 + j % nq) * BQ;
    const int st = j % S;
    if (j >= S) mbar_wait(empty + 8 * st, (j / S - 1) & 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(full + 8 * st, 2 * kQBytes);
      load_rows(q_s + st * kQBytes, &tq, full + 8 * st, NB, BQ, hh, q0, b);
      load_rows(do_s + st * kQBytes, &tdo, full + 8 * st, NB, BQ, hh, q0, b);
    }
    const size_t at = ((size_t)b * h + hh) * sq;
    float* ls = stats_p + st * 2 * BQ;
    for (int r = lane; r < BQ; r += 32) {
      const bool in = q0 + r < sq;
      ls[r] = in ? lse[at + q0 + r] * kLog2e : 0.f;
      ls[BQ + r] = in ? delta[at + q0 + r] : 0.f;
    }
    mbar_arrive(full + 8 * st);
  };
  if (warp == 0) {
    if (lane == 0) {
      mbar_arrive_expect_tx(res_bar, 2 * kKBytes);
      load_rows(k_s, &tk, res_bar, NB, BK, kh, k0, b);
      load_rows(v_s, &tv, res_bar, NB, BK, kh, k0, b);
    }
    for (int j = 0; j < S - 1 && j < total; ++j) issue(j);
  }

  const int row0 = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = scale * kLog2e;
  const int rows[2] = {k0 + row0, k0 + row0 + 8};
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int e = 0; e < DP / 2; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(res_bar, 0);
  for (int i = 0; i < total; ++i) {
    if (warp == 0 && i + S - 1 < total) issue(i + S - 1);
    const int q0 = (qt0 + i % nq) * BQ;
    const int st = i % S;
    const uint32_t qst = q_s + st * kQBytes, dost = do_s + st * kQBytes;
    const float* ls = stats_p + st * 2 * BQ;
    float s[BQ / 2], dp[BQ / 2];   // sᵀ, dpᵀ: rows keys, columns q
    mbar_wait(full + 8 * st, (i / S) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss<BQ>(s, kmajor(k_s, BK, 0, kk), kmajor(qst, BQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_ss<BQ>(dp, kmajor(v_s, BK, 0, kk), kmajor(dost, BQ, 0, kk),
                 kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    const bool whole = full_tile(q0, q0 + BQ - 1, k0, k0 + BK - 1, sq, sk,
                                 causal, window);
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e)
      s[e] = ex2(fmaf(s[e], sl2, -ls[8 * (e >> 2) + cq + (e & 1)]));
    if (!whole) {
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e)
        s[e] = keep(q0 + 8 * (e >> 2) + cq + (e & 1), rows[(e >> 1) & 1], sq,
                    sk, causal, window)
                   ? s[e]
                   : 0.f;
    }
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e)
      dp[e] = s[e] * (dp[e] - ls[BQ + 8 * (e >> 2) + cq + (e & 1)]) * scale;
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      to_a_frag(pf[kk], s, kk);
      to_a_frag(df[kk], dp, kk);
    }
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<DP>(dva, pf[kk], mnmajor(dost, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_rs<DP>(dka, df[kk], mnmajor(qst, BQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    mbar_arrive(empty + 8 * st);
  }
  const float one[2] = {1.f, 1.f};
  const size_t koff = ((size_t)b * sk * hk + kh) * d;
  store_rows<DP>(dk + koff, (size_t)hk * d, dka, rows, sk, d, one);
  store_rows<DP>(dv + koff, (size_t)hk * d, dva, rows, sk, d, one);
}

template <int DP>
size_t fwd_smem() {
  return 1024 + 128 * DP * 2 + 2 * fwd_stages(DP) * 128 * DP * 2 +
         8 * (1 + 4 * fwd_stages(DP));
}
template <int DP>
size_t dq_smem() {
  return 1024 + 2 * 128 * DP * 2 + 2 * dq_stages(DP) * 64 * DP * 2 +
         8 * (1 + 2 * dq_stages(DP));
}
template <int DP>
size_t dkv_smem() {
  return 1024 + 2 * 64 * DP * 2 +
         dkv_stages(DP) * (2 * 64 * DP * 2 + 2 * 64 * 4) +
         8 * (1 + 2 * dkv_stages(DP));
}

template <int DP>
int fwd_sm90(const void* q, const void* k, const void* v, void* o,
             void* lse, int b, int h, int hk, int sq, int sk, int d,
             float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = bshd_map(&tq, q, b, sq, h, d, 128);
  if (!err) err = bshd_map(&tk, k, b, sk, hk, d, 128);
  if (!err) err = bshd_map(&tv, v, b, sk, hk, d, 128);
  if (!err) err = set_smem(flash_fwd_sm90<DP>, fwd_smem<DP>());
  if (err) return err;
  dim3 grid((sq + 127) / 128, b * h);
  flash_fwd_sm90<DP><<<grid, kThreadsH, fwd_smem<DP>(), stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), h, hk,
      sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int DP>
int dq_sm90(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, int b, int h,
            int hk, int sq, int sk, int d, float scale, int causal,
            int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = bshd_map(&tq, q, b, sq, h, d, 128);
  if (!err) err = bshd_map(&tdo, dout, b, sq, h, d, 128);
  if (!err) err = bshd_map(&tk, k, b, sk, hk, d, 64);
  if (!err) err = bshd_map(&tv, v, b, sk, hk, d, 64);
  if (!err) err = set_smem(flash_dq_sm90<DP>, dq_smem<DP>());
  if (err) return err;
  dim3 grid((sq + 127) / 128, b * h);
  flash_dq_sm90<DP><<<grid, kThreadsH, dq_smem<DP>(), stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), h, hk, sq,
      sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

template <int DP>
int dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int b,
             int h, int hk, int sq, int sk, int d, float scale, int causal,
             int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = bshd_map(&tq, q, b, sq, h, d, 64);
  if (!err) err = bshd_map(&tdo, dout, b, sq, h, d, 64);
  if (!err) err = bshd_map(&tk, k, b, sk, hk, d, 64);
  if (!err) err = bshd_map(&tv, v, b, sk, hk, d, 64);
  if (!err) err = set_smem(flash_dkv_sm90<DP>, dkv_smem<DP>());
  if (err) return err;
  dim3 grid((sk + 63) / 64, b * hk);
  flash_dkv_sm90<DP><<<grid, 128, dkv_smem<DP>(), stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), h, hk, sq, sk, d, scale, causal, window);
  return (int)cudaGetLastError();
}

// head dims up to 64 run as 64, the others as 128 (zero-filled columns)
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             void* lse, int b, int h, int hk, int sq, int sk, int d,
             float scale, int causal, int window, cudaStream_t stream) {
  return d <= 64 ? fwd_sm90<64>(q, k, v, o, lse, b, h, hk, sq, sk, d, scale,
                                causal, window, stream)
                 : fwd_sm90<128>(q, k, v, o, lse, b, h, hk, sq, sk, d,
                                 scale, causal, window, stream);
}

int bwd_dq_bf16(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dq, int b, int h, int hk, int sq, int sk, int d,
                float scale, int causal, int window, cudaStream_t stream) {
  return d <= 64 ? dq_sm90<64>(q, k, v, dout, lse, delta, dq, b, h, hk, sq,
                               sk, d, scale, causal, window, stream)
                 : dq_sm90<128>(q, k, v, dout, lse, delta, dq, b, h, hk, sq,
                                sk, d, scale, causal, window, stream);
}

int bwd_dkv_bf16(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int b, int h, int hk, int sq, int sk,
                 int d, float scale, int causal, int window,
                 cudaStream_t stream) {
  return d <= 64 ? dkv_sm90<64>(q, k, v, dout, lse, delta, dk, dv, b, h, hk,
                                sq, sk, d, scale, causal, window, stream)
                 : dkv_sm90<128>(q, k, v, dout, lse, delta, dk, dv, b, h,
                                 hk, sq, sk, d, scale, causal, window,
                                 stream);
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
