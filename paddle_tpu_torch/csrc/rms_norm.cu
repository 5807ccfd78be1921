// Row RMSNorm for Hopper (sm_90a): the forward without and with a
// residual, and the backward of both.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused.py `_rms_kernel`
// and `_rms_res_kernel` (both run their pallas_call in `_rms_pallas`,
// reached through `fused_rms_norm` without and with `residual`), and the
// gradient `_rms_bwd` (fused.py:119), the VJP of `_rms_ref` that XLA
// fuses into the training step.
//
// Forward. Same arithmetic and order as the TPU kernel (fused.py:58-62):
// the sum of squares in fp32, n = (x * rsqrt(mean + eps)) cast to x's
// dtype, THEN n times the weight in x's dtype. For bf16 the order changes
// the bits, so it is kept. The residual variant (`_rms_res_kernel`,
// fused.py:65-71) first forms s = x + r rounded to x's dtype (the TPU
// kernel adds in the inputs' dtype), stores it, and normalises s.
//
// Bound: bytes (x read once, out written once; with a residual x, r read
// and out, s written). One CTA a row. A row of up to 1024 16-byte
// vectors (fp32 h <= 4096, bf16 h <= 8192) is read once into registers
// (`VPT` = 1, 2 or 4 vectors a thread, up to 256 threads), reduced, and
// normalised from the registers. A longer row takes the looping instance
// (`rms_norm_kernel_long`): 256 threads walk the row twice, the second
// time from L1/L2. Both keep the first version's sum of squares bit for
// bit (that kernel looped over the same vector-to-thread map, then
// reduced the warp sums by warp 0's shuffles): the serving streams depend
// on those bits. A split of each row over a thread-block cluster was
// measured on the H100 and not kept: it lost to one CTA a row at every
// row count from 1 to 128 rows of 4096 (PERF.md).
//
// Backward. With xf = float(x), r = rsqrt(mean(xf^2) + eps) recomputed
// from the row (JAX recomputes it too; nothing is saved by the forward)
// and n = cast(xf * r), exactly the VJP of `_rms_ref` with torch's and
// XLA's rounding sites:
//   dn = float(cast(ct * w))
//   dx = cast(r * dn - xf * (r^3 / h) * sum_row(dn * xf))   (fp32, one
//        rounding at the end; with a residual, + g_sum in x's dtype)
//   dw = cast(sum_rows cast(ct * n))   (each product rounded to x's
//        dtype, summed in fp32, rounded once)
// The fp32 steps of dx follow the plain version's (torch autograd's)
// operations one for one, each rounded on its own (no contraction into
// FMAs): a = ((-0.5 * sum_row(dn * xf)) * r^3 / h) * xf and
// dx = (dn * r + a) + a.
// Bound: bytes, x and ct read once, dx written once, w and dw. A grid of
// at most two CTAs an SM walks fixed, contiguous bands of rows. A row of
// up to 1024 vectors is held in registers, and the next row's loads are
// issued before the current row's reduction; each CTA keeps its band's
// dw column partials in registers and writes them to an fp32 (ctas, h)
// scratch. A longer row takes the looping instance
// (`rms_norm_bwd_kernel_long`), which reads each row twice (the second
// time from L1/L2) and keeps its partials in its own row of the scratch,
// each column owned by one thread. A second small launch sums the
// partials in CTA order, in fp64. No atomics: two calls give the same
// bits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

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
  return __float2bfloat16(x);  // round to nearest even, as torch/XLA
}
// x rounded to T and back: the rounding site of a product in x's dtype
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__device__ __forceinline__ const T* elems(const uint4& v) {
  return reinterpret_cast<const T*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sums of `a` and `b`, the same value in every thread: warp
// shuffles, the warp sums to `red`, then each warp reduces them again by
// shuffles (lanes past the last warp adding 0) and takes lane 0's value.
// This is the order of the first version of the forward kernel, which
// the forward keeps bit for bit. `red` holds one slot a warp for each; a
// caller that sums again alternates two of them, so one __syncthreads()
// a call suffices.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float (*red)[32]) {
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][threadIdx.x >> 5] = a;
    red[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = warp_sum(lane < nwarps ? red[0][lane] : 0.f);
  b = warp_sum(lane < nwarps ? red[1][lane] : 0.f);
  return make_float2(__shfl_sync(0xffffffffu, a, 0),
                     __shfl_sync(0xffffffffu, b, 0));
}

// --- forward: one vector's steps ---------------------------------------

// ss plus the squares of the vector's elements, in element order
template <typename T>
__device__ __forceinline__ float sq_sum(const uint4& v, float ss) {
  const T* e = elems<T>(v);
#pragma unroll
  for (int k = 0; k < VecWidth<T>::N; ++k) {
    const float f = to_f32(e[k]);
    ss += f * f;
  }
  return ss;
}

// a + b element by element, rounded to T (the residual's sum)
template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, const uint4& b) {
  T* e = reinterpret_cast<T*>(&a);
  const T* be = elems<T>(b);
#pragma unroll
  for (int k = 0; k < VecWidth<T>::N; ++k)
    e[k] = from_f32<T>(to_f32(e[k]) + to_f32(be[k]));
  return a;
}

// cast(v * rr) to T, then times the weight in T
template <typename T>
__device__ __forceinline__ uint4 normed_vec(const uint4& v, const uint4& wv,
                                            float rr) {
  uint4 o;
  const T* e = elems<T>(v);
  const T* we = elems<T>(wv);
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int k = 0; k < VecWidth<T>::N; ++k) {
    const T normed = from_f32<T>(to_f32(e[k]) * rr);  // cast first
    oe[k] = from_f32<T>(to_f32(normed) * to_f32(we[k]));
  }
  return o;
}

// Forward, one CTA a row held in registers: thread t holds the vectors
// j * blockDim.x + t, j < VPT. RES: the residual variant (s = x + r,
// written to `sum` and normalised).
template <typename T, int VPT, bool RES>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ r,
                                const T* __restrict__ w,
                                T* __restrict__ out, T* __restrict__ sum,
                                int h, float eps) {
  const int nvec = h / VecWidth<T>::N;
  const size_t row = blockIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * h);
  uint4 vals[VPT];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * blockDim.x + threadIdx.x;
    if (v < nvec) {
      uint4 raw = xv[v];
      if (RES) {
        raw = add_vec<T>(raw, reinterpret_cast<const uint4*>(r + row * h)[v]);
        reinterpret_cast<uint4*>(sum + row * h)[v] = raw;
      }
      vals[j] = raw;
      ss = sq_sum<T>(raw, ss);
    }
  }
  __shared__ float red[2][32];
  const float rr = rsqrtf(block_sum2(ss, 0.f, red).x / (float)h + eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(out + row * h);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * blockDim.x + threadIdx.x;
    if (v < nvec) ov[v] = normed_vec<T>(vals[j], wv[v], rr);
  }
}

// Forward for rows too long for the registers: the same map (thread t
// the vectors t, t + blockDim.x, ...) walked twice, the second pass
// reading the row again (x, or the sum this thread wrote) from L1/L2.
template <typename T, bool RES>
__global__ void rms_norm_kernel_long(const T* __restrict__ x,
                                     const T* __restrict__ r,
                                     const T* __restrict__ w,
                                     T* __restrict__ out, T* sum, int h,
                                     float eps) {
  const int nvec = h / VecWidth<T>::N;
  const size_t row = blockIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * h);
  const uint4* nv =
      RES ? reinterpret_cast<const uint4*>(sum + row * h) : xv;
  float ss = 0.f;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    uint4 raw = xv[v];
    if (RES) {
      raw = add_vec<T>(raw, reinterpret_cast<const uint4*>(r + row * h)[v]);
      reinterpret_cast<uint4*>(sum + row * h)[v] = raw;
    }
    ss = sq_sum<T>(raw, ss);
  }
  __shared__ float red[2][32];
  const float rr = rsqrtf(block_sum2(ss, 0.f, red).x / (float)h + eps);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(out + row * h);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x)
    ov[v] = normed_vec<T>(nv[v], wv[v], rr);
}

// --- backward: one vector's steps --------------------------------------

// ss += xf^2 and dot += dn * xf over the vector's elements
template <typename T>
__device__ __forceinline__ void bwd_sums(const uint4& xv, const uint4& cv,
                                         const uint4& wv, float& ss,
                                         float& dot) {
  const T* xe = elems<T>(xv);
  const T* ce = elems<T>(cv);
  const T* we = elems<T>(wv);
#pragma unroll
  for (int k = 0; k < VecWidth<T>::N; ++k) {
    const float xf = to_f32(xe[k]);
    const float dn = round_to<T>(__fmul_rn(to_f32(ce[k]), to_f32(we[k])));
    ss += xf * xf;
    dot += dn * xf;
  }
}

// The vector's dx (when `want_dx`; plus g's elements in T when `has_g`)
// and, DW, its products cast(ct * n) added to dwp[0, N). rr = r,
// c = ((-0.5 * dot) * r^3) / h.
template <typename T, bool DW>
__device__ __forceinline__ uint4 bwd_vec(const uint4& xv, const uint4& cv,
                                         const uint4& wv, const uint4& g,
                                         bool has_g, bool want_dx, float rr,
                                         float c, float* dwp) {
  uint4 o;
  const T* xe = elems<T>(xv);
  const T* ce = elems<T>(cv);
  const T* we = elems<T>(wv);
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int k = 0; k < VecWidth<T>::N; ++k) {
    const float xf = to_f32(xe[k]);
    const float cf = to_f32(ce[k]);
    if (want_dx) {
      const float dn = round_to<T>(__fmul_rn(cf, to_f32(we[k])));
      const float a = __fmul_rn(c, xf);
      float d = __fadd_rn(__fadd_rn(__fmul_rn(dn, rr), a), a);
      if (has_g) d = to_f32(from_f32<T>(d)) + to_f32(elems<T>(g)[k]);
      oe[k] = from_f32<T>(d);
    }
    if (DW) {
      const float n = round_to<T>(__fmul_rn(xf, rr));
      dwp[k] += round_to<T>(__fmul_rn(cf, n));
    }
  }
  return o;
}

// r and c of a row from its sums (ss, dot), each step rounded as the
// plain version's
__device__ __forceinline__ float2 bwd_scales(float2 sums, float hf,
                                             float eps) {
  const float rr = rsqrtf(__fdiv_rn(sums.x, hf) + eps);
  const float c = __fdiv_rn(
      __fmul_rn(-0.5f * sums.y, __fmul_rn(__fmul_rn(rr, rr), rr)), hf);
  return make_float2(rr, c);
}

// Backward, a row held in registers. CTA b walks rows [rows*b/G,
// rows*(b+1)/G); thread t holds the vectors j * blockDim.x + t, j < VPT,
// of the current row and of the next. dx may be null (no input gradient
// wanted); DW: accumulate and write the band's dw partials to
// part[b*h ...]. gsum (may be null): the residual output's cotangent,
// added to dx in x's dtype.
template <typename T, int VPT, bool DW>
__global__ void rms_norm_bwd_kernel(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const T* __restrict__ ct,
                                    const T* __restrict__ gsum,
                                    T* __restrict__ dx,
                                    float* __restrict__ part, int rows,
                                    int h, float eps) {
  constexpr int N = VecWidth<T>::N;
  const int nvec = h / N;
  const int row0 = (int)((long long)rows * blockIdx.x / gridDim.x);
  const int row1 = (int)((long long)rows * (blockIdx.x + 1) / gridDim.x);
  bool live[VPT];
  uint4 wr[VPT], xa[VPT], ca[VPT], xb[VPT], cb[VPT];
  float dwp[DW ? VPT * N : 1];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * blockDim.x + threadIdx.x;
    live[j] = v < nvec;
    if (live[j]) wr[j] = reinterpret_cast<const uint4*>(w)[v];
  }
#pragma unroll
  for (int i = 0; i < (DW ? VPT * N : 1); ++i) dwp[i] = 0.f;

  auto load = [&](int row, uint4* xs, uint4* cs) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * h);
    const uint4* cv = reinterpret_cast<const uint4*>(ct + (size_t)row * h);
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (live[j]) {
        xs[j] = xv[j * blockDim.x + threadIdx.x];
        cs[j] = cv[j * blockDim.x + threadIdx.x];
      }
  };

  __shared__ float red[2][2][32];
  int p = 0;
  if (row0 < row1) load(row0, xa, ca);
  for (int row = row0; row < row1; ++row) {
    if (row + 1 < row1) load(row + 1, xb, cb);
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (live[j]) bwd_sums<T>(xa[j], ca[j], wr[j], ss, dot);
    const float2 rc = bwd_scales(block_sum2(ss, dot, red[p]), (float)h, eps);
    p ^= 1;
    uint4* dxv = dx ? reinterpret_cast<uint4*>(dx + (size_t)row * h)
                    : nullptr;
    const uint4* gv =
        gsum ? reinterpret_cast<const uint4*>(gsum + (size_t)row * h)
             : nullptr;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (live[j]) {
        const int v = j * blockDim.x + threadIdx.x;
        const uint4 g = gv ? gv[v] : make_uint4(0, 0, 0, 0);
        const uint4 o = bwd_vec<T, DW>(xa[j], ca[j], wr[j], g, gv != nullptr,
                                       dxv != nullptr, rc.x, rc.y,
                                       dwp + (DW ? j * N : 0));
        if (dxv) dxv[v] = o;
      }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xa[j] = xb[j];
      ca[j] = cb[j];
    }
  }
  if (DW) {
    float4* pv = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * h);
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (live[j]) {
        const int v = j * blockDim.x + threadIdx.x;
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
          pv[v * (N / 4) + q] =
              make_float4(dwp[j * N + 4 * q], dwp[j * N + 4 * q + 1],
                          dwp[j * N + 4 * q + 2], dwp[j * N + 4 * q + 3]);
      }
  }
}

// Backward for rows too long for the registers: the same bands, thread t
// the vectors t, t + blockDim.x, ... of each row, walked twice (sums,
// then dx and the products, reading the row again from L1/L2). DW: the
// band's partials accumulate in part[b*h ...], each column read and
// written by the one thread that owns it.
template <typename T, bool DW>
__global__ void rms_norm_bwd_kernel_long(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const T* __restrict__ ct,
                                         const T* __restrict__ gsum,
                                         T* __restrict__ dx,
                                         float* __restrict__ part, int rows,
                                         int h, float eps) {
  constexpr int N = VecWidth<T>::N;
  const int nvec = h / N;
  const int row0 = (int)((long long)rows * blockIdx.x / gridDim.x);
  const int row1 = (int)((long long)rows * (blockIdx.x + 1) / gridDim.x);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  float4* pv =
      DW ? reinterpret_cast<float4*>(part + (size_t)blockIdx.x * h) : nullptr;
  if (DW)
    for (int v = threadIdx.x; v < nvec; v += blockDim.x)
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        pv[v * (N / 4) + q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __shared__ float red[2][2][32];
  int p = 0;
  for (int row = row0; row < row1; ++row) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * h);
    const uint4* cv = reinterpret_cast<const uint4*>(ct + (size_t)row * h);
    float ss = 0.f, dot = 0.f;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x)
      bwd_sums<T>(xv[v], cv[v], wv[v], ss, dot);
    const float2 rc = bwd_scales(block_sum2(ss, dot, red[p]), (float)h, eps);
    p ^= 1;
    uint4* dxv = dx ? reinterpret_cast<uint4*>(dx + (size_t)row * h)
                    : nullptr;
    const uint4* gv =
        gsum ? reinterpret_cast<const uint4*>(gsum + (size_t)row * h)
             : nullptr;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 g = gv ? gv[v] : make_uint4(0, 0, 0, 0);
      float acc[DW ? N : 1];
      if (DW)
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 f = pv[v * (N / 4) + q];
          acc[4 * q] = f.x;
          acc[4 * q + 1] = f.y;
          acc[4 * q + 2] = f.z;
          acc[4 * q + 3] = f.w;
        }
      const uint4 o = bwd_vec<T, DW>(xv[v], cv[v], wv[v], g, gv != nullptr,
                                     dxv != nullptr, rc.x, rc.y, acc);
      if (dxv) dxv[v] = o;
      if (DW)
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
          pv[v * (N / 4) + q] = make_float4(acc[4 * q], acc[4 * q + 1],
                                            acc[4 * q + 2], acc[4 * q + 3]);
    }
  }
}

// dw[col] = cast(sum over the G CTAs' partials, in CTA order): the sum
// in fp64, rounded once, so that across CTAs the kernel adds no error of
// its own beside that of its bands' fp32 sums.
template <typename T> __device__ __forceinline__ T from_f64(double x);
template <> __device__ __forceinline__ float from_f64<float>(double x) {
  return (float)x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f64<__nv_bfloat16>(double x) {
  return __double2bfloat16(x);
}

template <typename T>
__global__ void rms_norm_bwd_dw_kernel(const float* __restrict__ part,
                                       T* __restrict__ dw, int G, int h) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= h) return;
  double s = 0.0;
#pragma unroll 8
  for (int b = 0; b < G; ++b) s += (double)part[(size_t)b * h + col];
  dw[col] = from_f64<T>(s);
}

// --- launches: vpt 1, 2 or 4 holds the row in registers, 0 loops -------

bool bad_threads(int threads) {
  return threads < 32 || threads > 1024 || threads % 32;
}

template <typename T, bool RES>
int launch_fwd(const T* x, const T* r, const T* w, T* out, T* sum, int rows,
               int h, float eps, int vpt, int threads, cudaStream_t s) {
  switch (vpt) {
    case 0:
      rms_norm_kernel_long<T, RES><<<rows, threads, 0, s>>>(x, r, w, out,
                                                            sum, h, eps);
      break;
    case 1:
      rms_norm_kernel<T, 1, RES><<<rows, threads, 0, s>>>(x, r, w, out, sum,
                                                          h, eps);
      break;
    case 2:
      rms_norm_kernel<T, 2, RES><<<rows, threads, 0, s>>>(x, r, w, out, sum,
                                                          h, eps);
      break;
    case 4:
      rms_norm_kernel<T, 4, RES><<<rows, threads, 0, s>>>(x, r, w, out, sum,
                                                          h, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* x, const void* r, const void* w, void* out,
                 void* sum, int rows, int h, float eps, int vpt, int threads,
                 cudaStream_t s) {
  if (bad_threads(threads)) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(sum);
  return r ? launch_fwd<T, true>(xp, rp, wp, op, sp, rows, h, eps, vpt,
                                 threads, s)
           : launch_fwd<T, false>(xp, rp, wp, op, sp, rows, h, eps, vpt,
                                  threads, s);
}

template <typename T, bool DW>
int launch_bwd(const T* x, const T* w, const T* ct, const T* gsum, T* dx,
               float* part, int rows, int h, float eps, int ctas, int vpt,
               int threads, cudaStream_t s) {
  switch (vpt) {
    case 0:
      rms_norm_bwd_kernel_long<T, DW><<<ctas, threads, 0, s>>>(
          x, w, ct, gsum, dx, part, rows, h, eps);
      break;
    case 1:
      rms_norm_bwd_kernel<T, 1, DW><<<ctas, threads, 0, s>>>(
          x, w, ct, gsum, dx, part, rows, h, eps);
      break;
    case 2:
      rms_norm_bwd_kernel<T, 2, DW><<<ctas, threads, 0, s>>>(
          x, w, ct, gsum, dx, part, rows, h, eps);
      break;
    case 4:
      rms_norm_bwd_kernel<T, 4, DW><<<ctas, threads, 0, s>>>(
          x, w, ct, gsum, dx, part, rows, h, eps);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* x, const void* w, const void* ct,
                 const void* gsum, void* dx, void* dw, float* part, int rows,
                 int h, float eps, int ctas, int vpt, int threads,
                 cudaStream_t s) {
  if (ctas < 1 || bad_threads(threads)) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* cp = static_cast<const T*>(ct);
  const T* gp = static_cast<const T*>(gsum);
  T* dxp = static_cast<T*>(dx);
  if (!dw)
    return launch_bwd<T, false>(xp, wp, cp, gp, dxp, nullptr, rows, h, eps,
                                ctas, vpt, threads, s);
  const int e = launch_bwd<T, true>(xp, wp, cp, gp, dxp, part, rows, h, eps,
                                    ctas, vpt, threads, s);
  if (e != 0) return e;
  rms_norm_bwd_dw_kernel<T><<<(h + 127) / 128, 128, 0, s>>>(
      part, static_cast<T*>(dw), ctas, h);
  return (int)cudaGetLastError();
}

template <typename T, bool DW>
int bwd_occupancy(int vpt, int threads) {
  int n = 0;
  cudaError_t e;
  switch (vpt) {
    case 0:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rms_norm_bwd_kernel_long<T, DW>, threads, 0);
      break;
    case 1:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rms_norm_bwd_kernel<T, 1, DW>, threads, 0);
      break;
    case 2:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rms_norm_bwd_kernel<T, 2, DW>, threads, 0);
      break;
    case 4:
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rms_norm_bwd_kernel<T, 4, DW>, threads, 0);
      break;
    default:
      return -(int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? -(int)e : n;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x/out are (rows, h) contiguous, w is
// (h,); h is a multiple of the 16-byte vector width and every pointer is
// 16-byte aligned (the Python wrapper checks both). The plan (vectors a
// thread, 0 for the looping instance; threads a CTA) comes from the
// wrapper (`ops.fused.rms_norm_plan`). Returns the CUDA error of the
// launch (0 = cudaSuccess).
extern "C" int pt_rms_norm(int dtype, const void* x, const void* w,
                           void* out, int rows, int h, float eps, int vpt,
                           int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(x, nullptr, w, out, nullptr, rows, h, eps,
                               vpt, threads, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(x, nullptr, w, out, nullptr, rows, h,
                                       eps, vpt, threads, s);
  return (int)cudaErrorInvalidValue;
}

// The residual variant: out = rms(x + r) * w and sum = x + r, both (rows,
// h) in x's dtype; r like x. Same requirements as above.
extern "C" int pt_rms_norm_residual(int dtype, const void* x, const void* r,
                                    const void* w, void* out, void* sum,
                                    int rows, int h, float eps, int vpt,
                                    int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(x, r, w, out, sum, rows, h, eps, vpt,
                               threads, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(x, r, w, out, sum, rows, h, eps, vpt,
                                       threads, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the backward instance (vectors a thread as above, with or
// without the dw partials) that fit on one SM: 0 when it does not fit at
// all; a negative CUDA error on failure.
extern "C" int pt_rms_norm_bwd_occupancy(int dtype, int vpt, int threads,
                                         int dw) {
  if (dtype == 0)
    return dw ? bwd_occupancy<float, true>(vpt, threads)
              : bwd_occupancy<float, false>(vpt, threads);
  if (dtype == 1)
    return dw ? bwd_occupancy<__nv_bfloat16, true>(vpt, threads)
              : bwd_occupancy<__nv_bfloat16, false>(vpt, threads);
  return -(int)cudaErrorInvalidValue;
}

// The backward: x, ct (rows, h) and w (h,) as the forward's; gsum null or
// (rows, h); dx null or (rows, h); dw null or (h,), with part a (ctas, h)
// fp32 scratch (the wrapper allocates it). ctas CTAs walk the rows in
// bands; with dw a second launch sums the partials.
extern "C" int pt_rms_norm_bwd(int dtype, const void* x, const void* w,
                               const void* ct, const void* gsum, void* dx,
                               void* dw, void* part, int rows, int h,
                               float eps, int ctas, int vpt, int threads,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_bwd<float>(x, w, ct, gsum, dx, dw, pp, rows, h, eps,
                               ctas, vpt, threads, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, w, ct, gsum, dx, dw, pp, rows, h,
                                       eps, ctas, vpt, threads, s);
  return (int)cudaErrorInvalidValue;
}
