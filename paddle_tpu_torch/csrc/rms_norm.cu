// Row RMSNorm forward for Hopper (sm_90a), without and with a residual.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused.py `_rms_kernel`
// and `_rms_res_kernel` (both run their pallas_call in `_rms_pallas`,
// reached through `fused_rms_norm` without and with `residual`).
// Same arithmetic and order as the TPU kernel (fused.py:58-62): the sum
// of squares in fp32, out = (x * rsqrt(mean + eps)) cast to x's dtype,
// THEN multiplied by the weight in x's dtype. For bf16 the order changes
// the bits, so it is kept.
//
// Bound: bytes. Each row is read twice from the kernel's point of view
// (once for the sum of squares, once to scale), but the second read of a
// row of a few KB hits L1/L2; device memory sees 2*rows*h*elt + h*elt.
// Design: one CTA per row, 16-byte vector loads (4 fp32 or 8 bf16 per
// thread per load), the sum reduced by warp shuffles and then across the
// warps through shared memory. This first version is simple and right;
// keeping the row in registers between the two passes and packing
// several short rows per CTA are later work.
//
// The residual variant (`_rms_res_kernel`, fused.py:65-71) writes both
// outputs in one launch: the first pass forms s = x + r rounded to x's
// dtype (as the TPU kernel adds in the inputs' dtype), stores it and sums
// its squares in fp32; the second pass normalises s, read back from the
// thread's own stores (L1/L2), in the same order as above. Device memory
// sees 4*rows*h*elt + h*elt.
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

// One CTA per row. RES: the residual variant; s = x + r is formed in
// the first pass, written to sum, and normalised in the second.
template <typename T, bool RES>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ r,
                                const T* __restrict__ w,
                                T* __restrict__ out, T* sum, int h,
                                float eps) {
  constexpr int N = VecWidth<T>::N;
  const int nvec = h / N;
  const size_t row = blockIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * h);
  const uint4* wv = reinterpret_cast<const uint4*>(w);
  uint4* ov = reinterpret_cast<uint4*>(out + row * h);
  // the normalised rows: x itself, or the sum the first pass writes
  const uint4* nv = xv;
  if (RES) nv = reinterpret_cast<const uint4*>(sum + row * h);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    if (RES) {
      const uint4 rraw = reinterpret_cast<const uint4*>(r + row * h)[i];
      T* e = reinterpret_cast<T*>(&raw);
      const T* re = reinterpret_cast<const T*>(&rraw);
#pragma unroll
      for (int k = 0; k < N; ++k)
        e[k] = from_f32<T>(to_f32(e[k]) + to_f32(re[k]));
      reinterpret_cast<uint4*>(sum + row * h)[i] = raw;
    }
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float f = to_f32(e[k]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float warp_sums[32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float v = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) inv_rms = rsqrtf(v / (float)h + eps);
  }
  __syncthreads();
  const float rr = inv_rms;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = nv[i], wraw = wv[i], oraw;
    const T* e = reinterpret_cast<const T*>(&raw);
    const T* we = reinterpret_cast<const T*>(&wraw);
    T* oe = reinterpret_cast<T*>(&oraw);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const T normed = from_f32<T>(to_f32(e[k]) * rr);  // cast first
      oe[k] = from_f32<T>(to_f32(normed) * to_f32(we[k]));
    }
    ov[i] = oraw;
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* w, void* out,
           void* sum, int rows, int h, float eps, cudaStream_t stream) {
  const int nvec = h / VecWidth<T>::N;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (r)
    rms_norm_kernel<T, true><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(w), static_cast<T*>(out), static_cast<T*>(sum),
        h, eps);
  else
    rms_norm_kernel<T, false><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(w),
        static_cast<T*>(out), nullptr, h, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x/out are (rows, h) contiguous, w is
// (h,); h is a multiple of the 16-byte vector width and every pointer is
// 16-byte aligned (the Python wrapper checks both). Returns the CUDA
// error of the launch (0 = cudaSuccess).
extern "C" int pt_rms_norm(int dtype, const void* x, const void* w,
                           void* out, int rows, int h, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, nullptr, w, out, nullptr, rows, h, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, nullptr, w, out, nullptr, rows, h, eps,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// The residual variant: out = rms(x + r) * w and sum = x + r, both (rows,
// h) in x's dtype; r like x. Same requirements as above.
extern "C" int pt_rms_norm_residual(int dtype, const void* x, const void* r,
                                    const void* w, void* out, void* sum,
                                    int rows, int h, float eps,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, r, w, out, sum, rows, h, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, w, out, sum, rows, h, eps, s);
  return (int)cudaErrorInvalidValue;
}
