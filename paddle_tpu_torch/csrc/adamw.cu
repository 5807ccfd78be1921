// One-pass decoupled AdamW update for Hopper (sm_90a), in place.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused.py `_adamw_kernel`
// (pallas_call in `fused_adamw`). Same arithmetic and order as the TPU
// kernel (fused.py:304-315), all in fp32:
//   m' = b1*m + (1-b1)*g;   v' = b2*v + (1-b2)*g*g
//   p' = p - lr * ((m'/bc1) / (sqrt(v'/bc2) + eps) + wd*p)
// with bc1 = 1 - b1^step and bc2 = 1 - b2^step.
// p is fp32 or bf16 (cast to fp32 here, rounded once on the store), g is
// fp32 or bf16 (the TPU wrapper cast g to fp32 before the call; the
// values are identical), m and v are both fp32 or both bf16. bf16
// moments are what AdamW(multi_precision=False) keeps for a bf16
// parameter: the TPU route upcasts them to fp32 for the kernel
// (fused.py:357) and the optimizer rounds the fp32 results back to bf16
// once (`_keep_slot_dtypes`); here the same fp32 arithmetic runs on the
// upcast values and each of p, m and v is stored rounded once to nearest
// even, in one launch. The TPU kernel wrote three new arrays; here p, m
// and v are updated in place (the port's optimizer owns them).
//
// The TPU kernel reads its seven scalars from an SMEM block that the
// jitted step builds from device values (fused.py:293-303): the step is
// a device int32 the program increments. Here lr (fp32) and the step
// (int32) are read from device memory, so a captured CUDA graph of the
// training step replays each step's learning rate and bias corrections;
// b1, b2, eps and wd are the optimizer's constants, passed by value.
// Each thread computes bc1 and bc2 from the step by binary
// exponentiation in fp32, as XLA's pow of an fp32 base and an int32
// exponent does (the port's `_pow_f32`), with rounded multiplies that
// the compiler may not contract, so they are bit-equal to the host's.
//
// Bound: bytes — p, g, m, v read once and p, m, v written once (26 bytes
// per element for an fp32 master with a bf16 gradient, 14 for a bf16
// parameter with bf16 moments). Design: a
// grid-stride loop over 8-element groups with 16-byte loads and stores
// for the fp32 arrays (two per group) and the bf16 ones (one per group),
// size_t indexing (the embedding has 131M elements), and a scalar tail
// for n % 8. One launch per tensor, as the TPU path; a multi-tensor
// launch is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;

struct Scalars {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

// base^e in fp32 by binary exponentiation (`_pow_f32` in ops/fused.py)
__device__ __forceinline__ float pow_f32(float base, unsigned e) {
  float acc = 1.f;
  while (e) {
    if (e & 1) acc = __fmul_rn(acc, base);
    base = __fmul_rn(base, base);
    e >>= 1;
  }
  return acc;
}

// the step's scalars from the constants and the device lr and step
__device__ __forceinline__ Scalars load_scalars(const float* lr,
                                                const int* step, float b1,
                                                float b2, float eps,
                                                float wd) {
  const unsigned t = (unsigned)*step;
  return Scalars{*lr, b1, b2, eps, wd, __fsub_rn(1.f, pow_f32(b1, t)),
                 __fsub_rn(1.f, pow_f32(b2, t))};
}

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

// 8 elements of T through 16-byte accesses (two for fp32, one for bf16)
template <typename T>
__device__ __forceinline__ void load8(const T* src, float* dst) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int part = 0; part < kGroup / per; ++part) {
    uint4 raw = *reinterpret_cast<const uint4*>(src + part * per);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < per; ++k) dst[part * per + k] = to_f32(e[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float* src) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int part = 0; part < kGroup / per; ++part) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < per; ++k) e[k] = from_f32<T>(src[part * per + k]);
    *reinterpret_cast<uint4*>(dst + part * per) = raw;
  }
}

__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, const Scalars& sc) {
  m = sc.b1 * m + (1.f - sc.b1) * g;
  v = sc.b2 * v + (1.f - sc.b2) * g * g;
  const float mhat = m / sc.bc1;
  const float vhat = v / sc.bc2;
  p = p - sc.lr * (mhat / (sqrtf(vhat) + sc.eps) + sc.wd * p);
}

template <typename P, typename G, typename M>
__global__ void adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                             M* __restrict__ m, M* __restrict__ v,
                             size_t n, const float* __restrict__ lr,
                             const int* __restrict__ step, float b1,
                             float b2, float eps, float wd) {
  const Scalars sc = load_scalars(lr, step, b1, b2, eps, wd);
  const size_t groups = n / kGroup;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < groups;
       i += stride) {
    const size_t off = i * kGroup;
    float pf[kGroup], gf[kGroup], mf[kGroup], vf[kGroup];
    load8(p + off, pf);
    load8(g + off, gf);
    load8(m + off, mf);
    load8(v + off, vf);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) adamw_one(pf[k], gf[k], mf[k], vf[k], sc);
    store8(p + off, pf);
    store8(m + off, mf);
    store8(v + off, vf);
  }
  // tail: the last n % 8 elements, one thread each
  const size_t t = groups * kGroup + (size_t)blockIdx.x * blockDim.x +
                   threadIdx.x;
  if (t < n) {
    float pf = to_f32(p[t]), mf = to_f32(m[t]), vf = to_f32(v[t]);
    adamw_one(pf, to_f32(g[t]), mf, vf, sc);
    p[t] = from_f32<P>(pf);
    m[t] = from_f32<M>(mf);
    v[t] = from_f32<M>(vf);
  }
}

template <typename P, typename G, typename M>
int launch(void* p, const void* g, void* m, void* v, size_t n,
           const float* lr, const int* step, float b1, float b2, float eps,
           float wd, cudaStream_t stream) {
  const int threads = 256;
  const size_t groups = n / kGroup;
  size_t blocks = (groups + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 CTAs per SM, then stride
  if (blocks == 0) blocks = 1;                 // the tail alone
  adamw_kernel<P, G, M><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), n, lr, step, b1, b2, eps, wd);
  return (int)cudaGetLastError();
}

template <typename M>
int launch_m(int p_dtype, int g_dtype, void* p, const void* g, void* m,
             void* v, size_t n, const float* lr, const int* step, float b1,
             float b2, float eps, float wd, cudaStream_t s) {
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float, M>(p, g, m, v, n, lr, step, b1, b2, eps, wd,
                                   s);
  if (p_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16, M>(p, g, m, v, n, lr, step, b1, b2,
                                           eps, wd, s);
  if (p_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float, M>(p, g, m, v, n, lr, step, b1, b2,
                                           eps, wd, s);
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, M>(p, g, m, v, n, lr, step,
                                                   b1, b2, eps, wd, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// p_dtype / g_dtype / m_dtype: 0 = float32, 1 = bfloat16 (m_dtype is
// that of both moments). All four are contiguous with n elements and
// 16-byte aligned (the Python wrapper checks). lr points at one fp32 and
// step at one int32 (>= 1), both in device memory. p, m and v are
// overwritten. Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int pt_adamw(int p_dtype, int g_dtype, int m_dtype, void* p,
                        const void* g, void* m, void* v, long long n,
                        const float* lr, const int* step, float b1, float b2,
                        float eps, float wd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nn = (size_t)n;
  if (m_dtype == 0)
    return launch_m<float>(p_dtype, g_dtype, p, g, m, v, nn, lr, step, b1, b2,
                           eps, wd, s);
  if (m_dtype == 1)
    return launch_m<__nv_bfloat16>(p_dtype, g_dtype, p, g, m, v, nn, lr, step,
                                   b1, b2, eps, wd, s);
  return (int)cudaErrorInvalidValue;
}
