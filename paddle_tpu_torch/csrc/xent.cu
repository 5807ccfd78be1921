// Fused softmax cross-entropy over rows for Hopper (sm_90a): forward and
// backward.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/xent.py
// `_xent_fwd_kernel` (pallas_call in `_rows_pallas_fwd`) and
// `_xent_bwd_kernel` (in `_rows_pallas_bwd`):
//   forward:  lse[r] = log sum_c exp(x[r, c]),  nll[r] = lse[r] - x[r, y[r]]
//   backward: dx[r, c] = exp(x[r, c] - lse[r]) * ga[r] - (c == y[r]) * gb[r]
// x is (N, V) fp32 or bf16, row-major; labels int32 in [0, V) (callers
// clip); nll, lse, ga, gb fp32; dx in x's dtype. All sums in fp32.
//
// Bound: bytes. The forward reads the logits once (N*V*size + 4N) and
// writes 8N; the backward reads them once more and writes dx (2*N*V*size
// + 16N). Design: a group of TPR threads per row (256, a whole CTA, for
// V >= 1024; a warp, eight rows to a CTA, below). The group walks its row
// with 16-byte loads; V is any width, so each row is split into a scalar
// head up to the first 16-byte boundary, 16-byte vectors, and a scalar
// tail (at ERNIE's V = 30522 consecutive rows start 8 bytes apart mod
// 16). The forward keeps an online (max, sum of exp) per thread, merges
// the warp's with shuffles and the warps' through shared memory, and
// reads the label logit directly, as the TPU kernel's masked max picks
// the same value. The backward is the same walk storing each element
// rounded once from fp32; the product and the difference are written
// with __fmul_rn/__fsub_rn so the compiler cannot contract them into an
// FMA, which keeps dx bit-compatible with the plain version's order.
// No TPU row-block tiling: the TPU kernel's (rows, V) VMEM tile and its
// V % 128 gate are lane artifacts; the whole row streams through
// registers here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;   // finite stand-in for -inf (the TPU _NEG)

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

// elements of a row before its first 16-byte boundary
template <typename T>
__device__ __forceinline__ int head_elems(const T* row, int v) {
  const int h = (int)(((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u)
                      / sizeof(T));
  return h < v ? h : v;
}

__device__ __forceinline__ void fold(float& m, float& s, float x) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;
    m = x;
  } else {
    s += expf(x - m);
  }
}

__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

template <typename T, int TPR>
__global__ void xent_fwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                float* __restrict__ nll,
                                float* __restrict__ lse, int n, int v) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WARPS = TPR / 32;
  __shared__ float sm[256 / 32], ss[256 / 32];
  const int group = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int r = blockIdx.x * (blockDim.x / TPR) + group;
  float m = kNeg, s = 0.f;
  if (r < n) {
    const T* row = x + (size_t)r * v;
    const int head = head_elems(row, v);
    for (int c = lane; c < head; c += TPR) fold(m, s, to_f32(row[c]));
    const int nvec = (v - head) / VEC;
    const uint4* vp = reinterpret_cast<const uint4*>(row + head);
    for (int i = lane; i < nvec; i += TPR) {
      const uint4 raw = vp[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) fold(m, s, to_f32(e[k]));
    }
    for (int c = head + nvec * VEC + lane; c < v; c += TPR)
      fold(m, s, to_f32(row[c]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  if (WARPS > 1) {
    const int warp = lane / 32;
    if (lane % 32 == 0) {
      sm[warp] = m;
      ss[warp] = s;
    }
    __syncthreads();
    if (lane == 0) {
      for (int w = 1; w < WARPS; ++w) merge(m, s, sm[w], ss[w]);
    }
  }
  if (lane == 0 && r < n) {
    const float l = m + logf(s);
    const float tgt = to_f32(x[(size_t)r * v + labels[r]]);
    lse[r] = l;
    nll[r] = l - tgt;
  }
}

template <typename T>
__device__ __forceinline__ float grad_elem(float xv, int c, int lab, float l,
                                           float ga, float gb) {
  const float p = expf(xv - l);
  return __fsub_rn(__fmul_rn(p, ga), c == lab ? gb : 0.f);
}

template <typename T, int TPR>
__global__ void xent_bwd_kernel(const T* __restrict__ x,
                                const int* __restrict__ labels,
                                const float* __restrict__ lse,
                                const float* __restrict__ ga,
                                const float* __restrict__ gb,
                                T* __restrict__ dx, int n, int v) {
  constexpr int VEC = 16 / sizeof(T);
  const int group = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int r = blockIdx.x * (blockDim.x / TPR) + group;
  if (r >= n) return;
  const int lab = labels[r];
  const float l = lse[r], a = ga[r], b = gb[r];
  const T* row = x + (size_t)r * v;
  T* out = dx + (size_t)r * v;
  const int head = head_elems(row, v);
  for (int c = lane; c < head; c += TPR)
    out[c] = from_f32<T>(grad_elem<T>(to_f32(row[c]), c, lab, l, a, b));
  const int nvec = (v - head) / VEC;
  const uint4* vp = reinterpret_cast<const uint4*>(row + head);
  uint4* op = reinterpret_cast<uint4*>(out + head);
  for (int i = lane; i < nvec; i += TPR) {
    const uint4 raw = vp[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
    const int c0 = head + i * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o[k] = from_f32<T>(grad_elem<T>(to_f32(e[k]), c0 + k, lab, l, a, b));
    op[i] = res;
  }
  for (int c = head + nvec * VEC + lane; c < v; c += TPR)
    out[c] = from_f32<T>(grad_elem<T>(to_f32(row[c]), c, lab, l, a, b));
}

constexpr int kThreads = 256;

template <typename T>
int launch_fwd(const void* x, const int* labels, float* nll, float* lse,
               int n, int v, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  if (v >= 1024) {
    xent_fwd_kernel<T, 256><<<n, kThreads, 0, s>>>(xp, labels, nll, lse, n,
                                                  v);
  } else {
    const int rows = kThreads / 32;
    xent_fwd_kernel<T, 32><<<(n + rows - 1) / rows, kThreads, 0, s>>>(
        xp, labels, nll, lse, n, v);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const int* labels, const float* lse,
               const float* ga, const float* gb, void* dx, int n, int v,
               cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* dp = static_cast<T*>(dx);
  if (v >= 1024) {
    xent_bwd_kernel<T, 256><<<n, kThreads, 0, s>>>(xp, labels, lse, ga, gb,
                                                  dp, n, v);
  } else {
    const int rows = kThreads / 32;
    xent_bwd_kernel<T, 32><<<(n + rows - 1) / rows, kThreads, 0, s>>>(
        xp, labels, lse, ga, gb, dp, n, v);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x is (n, v) contiguous with a
// 16-byte aligned base; labels int32 (n,); nll and lse float32 (n,).
// Returns the CUDA error of the launch (0 = cudaSuccess).
extern "C" int pt_xent_fwd(int dtype, const void* x, const void* labels,
                           void* nll, void* lse, int n, int v,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* o1 = static_cast<float*>(nll);
  float* o2 = static_cast<float*>(lse);
  if (dtype == 0) return launch_fwd<float>(x, lab, o1, o2, n, v, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, lab, o1, o2, n, v, s);
  return (int)cudaErrorInvalidValue;
}

// dx (n, v) in x's dtype, contiguous; lse, ga, gb float32 (n,).
extern "C" int pt_xent_bwd(int dtype, const void* x, const void* labels,
                           const void* lse, const void* ga, const void* gb,
                           void* dx, int n, int v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* l = static_cast<const float*>(lse);
  const float* a = static_cast<const float*>(ga);
  const float* b = static_cast<const float*>(gb);
  if (dtype == 0) return launch_bwd<float>(x, lab, l, a, b, dx, n, v, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, lab, l, a, b, dx, n, v, s);
  return (int)cudaErrorInvalidValue;
}
