// Rotary position embedding (neox rotate-half) for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused.py `_rope_kernel`
// (pallas_call in `_rope_pallas`, reached through `fused_rope`).
// x (b, s, h, d) and the full-width (s, d) cos/sin tables, all in one
// dtype; out = x*cos + rot(x)*sin with rot(x) = [-x2, x1]:
//   out[i]       = x[i]*c[i]             - x[i+d/2]*s[i]
//   out[i + d/2] = x[i+d/2]*c[i+d/2]     + x[i]*s[i+d/2]
// The two halves of cos/sin are read separately: the kernel does not
// assume they are equal. `sign` multiplies sin: the backward is the same
// kernel with sign = -1 (JAX `_rope_bwd`: ct*c + rot_inv(ct)*s equals
// ct*c + rot(ct)*(-s)). Arithmetic in fp32 with one rounding to the
// output dtype (the JAX reference rounds each product in bf16).
//
// The TPU kernel rotated q and k of a (rows, h, d) block in one launch
// with cos/sin pre-broadcast over the batch. Here blockIdx.y picks the
// tensor (q and k of equal shape in one launch; GQA launches once per
// tensor), and each thread reads its own cos/sin row: row % s of (s, d)
// tables, or, on the serving route, row p0 + row % s of the whole
// (table_rows, d) tables, where p0 is a start position read on the
// device (a replayed CUDA graph cannot slice the tables with a host
// integer). p0 is clamped to [0, table_rows - s], as JAX's
// dynamic_slice_in_dim clamps its start.
//
// Bound: bytes — x read once, out written once, cos/sin (s*d, cached in
// L2 across the batch and heads) read once. Design: one thread per
// (row, head, 16-byte vector of pairs): it loads a vector of the first
// half and the matching vector of the second half, so every load and
// store is 16 bytes and neighbouring threads touch neighbouring vectors.
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
  return __float2bfloat16(x);
}

template <typename T>
__global__ void rope_kernel(const T* __restrict__ x0, T* __restrict__ o0,
                            const T* __restrict__ x1, T* __restrict__ o1,
                            const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t,
                            const int32_t* __restrict__ pos0,
                            int table_rows, size_t rows, int s, int h, int d,
                            float sign) {
  constexpr int N = VecWidth<T>::N;
  int p0 = 0;
  if (pos0 != nullptr) p0 = min(max(*pos0, 0), table_rows - s);
  const T* x = blockIdx.y == 0 ? x0 : x1;
  T* out = blockIdx.y == 0 ? o0 : o1;
  const int half = d / 2;
  const int vpr = half / N;                  // vectors per half row
  const size_t total = rows * (size_t)h * vpr;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int vi = (int)(idx % vpr);
    const size_t rh = idx / vpr;              // (row, head)
    const size_t row = rh / h;
    const int pos = p0 + (int)(row % s);
    const size_t base = rh * d + (size_t)vi * N;
    const size_t cbase = (size_t)pos * d + (size_t)vi * N;
    uint4 a_raw = *reinterpret_cast<const uint4*>(x + base);
    uint4 b_raw = *reinterpret_cast<const uint4*>(x + base + half);
    uint4 c1_raw = *reinterpret_cast<const uint4*>(cos_t + cbase);
    uint4 c2_raw = *reinterpret_cast<const uint4*>(cos_t + cbase + half);
    uint4 s1_raw = *reinterpret_cast<const uint4*>(sin_t + cbase);
    uint4 s2_raw = *reinterpret_cast<const uint4*>(sin_t + cbase + half);
    const T* a = reinterpret_cast<const T*>(&a_raw);
    const T* b = reinterpret_cast<const T*>(&b_raw);
    const T* c1 = reinterpret_cast<const T*>(&c1_raw);
    const T* c2 = reinterpret_cast<const T*>(&c2_raw);
    const T* s1 = reinterpret_cast<const T*>(&s1_raw);
    const T* s2 = reinterpret_cast<const T*>(&s2_raw);
    uint4 oa_raw, ob_raw;
    T* oa = reinterpret_cast<T*>(&oa_raw);
    T* ob = reinterpret_cast<T*>(&ob_raw);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float xa = to_f32(a[k]), xb = to_f32(b[k]);
      oa[k] = from_f32<T>(xa * to_f32(c1[k]) - xb * (sign * to_f32(s1[k])));
      ob[k] = from_f32<T>(xb * to_f32(c2[k]) + xa * (sign * to_f32(s2[k])));
    }
    *reinterpret_cast<uint4*>(out + base) = oa_raw;
    *reinterpret_cast<uint4*>(out + base + half) = ob_raw;
  }
}

template <typename T>
int launch(const void* x0, void* o0, const void* x1, void* o1, int ntensors,
           const void* cos_t, const void* sin_t, const int32_t* pos0,
           int table_rows, size_t rows, int s, int h, int d, float sign,
           cudaStream_t stream) {
  const size_t total = rows * (size_t)h * (d / 2 / VecWidth<T>::N);
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535u * 32u) blocks = 65535u * 32u;  // grid-stride beyond
  if (blocks == 0) return 0;
  dim3 grid((unsigned)blocks, (unsigned)ntensors);
  rope_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x0), static_cast<T*>(o0),
      static_cast<const T*>(x1), static_cast<T*>(o1),
      static_cast<const T*>(cos_t), static_cast<const T*>(sin_t), pos0,
      table_rows, rows, s, h, d, sign);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out, cos and sin share it).
// ntensors 1 or 2: tensor 0 is (x0 -> o0), tensor 1 (x1 -> o1); both are
// (rows = b*s, h, d) contiguous with the same h. cos/sin are
// (table_rows, d) contiguous: with pos0 null, table_rows = s and row i of
// a sequence reads table row i; with pos0 a device int32, it reads row
// clamp(*pos0, 0, table_rows - s) + i (table_rows >= s). d is a multiple
// of twice the 16-byte vector width and every pointer is 16-byte aligned
// (the Python wrapper checks). Returns the CUDA error of the launch
// (0 = cudaSuccess).
extern "C" int pt_rope(int dtype, const void* x0, void* o0, const void* x1,
                       void* o1, int ntensors, const void* cos_t,
                       const void* sin_t, const int32_t* pos0, int table_rows,
                       long long rows, int s, int h, int d, float sign,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pos0 == nullptr && table_rows != s) return (int)cudaErrorInvalidValue;
  if (table_rows < s) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x0, o0, x1, o1, ntensors, cos_t, sin_t, pos0,
                         table_rows, (size_t)rows, s, h, d, sign, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x0, o0, x1, o1, ntensors, cos_t, sin_t, pos0,
                                 table_rows, (size_t)rows, s, h, d, sign, st);
  return (int)cudaErrorInvalidValue;
}
