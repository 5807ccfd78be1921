// MoE row gather for Hopper (sm_90a): out[i] = x[idx[i]] where
// 0 <= idx[i] < T, else a zero row.
//
// Replaces both TPU kernels of paddle_tpu/ops/pallas/moe_dispatch.py:
// `_gather_rows_pallas` (one row per grid step, the row index feeding the
// BlockSpec through scalar prefetch; pallas_call at :131) and
// `_gather_rows_pallas_mr` (R rows per grid step with manual row DMAs;
// pallas_call at :194). Every data movement of the MoE layer (dispatch,
// combine and both their backwards) is this gather over the router's
// index maps, so no scatter runs anywhere.
//
// Bound: bytes. The valid rows are read once, every output row is
// written once, and the indices read once (valid*d*size + m*d*size +
// 4m). Design: one warp per output row, kRowsPerCta warps per CTA (one
// row per CTA and eight took the same time on the H100, so one fixed
// count serves both TPU kernels): the warp reads its index and copies
// the row with 16-byte loads and stores, or writes zeros without reading
// anything when the index is out of range. Rows whose width in bytes is
// not a multiple of 16 (or whose base is not 16-byte aligned) are copied
// element by element. The multi-row TPU kernel's padding of m to a
// multiple of its rows per step is a grid artifact: surplus warps of
// the last CTA do nothing. The copy moves bits, so the result equals the
// plain gather bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerCta = 8;

__global__ void gather_rows_vec(const uint4* __restrict__ x,
                                const int* __restrict__ idx,
                                uint4* __restrict__ out, int t, int m,
                                int row_vecs) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (i >= m) return;
  const int lane = threadIdx.x % 32;
  const int r = idx[i];
  uint4* dst = out + (size_t)i * row_vecs;
  if (r >= 0 && r < t) {
    const uint4* src = x + (size_t)r * row_vecs;
    for (int k = lane; k < row_vecs; k += 32) dst[k] = src[k];
  } else {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int k = lane; k < row_vecs; k += 32) dst[k] = z;
  }
}

template <typename E>
__global__ void gather_rows_elem(const E* __restrict__ x,
                                 const int* __restrict__ idx,
                                 E* __restrict__ out, int t, int m, int d) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (i >= m) return;
  const int lane = threadIdx.x % 32;
  const int r = idx[i];
  E* dst = out + (size_t)i * d;
  if (r >= 0 && r < t) {
    const E* src = x + (size_t)r * d;
    for (int k = lane; k < d; k += 32) dst[k] = src[k];
  } else {
    for (int k = lane; k < d; k += 32) dst[k] = E(0);
  }
}

}  // namespace

// x (t, d) and out (m, d) contiguous, elements of `elem_bytes` (4 or 2)
// bytes; idx int32 (m,). Returns the CUDA error of the launch (0 =
// cudaSuccess).
extern "C" int pt_moe_gather(int elem_bytes, const void* x, const void* idx,
                             void* out, int t, int m, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 4 && elem_bytes != 2) return (int)cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const unsigned blocks = (unsigned)((m + kRowsPerCta - 1) / kRowsPerCta);
  const int threads = 32 * kRowsPerCta;
  const size_t row_bytes = (size_t)d * elem_bytes;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    gather_rows_vec<<<blocks, threads, 0, s>>>(
        static_cast<const uint4*>(x), ip, static_cast<uint4*>(out), t, m,
        (int)(row_bytes / 16));
  } else if (elem_bytes == 4) {
    gather_rows_elem<uint32_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint32_t*>(x), ip, static_cast<uint32_t*>(out), t,
        m, d);
  } else {
    gather_rows_elem<uint16_t><<<blocks, threads, 0, s>>>(
        static_cast<const uint16_t*>(x), ip, static_cast<uint16_t*>(out), t,
        m, d);
  }
  return (int)cudaGetLastError();
}
