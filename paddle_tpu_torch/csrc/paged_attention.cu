// Paged-attention decode (s = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (fp32/bf16 arena, reached through
// `paged_attention_decode`) and `_decode_kernel_int8` (int8 arena,
// reached through `paged_attention_decode_int8`); both run their
// pallas_call in `_grid_call`. q (b, h, d) attends over each slot's KV
// history, stored as blocks of a shared (num_blocks, block_size, kvh, d)
// arena and addressed through the slot's row of the (b, max_blocks)
// int32 block table; lengths (b,) counts the valid positions.
//
// The TPU kernel walked table entries as a sequential grid axis with the
// table and lengths in scalar prefetch, carrying the online softmax in
// VMEM scratch. Here each CTA reads its own table row and length and
// owns one work unit: a chunk of `ce` table entries of a work item, a
// (slot, kv head) and up to four of that kv head's g = h / kvh query
// heads (more heads take more CTAs). The unit's body, shared with the
// decode-layer megakernel (csrc/decode_layer.cu), is in
// csrc/paged_decode.cuh: its warps stream the chunk's entries from HBM
// straight into registers and fold them into per-lane online softmaxes,
// merged at the end; the g query heads of a CTA share every K/V vector
// it loads. With nc > 1 chunks an item's units leave partial states in
// scratch, and the last of them to finish merges them in chunk order in
// the same launch (a per-item ticket), so one launch covers the call.
//
// The two TPU kernels share `_decode_kernel_core` and differ only in how
// a block's k/v reach fp32; here one kernel template shares the whole
// online-softmax body and takes that step as a policy on one 16-byte
// vector (`DenseKV`, `Int8KV` with XLA's dequantization; see the header).
//
// Bound: bytes — the KV actually read, sum over slots of
// ceil(len / bs) * bs * kvh * (d * elt + scale bytes) * 2 per layer
// (elt 1 and 4 scale bytes for the int8 arena), plus q and out. Plain
// 16-byte loads, kRows rows of K and V in flight per lane; the split walk
// fills the card when b * kvh is small or the lengths are ragged (the
// longest row no longer sets the time); cp.async/TMA pipelining is later
// work.
#include "paged_decode.cuh"

namespace {

using namespace pt_paged;

// T: the type of q and out; KV: how a 16-byte K/V vector reaches fp32;
// G: query heads per CTA (1, 2 or 4). One CTA per work item.
template <typename T, typename KV, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, KV kv,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        T* __restrict__ out, int h, int kvh, int d, int bs,
                        int mb, float scale, Split split) {
  extern __shared__ float smem[];
  decode_item<T, KV, G>(blockIdx.x / split.nc, blockIdx.x % split.nc, split,
                        QPlain<T>{q}, kv, table, lengths, out, h, kvh, d,
                        bs, mb, scale, smem);
}

template <typename T, typename KV, int G>
int launch_g(const T* q, KV kv, const int* table, const int* lengths,
             T* out, int b, int h, int kvh, int d, int bs, int mb,
             float scale, Split split, cudaStream_t stream) {
  const int chunks = (h / kvh + G - 1) / G;
  const size_t smem = sizeof(float) * item_smem_floats<G>(d);
  paged_decode_kernel<T, KV, G><<<b * kvh * chunks * split.nc, kThreads,
                                  smem, stream>>>(q, kv, table, lengths, out,
                                                  h, kvh, d, bs, mb, scale,
                                                  split);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int launch(const void* q, KV kv, const void* table, const void* lengths,
           void* out, int b, int h, int kvh, int d, int bs, int mb,
           float scale, Split split, cudaStream_t stream) {
  // the lane layout: a row is d / V lanes, a power of two up to 32
  const int lpp = d / KV::V;
  if (d % KV::V || lpp > 32 || (lpp & (lpp - 1)) || kvh <= 0 || h % kvh ||
      split.ce < 1 || split.nc < 1 ||
      (split.nc > 1 && (!split.part || !split.tickets)))
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  T* o = static_cast<T*>(out);
  const int g = h / kvh;
  if (g == 1)
    return launch_g<T, KV, 1>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb,
                              scale, split, stream);
  if (g == 2)
    return launch_g<T, KV, 2>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb,
                              scale, split, stream);
  return launch_g<T, KV, 4>(qt, kv, tb, ln, o, b, h, kvh, d, bs, mb, scale,
                            split, stream);
}

// CTAs of instance <T, KV, G> that fit on one SM at once.
template <typename T, typename KV, int G>
int occupancy_g(int d, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, paged_decode_kernel<T, KV, G>, kThreads,
      sizeof(float) * item_smem_floats<G>(d));
}

template <typename T, typename KV>
int occupancy(int g, int d, int* per_sm) {
  if (g == 1) return occupancy_g<T, KV, 1>(d, per_sm);
  if (g == 2) return occupancy_g<T, KV, 2>(d, per_sm);
  return occupancy_g<T, KV, 4>(d, per_sm);
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* table, const void* lengths, void* out, int b,
                 int h, int kvh, int d, int bs, int mb, float scale,
                 Split split, cudaStream_t stream) {
  DenseKV<T> kv{static_cast<const T*>(k), static_cast<const T*>(v)};
  return launch<T>(q, kv, table, lengths, out, b, h, kvh, d, bs, mb, scale,
                   split, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, both arenas and out share it).
// q/out (b, h, d), arenas (nb, bs, kvh, d), table (b, mb) int32, lengths
// (b,) int32, all contiguous; d / (16-byte vector width) is a power of
// two up to 32 and the arena pointers are 16-byte aligned (the Python
// wrapper checks). The split walk: nc chunks of ce table entries; with
// nc > 1, part holds nc * unit_part_floats<G>(d) floats per work item and
// tickets one zeroed int per item (G = min(h / kvh, 4) query heads per
// item; the merging unit leaves the ticket zero). Returns the CUDA error
// of the launch (0 = cudaSuccess).
extern "C" int pt_paged_attention_decode(int dtype, const void* q,
                                         const void* k, const void* v,
                                         const void* table,
                                         const void* lengths, void* out,
                                         int b, int h, int kvh, int d, int bs,
                                         int mb, float scale, int ce, int nc,
                                         void* part, void* tickets,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split split{ce, nc, static_cast<float*>(part),
                    static_cast<int*>(tickets)};
  if (dtype == 0)
    return launch_dense<float>(q, k, v, table, lengths, out, b, h, kvh, d,
                               bs, mb, scale, split, s);
  if (dtype == 1)
    return launch_dense<__nv_bfloat16>(q, k, v, table, lengths, out, b, h,
                                       kvh, d, bs, mb, scale, split, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 arena. qdtype: 0 = float32, 1 = bfloat16 (q and out share
// it). Codes (nb, bs, kvh, d) int8, scales (nb, bs, kvh) float32, the
// rest as above; d / 16 is a power of two up to 32 and the code arenas
// are 16-byte aligned (the Python wrapper checks); the split as above.
extern "C" int pt_paged_attention_decode_int8(
    int qdtype, const void* q, const void* k, const void* v,
    const void* k_scales, const void* v_scales, const void* table,
    const void* lengths, void* out, int b, int h, int kvh, int d, int bs,
    int mb, float scale, int ce, int nc, void* part, void* tickets,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Split split{ce, nc, static_cast<float*>(part),
                    static_cast<int*>(tickets)};
  Int8KV kv{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
            static_cast<const float*>(k_scales),
            static_cast<const float*>(v_scales)};
  if (qdtype == 0)
    return launch<float>(q, kv, table, lengths, out, b, h, kvh, d, bs, mb,
                         scale, split, s);
  if (qdtype == 1)
    return launch<__nv_bfloat16>(q, kv, table, lengths, out, b, h, kvh, d,
                                 bs, mb, scale, split, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the instance a launch with these arguments takes that fit on
// one SM at once (the host's split plan fills the card with them):
// dtype as above for q, int8 = 1 for the int8 arena, g = h / kvh.
extern "C" int pt_paged_attention_occupancy(int dtype, int int8, int g,
                                            int d, int* per_sm) {
  if (g < 1 || d < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (int8)
    return dtype == 0 ? occupancy<float, Int8KV>(g, d, per_sm)
                      : occupancy<__nv_bfloat16, Int8KV>(g, d, per_sm);
  return dtype == 0 ? occupancy<float, DenseKV<float>>(g, d, per_sm)
                    : occupancy<__nv_bfloat16, DenseKV<__nv_bfloat16>>(
                          g, d, per_sm);
}
