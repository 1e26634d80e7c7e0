// Embedding-row movement for Hopper (sm_90a): the row gather and the
// row-sparse Adagrad write-back of the training step.
//
// Replaces the TPU kernels of dglke_tpu/ops/pallas/rows.py:
//   * gather_rows      (_gather_kernel, pallas_call at rows.py:89):
//       out[i, :dim] = float32(table[ids[i], :dim]);
//   * scatter_add_rows (_rmw_kernel, pallas_call at rows.py:227), grown into
//       the whole dglke_tpu/ops/embedding.py:sparse_adagrad_update:
//       state_sum[u] += sum_occ mean(g^2);  std = sqrt(state_sum[u]) + 1e-10
//       (read after all adds);  emb[u] += -lr * sum_occ(g) / std.
//
// What bounds them on an H100: bytes.  Both move whole rows (1.6 KB at
// dim 400 fp32) and do a handful of flops per byte, far below the ~20
// fp32 flops/byte where compute would start to matter.  At the flagship
// shapes (3,000 entity ids, dim 400) the gather moves ~9.6 MB and the
// update ~14.4 MB: a few microseconds at 3.35 TB/s.
//
// Design:
//   * gather, two launch shapes chosen by the wrapper from the width
//     (ops/rows.py:gather_shape; the C side takes the shape it is given):
//     - "warp", for narrow rows: one warp per output row, neighbouring
//       lanes on neighbouring 16-byte vectors (400 fp32 = 100 float4, or
//       100 x 4 bf16 widened to float4), so every row is read and written
//       in full coalesced transactions.  The TPU kernel's ring of
//       in-flight DMAs becomes the many warps the SMs keep in flight.
//     - "wide": one block per (row, chunk), rows on gridDim.x (so any n
//       works, and the blocks in flight at once cover the same chunk of
//       many rows, so duplicate ids meet in L2).  fp32 rows with 16-byte
//       alignment are copied by the TMA engine: one warp per chunk of
//       2,048 elements, whose first thread issues one bulk load into
//       shared memory and one bulk store out (the threads move no data).
//       bf16 rows, which widen, and unaligned rows take 256 threads per
//       chunk of 4,096 elements, each issuing its 16-byte (or scalar)
//       loads before its first store.  RESCAL's 1 MB relation rows give
//       123 blocks per row where one warp walked 1,953 vectors per lane
//       one after another.
//     The threshold between the two is measured on the card (chip_smoke.py
//     times both shapes across widths) and stated in ops/rows.py.
//   * update: the TPU kernel serialised duplicate ids inside its DMA window
//     with conflict flags; a GPU has no such window, and fp32 atomics would
//     make the sum depend on the order in which blocks run.  The caller
//     sorts the ids (stable) instead; one block takes each segment of equal
//     ids, detects that it is the segment's head from the sorted ids, and
//     sums the segment's rows in a fixed order.  The result is the same on
//     every run, and each touched row is read and written exactly once, with
//     one rounding to the table dtype.
//
// Interface: plain C functions taking pointers, sizes and the CUDA stream;
// each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kGatherThreads = 256;   // 8 rows per block
constexpr int kUpdateThreads = 128;   // one segment per block
constexpr int kWideThreads = 256;
constexpr int kWideVecs = 4;          // 16-byte vectors per thread
constexpr int kWideChunk = kWideThreads * kWideVecs * 4;  // elements per block
constexpr int kCopyChunk = 2048;      // fp32 elements per bulk-copy block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float4 widen4(float4 v) { return v; }
__device__ __forceinline__ float4 widen4(uint2 v) {
  // Four bf16 values; the lower half of each 32-bit word holds the first.
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Vector gather: V is float4 (fp32 table) or uint2 (four bf16).  pitch4 and
// dim4 count vectors of four elements.
template <typename V>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_vec4(const V* __restrict__ table, const int32_t* __restrict__ ids,
                 float4* __restrict__ out, int64_t n, int64_t n_rows,
                 int64_t pitch4, int64_t dim4) {
  const int64_t row = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const V* src = table + id * pitch4;
  float4* dst = out + row * dim4;
  for (int64_t c = lane; c < dim4; c += kWarp) dst[c] = widen4(__ldg(src + c));
}

// Scalar gather for row pitches or widths that are not multiples of four.
template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_scalar(const T* __restrict__ table, const int32_t* __restrict__ ids,
                   float* __restrict__ out, int64_t n, int64_t n_rows,
                   int64_t pitch, int64_t dim) {
  const int64_t row = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= n) return;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const T* src = table + id * pitch;
  float* dst = out + row * dim;
  for (int64_t c = lane; c < dim; c += kWarp) dst[c] = to_float(src[c]);
}

// Wide fp32 gather of 16-byte aligned rows: block (row, chunk of
// kCopyChunk elements), copied global -> shared -> global by two bulk
// copies that the block's first thread issues.
__global__ void __launch_bounds__(kWarp)
gather_rows_wide_bulk(const float* __restrict__ table,
                      const int32_t* __restrict__ ids, float* __restrict__ out,
                      int64_t n_rows, int64_t pitch, int64_t dim) {
  __shared__ __align__(128) float buf[kCopyChunk];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x != 0) return;
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const int64_t c0 = int64_t(blockIdx.y) * kCopyChunk;
  const uint32_t bytes =
      uint32_t(dim - c0 < kCopyChunk ? dim - c0 : kCopyChunk) * 4u;
  const uint32_t b = smem_u32(&bar);
  mbar_init(b, 1);
  mbar_expect_tx(b, bytes);
  bulk_load(smem_u32(buf), table + id * pitch + c0, bytes, b);
  mbar_wait(b, 0);
  bulk_store(out + row * dim + c0, smem_u32(buf), bytes);
  bulk_wait_read();
}

// Wide vector gather: block (row, chunk), kWideVecs vectors per thread,
// all loaded before the first store.
template <typename V>
__global__ void __launch_bounds__(kWideThreads)
gather_rows_wide_vec4(const V* __restrict__ table,
                      const int32_t* __restrict__ ids, float4* __restrict__ out,
                      int64_t n_rows, int64_t pitch4, int64_t dim4) {
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const V* src = table + id * pitch4;
  float4* dst = out + row * dim4;
  const int64_t c0 = int64_t(blockIdx.y) * (kWideChunk / 4) + threadIdx.x;
  V v[kWideVecs] = {};
#pragma unroll
  for (int m = 0; m < kWideVecs; ++m) {
    const int64_t c = c0 + m * kWideThreads;
    if (c < dim4) v[m] = __ldg(src + c);
  }
#pragma unroll
  for (int m = 0; m < kWideVecs; ++m) {
    const int64_t c = c0 + m * kWideThreads;
    if (c < dim4) dst[c] = widen4(v[m]);
  }
}

// Wide scalar gather, for pitches or widths that are not multiples of four:
// the same blocks of kWideChunk elements, 4 * kWideVecs per thread.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
gather_rows_wide_scalar(const T* __restrict__ table,
                        const int32_t* __restrict__ ids,
                        float* __restrict__ out, int64_t n_rows, int64_t pitch,
                        int64_t dim) {
  constexpr int kPer = kWideChunk / kWideThreads;
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const T* src = table + id * pitch;
  float* dst = out + row * dim;
  const int64_t c0 = int64_t(blockIdx.y) * kWideChunk + threadIdx.x;
  float v[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int64_t c = c0 + m * kWideThreads;
    v[m] = c < dim ? to_float(src[c]) : 0.f;
  }
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int64_t c = c0 + m * kWideThreads;
    if (c < dim) dst[c] = v[m];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One block per position of the sorted ids; only the block at a segment's
// head works.  kAdagrad: the Adagrad update (state_sum != nullptr);
// otherwise the plain row add emb[u] += sum_occ(delta).
template <typename T, bool kAdagrad>
__global__ void __launch_bounds__(kUpdateThreads)
segment_update(T* __restrict__ emb, float* __restrict__ state_sum,
               int64_t n_rows, int64_t pitch, int64_t dim,
               const int32_t* __restrict__ sids,
               const int64_t* __restrict__ order,
               const float* __restrict__ grads, int64_t n, float lr) {
  const int64_t pos = blockIdx.x;
  const int32_t u = sids[pos];
  if (pos > 0 && sids[pos - 1] == u) return;
  if (u < 0 || u >= n_rows) __trap();
  int64_t end = pos + 1;
  while (end < n && sids[end] == u) ++end;

  float row_std = 1.f;
  if (kAdagrad) {
    __shared__ float warp_part[kUpdateThreads / kWarp];
    __shared__ float seg_std;
    // Fixed column-to-thread assignment and fixed occurrence order: the
    // sum of squares comes out the same on every run.
    float part = 0.f;
    for (int64_t j = pos; j < end; ++j) {
      const float* g = grads + order[j] * dim;
      for (int64_t c = threadIdx.x; c < dim; c += kUpdateThreads) {
        const float x = g[c];
        part += x * x;
      }
    }
    part = warp_sum(part);
    if (threadIdx.x % kWarp == 0) warp_part[threadIdx.x / kWarp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kUpdateThreads / kWarp; ++w) total += warp_part[w];
      const float ss = state_sum[u] + total / float(dim);
      state_sum[u] = ss;
      seg_std = sqrtf(ss) + 1e-10f;
    }
    __syncthreads();
    row_std = seg_std;
  }

  T* row = emb + int64_t(u) * pitch;
  for (int64_t c = threadIdx.x; c < dim; c += kUpdateThreads) {
    float acc = 0.f;
    for (int64_t j = pos; j < end; ++j) acc += grads[order[j] * dim + c];
    const float delta = kAdagrad ? (-lr * acc) / row_std : acc;
    store(row + c, to_float(row[c]) + delta);
  }
}

template <typename T>
void launch_update(void* emb, float* state_sum, int64_t n_rows, int64_t pitch,
                   int64_t dim, const int32_t* sids, const int64_t* order,
                   const float* grads, int64_t n, float lr,
                   cudaStream_t stream) {
  T* e = static_cast<T*>(emb);
  if (state_sum != nullptr) {
    segment_update<T, true><<<static_cast<unsigned>(n), kUpdateThreads, 0, stream>>>(
        e, state_sum, n_rows, pitch, dim, sids, order, grads, n, lr);
  } else {
    segment_update<T, false><<<static_cast<unsigned>(n), kUpdateThreads, 0, stream>>>(
        e, nullptr, n_rows, pitch, dim, sids, order, grads, n, lr);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 table, 1 = bfloat16 table.  pitch: table row stride in
// elements.  out: [n, dim] float32, contiguous.  wide: 0 = one warp per
// row, 1 = blocks of (row, chunk of 2,048 or 4,096 elements).  Requires
// 0 < n < 2^31, and with wide, at most 65,535 chunks of 2,048.
int dglke_gather_rows(const void* table, int dtype, int64_t n_rows,
                      int64_t pitch, const int32_t* ids, int64_t n,
                      float* out, int64_t dim, int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows_per_block = kGatherThreads / kWarp;
  const unsigned blocks =
      static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(table);
  const bool vec = pitch % 4 == 0 && dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   addr % (dtype == 0 ? 16 : 8) == 0;
  if (wide && dtype == 0 && vec) {
    const dim3 grid(static_cast<unsigned>(n),
                    static_cast<unsigned>((dim + kCopyChunk - 1) / kCopyChunk));
    gather_rows_wide_bulk<<<grid, kWarp, 0, s>>>(
        static_cast<const float*>(table), ids, out, n_rows, pitch, dim);
  } else if (wide) {
    const dim3 grid(static_cast<unsigned>(n),
                    static_cast<unsigned>((dim + kWideChunk - 1) / kWideChunk));
    if (dtype == 1 && vec) {
      gather_rows_wide_vec4<uint2><<<grid, kWideThreads, 0, s>>>(
          static_cast<const uint2*>(table), ids,
          reinterpret_cast<float4*>(out), n_rows, pitch / 4, dim / 4);
    } else if (dtype == 0) {
      gather_rows_wide_scalar<float><<<grid, kWideThreads, 0, s>>>(
          static_cast<const float*>(table), ids, out, n_rows, pitch, dim);
    } else {
      gather_rows_wide_scalar<__nv_bfloat16><<<grid, kWideThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(table), ids, out, n_rows, pitch,
          dim);
    }
  } else if (dtype == 0 && vec) {
    gather_rows_vec4<float4><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const float4*>(table), ids, reinterpret_cast<float4*>(out),
        n, n_rows, pitch / 4, dim / 4);
  } else if (dtype == 1 && vec) {
    gather_rows_vec4<uint2><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const uint2*>(table), ids, reinterpret_cast<float4*>(out),
        n, n_rows, pitch / 4, dim / 4);
  } else if (dtype == 0) {
    gather_rows_scalar<float><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const float*>(table), ids, out, n, n_rows, pitch, dim);
  } else {
    gather_rows_scalar<__nv_bfloat16><<<blocks, kGatherThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(table), ids, out, n, n_rows, pitch,
        dim);
  }
  return static_cast<int>(cudaGetLastError());
}

// Sorted-segment row update.  sids: [n] ids sorted ascending (stable);
// order: [n] positions of the sorted ids in grads; grads: [n, dim] float32,
// contiguous.  state_sum: [n_rows] float32 for the Adagrad update, or null
// for the plain row add.  Requires n > 0.
int dglke_segment_update(void* emb, int dtype, int64_t n_rows, int64_t pitch,
                         int64_t dim, float* state_sum, const int32_t* sids,
                         const int64_t* order, const float* grads, int64_t n,
                         float lr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_update<float>(emb, state_sum, n_rows, pitch, dim, sids, order,
                         grads, n, lr, s);
  } else {
    launch_update<__nv_bfloat16>(emb, state_sum, n_rows, pitch, dim, sids,
                                 order, grads, n, lr, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
