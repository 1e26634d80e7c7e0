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
//   * the wide bulk copy with a sum (dglke_gather_rows_pow_sum), a kernel of
//     its own beside the plain one: RESCAL's step needs sum |x|^p over the
//     relation rows it gathers (the regularization value), which three
//     PyTorch passes over the 1 GB copy took (abs, pow, sum: 5 GB of
//     traffic, ~1.7 ms a step).  Here the warp sums the chunk while it lies
//     in shared memory between the bulk load and the bulk store, so the
//     value costs no byte of device memory; it writes one partial in fp64
//     per (row, chunk), which ops/rows.py adds up by rows.
//   * the wide bulk copy with RESCAL's matrix-vector product
//     (dglke_gather_rows_matvec): RESCAL's step views each gathered
//     relation row as a [hidden, hidden] matrix R and needs R t (head-
//     corrupt steps) or h^T R (tail-corrupt), one entity vector an edge,
//     which a cuBLAS matvec computed by reading the whole 1 GB copy again.
//     Here a block owns a band of whole matrix rows of one gathered row,
//     streamed through two shared-memory stages by bulk loads (the next
//     stage loads while the threads read this one), each stage stored out
//     by a bulk store as the plain copy stores it.  While a stage lies in
//     shared memory the threads form the product from it, and |x|^p with
//     it: R t's dot of a matrix row with t (a warp a matrix row) ends in the
//     block; h^T R leaves an fp64 partial a (row, band) and column, which
//     ops/rows.py sums over the bands (so R t takes narrow bands, which
//     keep a row's repeats in the batch closer together in L2, and h^T R
//     wide ones, which keep its partials few).  Products of two fp32
//     values are exact in fp64 and every sum runs in fp64 in a fixed
//     order, rounded to fp32 once.  The product costs two flops an element
//     and no byte of device memory besides its [hidden] result (or
//     partials).
//   * host-resident tables (--mix_cpu_gpu): a table in host memory pinned
//     in place and mapped into the device's address space
//     (dglke_host_register) is read and written by kernels at its
//     device-side address, so only the batch's touched rows cross the host
//     link (PCIe).  There the link, not HBM, bounds them, and what the SMs
//     get of it: on an H100 the copy engine reads a mapped table at ~50
//     GB/s, the SMs' own reads reach 24-45 GB/s depending on the host, and
//     cp.async copies whose warp instruction starts off a 128-byte line ran
//     up to three times slower than line-aligned ones.  A
//     mapped table's rows are gathered by gather_rows_mapped: a warp takes
//     a row (or a chunk of 1,920 bytes of a wide row) and copies the whole
//     aligned 128-byte lines that cover it into shared memory with 16-byte
//     cp.async copies, two rows a warp in flight before the first store,
//     then shifts the row into place as it writes it out; the grid is
//     sized from the SM count and strides over the rows.  The update of a
//     mapped table (dglke_segment_update given rows) reads the rows it
//     starts from on the card, from the rows the step's gather already
//     holds at the same ids, so each touched row crosses the link once each
//     way a step and the update's link traffic is its writes.  The
//     arithmetic is the update's below, unchanged.
//   * update: the TPU kernel serialised duplicate ids inside its DMA window
//     with conflict flags; a GPU has no such window, and fp32 atomics would
//     make the sum depend on the order in which blocks run.  The wrapper
//     groups the ids first (ops/csrc/group_ids.cu: the stable sort, the
//     segments' heads, their ids and their count), and the update is
//     launched over segments: the k-th warp or block takes segment k and
//     those past the count return at once.  Within a segment the gradient
//     rows are summed in ascending position order, so the result is the
//     same on every run, and each touched row is read and written exactly
//     once, with one rounding to the table dtype.  Two routes, chosen by the
//     wrapper from the width (ops/rows.py:plan_update):
//     - "warp", rows of up to 1,024 elements: one warp per segment, each
//       lane holding up to 8 vectors of four elements in registers.  The
//       table row's load is issued first, so it is in flight while the warp
//       reads the gradient rows; Sum g and Sum g^2 come from the same 16-byte
//       load of each gradient row (each is read once), and Sum g^2 is
//       reduced by warp shuffles, with no block barrier.
//     - "block", wider rows (TransR's 160,000-wide projection rows): one
//       block of 256 threads per segment.  Adagrad needs the row's whole
//       Sum g^2 before any write, so a first pass reduces it over the block
//       and a second sums g per column and writes; the gradient rows are
//       read twice.
//
// Interface: plain C functions taking pointers, sizes and the CUDA stream;
// each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bulk_copy.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kGatherThreads = 256;   // 8 rows per block
constexpr int kUpdateThreads = 256;   // 8 segments per block (warp route),
                                      // one per block (block route)
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

// Wide bf16 vector gather: block (row, chunk), kWideVecs vectors of four
// bf16 per thread, all loaded before the first store.
__global__ void __launch_bounds__(kWideThreads)
gather_rows_wide_vec4(const uint2* __restrict__ table,
                      const int32_t* __restrict__ ids, float4* __restrict__ out,
                      int64_t n_rows, int64_t pitch4, int64_t dim4) {
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const uint2* src = table + id * pitch4;
  float4* dst = out + row * dim4;
  const int64_t c0 = int64_t(blockIdx.y) * (kWideChunk / 4) + threadIdx.x;
  uint2 v[kWideVecs] = {};
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

// Mapped gather (host-resident tables): one window a (row, chunk) item, the
// whole 128-byte lines covering the chunk's bytes (ops/rows.py:line_window
// is the same arithmetic), copied by 16-byte cp.async into the warp's slot;
// kMapRows items a warp in flight.  A chunk is at most kMapSlot - kLine
// bytes, so its window fits the slot at any shift.
constexpr int kLine = 128;
constexpr int kMapSlot = 2048;
constexpr int kMapRows = 2;
// Small blocks (4 rows), many of them, so the scheduler spreads the rows
// evenly over the SMs.
constexpr int kMapThreads = 64;
constexpr int kMapWarps = kMapThreads / kWarp;
constexpr int kMapBlocksPerSM = 16;  // 8 KB of slots a block

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out[k, :dim] = float32(table[ids[k], :dim]) for k < n.  A lane skips the vectors of its window that hold no byte of the row, so
// the link carries the row's own 32-byte sectors, while each warp
// instruction still spans whole lines.
template <typename T>
__global__ void __launch_bounds__(kMapThreads)
gather_rows_mapped(const T* __restrict__ table, int64_t n_rows, int64_t pitch,
                   const int32_t* __restrict__ ids, int64_t n,
                   float* __restrict__ out, int64_t dim, int64_t chunk) {
  __shared__ __align__(16) unsigned char slots[kMapWarps][kMapRows][kMapSlot];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t chunks = (dim + chunk - 1) / chunk;
  const int64_t items = n * chunks;
  const int64_t step = int64_t(gridDim.x) * kMapWarps * kMapRows;
  for (int64_t i0 = (int64_t(blockIdx.x) * kMapWarps + warp) * kMapRows;
       i0 < items; i0 += step) {
    int64_t row[kMapRows], c0[kMapRows];
    int width[kMapRows], shift[kMapRows];
#pragma unroll
    for (int k = 0; k < kMapRows; ++k) {
      row[k] = -1;
      if (i0 + k >= items) continue;
      row[k] = (i0 + k) / chunks;
      c0[k] = (i0 + k) % chunks * chunk;
      const int64_t id = ids[row[k]];
      if (id < 0 || id >= n_rows) __trap();
      width[k] = static_cast<int>(dim - c0[k] < chunk ? dim - c0[k] : chunk);
      const uintptr_t a = reinterpret_cast<uintptr_t>(table + id * pitch + c0[k]);
      const uintptr_t a_end = a + uintptr_t(width[k]) * sizeof(T);
      const uintptr_t first = a & ~uintptr_t(kLine - 1);
      const uintptr_t end = (a_end + kLine - 1) & ~uintptr_t(kLine - 1);
      shift[k] = static_cast<int>(a - first);
      const uint32_t slot = smem_u32(slots[warp][k]);
      for (uintptr_t v = first + 16 * lane; v < end; v += 16 * kWarp)
        if (v + 16 > a && v < a_end)
          cp_async16(slot + static_cast<uint32_t>(v - first),
                     reinterpret_cast<const void*>(v));
    }
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kMapRows; ++k) {
      if (row[k] < 0) continue;
      const T* src = reinterpret_cast<const T*>(slots[warp][k] + shift[k]);
      float* dst = out + row[k] * dim + c0[k];
      if (sizeof(T) == 4 && shift[k] % 16 == 0 && width[k] % 4 == 0 &&
          reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
        // fp32 rows on 16-byte boundaries: whole vectors out of the slot
        const float4* src4 = reinterpret_cast<const float4*>(src);
        float4* dst4 = reinterpret_cast<float4*>(dst);
        for (int e = lane; e < width[k] / 4; e += kWarp) dst4[e] = src4[e];
      } else {
        for (int e = lane; e < width[k]; e += kWarp) dst[e] = to_float(src[e]);
      }
    }
    __syncwarp();
  }
}

template <typename T>
int launch_gather_mapped(const T* table, int64_t n_rows, int64_t pitch,
                         const int32_t* ids, int64_t n, float* out,
                         int64_t dim, int64_t chunk, cudaStream_t s) {
  if (chunk <= 0 || chunk * int64_t(sizeof(T)) > kMapSlot - kLine)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t items = n * ((dim + chunk - 1) / chunk);
  const int64_t per_block = int64_t(kMapWarps) * kMapRows;
  int64_t blocks = (items + per_block - 1) / per_block;
  if (blocks > int64_t(sms) * kMapBlocksPerSM) blocks = int64_t(sms) * kMapBlocksPerSM;
  gather_rows_mapped<T><<<static_cast<unsigned>(blocks), kMapThreads, 0, s>>>(
      table, n_rows, pitch, ids, n, out, dim, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Sum over a warp by a butterfly.  Every lane ends with the same bits: at
// each step a lane adds the same two values as its partner, in the other
// order, and addition commutes.
__device__ __forceinline__ double warp_allsum(double x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// |x|^p for p = 1, 2 or 3, by repeated products of |x| as torch.pow takes
// those exponents: the same fp32 term as torch.abs(x) ** p.
template <int kPow>
__device__ __forceinline__ float pow_abs(float x) {
  const float a = fabsf(x);
  if constexpr (kPow == 1) return a;
  else if constexpr (kPow == 2) return a * a;
  else return a * a * a;
}

// gather_rows_wide_bulk that also sums |x|^p over the chunk it copies (the
// regularization value of RESCAL's relation rows, duplicates counted):
// every lane waits for the bulk load, the first issues the bulk store, and
// meanwhile the warp reads the chunk out of shared memory (lane l takes
// vectors l, l + 32, ...: no bank conflict) and sums the terms, four in
// fp32 and then in fp64.  Both only read the buffer, so the sum overlaps
// the store and moves no byte of device memory; lane 0 writes the chunk's
// sum to partials[row * chunks + chunk].
template <int kPow>
__global__ void __launch_bounds__(kWarp)
gather_rows_wide_pow_sum(const float* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int64_t n_rows,
                         int64_t pitch, int64_t dim,
                         double* __restrict__ partials) {
  __shared__ __align__(128) float buf[kCopyChunk];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const int64_t c0 = int64_t(blockIdx.y) * kCopyChunk;
  const int width = static_cast<int>(dim - c0 < kCopyChunk ? dim - c0
                                                           : kCopyChunk);
  const uint32_t bytes = uint32_t(width) * 4u;
  const uint32_t b = smem_u32(&bar);
  if (lane == 0) {
    mbar_init(b, 1);
    mbar_expect_tx(b, bytes);
    bulk_load(smem_u32(buf), table + id * pitch + c0, bytes, b);
  }
  __syncwarp();
  mbar_wait(b, 0);
  if (lane == 0) bulk_store(out + row * dim + c0, smem_u32(buf), bytes);
  const float4* buf4 = reinterpret_cast<const float4*>(buf);
  double part = 0.0;
  for (int v = lane; v < width / 4; v += kWarp) {
    const float4 x = buf4[v];
    part += static_cast<double>(pow_abs<kPow>(x.x) + pow_abs<kPow>(x.y) +
                                pow_abs<kPow>(x.z) + pow_abs<kPow>(x.w));
  }
  part = warp_allsum(part);
  if (lane == 0) {
    partials[row * gridDim.y + blockIdx.y] = part;
    bulk_wait_read();
  }
}

// The wide bulk copy with RESCAL's product (dglke_gather_rows_matvec).
// Block (row, band): the band's matrix rows [r0, r1) of gathered row `row`,
// in stages of stage_rows matrix rows (stage_rows * hidden a multiple of
// four, so every stage starts on 16 bytes) through kMatvecBufs buffers, each
// stage's bulk load issued kMatvecBufs stages ahead.  kHead: tmp[row, i] =
// sum_j R[i, j] v[j] for i in the band, a warp a matrix row; else
// tmp_partials[row, band, j] = sum over the band's i of v[i] R[i, j], thread
// tid holding columns tid + k * kMatvecThreads.  With kPow,
// pow_partials[row, band] = the band's sum of |x|^p.
constexpr int kMatvecThreads = 128;
constexpr int kMatvecWarps = kMatvecThreads / kWarp;
constexpr int kMatvecStage = 2048;       // fp32 elements a stage buffer holds
constexpr int kMatvecBufs = 2;
constexpr int kMatvecMaxHidden = 1024;
constexpr int kMatvecCols = kMatvecMaxHidden / kMatvecThreads;

template <int kPow, bool kHead>
__global__ void __launch_bounds__(kMatvecThreads)
gather_rows_matvec(const float* __restrict__ table,
                   const int32_t* __restrict__ ids, float* __restrict__ out,
                   int64_t n_rows, int64_t pitch, int hidden,
                   const float* __restrict__ vecs, int64_t vec_pitch,
                   int stage_rows, int band_rows, float* __restrict__ tmp,
                   double* __restrict__ tmp_partials,
                   double* __restrict__ pow_partials) {
  __shared__ __align__(128) float buf[kMatvecBufs][kMatvecStage];
  __shared__ float v[kMatvecMaxHidden];
  __shared__ __align__(8) uint64_t bar[kMatvecBufs];
  __shared__ double warp_part[kMatvecWarps];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int64_t row = blockIdx.x;
  const int64_t id = ids[row];
  if (id < 0 || id >= n_rows) __trap();
  const int r0 = static_cast<int>(blockIdx.y) * band_rows;
  const int r1 = min(r0 + band_rows, hidden);
  const int stages = (r1 - r0 + stage_rows - 1) / stage_rows;
  const float* src = table + id * pitch;
  float* dst = out + row * int64_t(hidden) * hidden;
  // Stage s: matrix rows [r0 + s * stage_rows, +rows), into buffer s %
  // kMatvecBufs, whose (s / kMatvecBufs)-th phase its bulk load completes.
  auto stage_size = [&](int s) {
    return min(stage_rows, r1 - r0 - s * stage_rows);
  };
  auto issue = [&](int s) {
    const uint32_t b = smem_u32(&bar[s % kMatvecBufs]);
    const uint32_t bytes = uint32_t(stage_size(s)) * uint32_t(hidden) * 4u;
    mbar_expect_tx(b, bytes);
    bulk_load(smem_u32(buf[s % kMatvecBufs]),
              src + int64_t(r0 + s * stage_rows) * hidden, bytes, b);
  };
  if (tid == 0) {
    for (int k = 0; k < kMatvecBufs; ++k) mbar_init(smem_u32(&bar[k]), 1);
    for (int k = 0; k < kMatvecBufs && k < stages; ++k) issue(k);
  }
  for (int j = tid; j < hidden; j += kMatvecThreads)
    v[j] = vecs[row * vec_pitch + j];
  __syncthreads();
  double acc[kMatvecCols] = {};
  double part = 0.0;
  for (int s = 0; s < stages; ++s) {
    const int a = r0 + s * stage_rows;
    const int rows = stage_size(s);
    mbar_wait(smem_u32(&bar[s % kMatvecBufs]), (s / kMatvecBufs) & 1);
    const float* x = buf[s % kMatvecBufs];
    if (tid == 0)
      bulk_store(dst + int64_t(a) * hidden, smem_u32(x),
                 uint32_t(rows) * uint32_t(hidden) * 4u);
    if constexpr (kHead) {
      for (int i = warp; i < rows; i += kMatvecWarps) {
        double dot = 0.0;
        for (int j = lane; j < hidden; j += kWarp) {
          const float e = x[i * hidden + j];
          dot += static_cast<double>(e) * static_cast<double>(v[j]);
          if constexpr (kPow > 0) part += double(pow_abs<kPow>(e));
        }
        dot = warp_allsum(dot);
        if (lane == 0) tmp[row * hidden + a + i] = static_cast<float>(dot);
      }
    } else {
      for (int i = 0; i < rows; ++i) {
        const double h = static_cast<double>(v[a + i]);
#pragma unroll
        for (int k = 0; k < kMatvecCols; ++k) {
          const int j = tid + k * kMatvecThreads;
          if (j < hidden) {
            const float e = x[i * hidden + j];
            acc[k] += h * static_cast<double>(e);
            if constexpr (kPow > 0) part += double(pow_abs<kPow>(e));
          }
        }
      }
    }
    __syncthreads();   // every thread is done with stage s's buffer
    if (tid == 0 && s + kMatvecBufs < stages) {
      bulk_wait_read();  // and so is the bulk store of stage s
      issue(s + kMatvecBufs);
    }
  }
  const int64_t slot = row * gridDim.y + blockIdx.y;
  if constexpr (!kHead) {
#pragma unroll
    for (int k = 0; k < kMatvecCols; ++k) {
      const int j = tid + k * kMatvecThreads;
      if (j < hidden) tmp_partials[slot * hidden + j] = acc[k];
    }
  }
  if constexpr (kPow > 0) {
    part = warp_allsum(part);
    if (lane == 0) warp_part[warp] = part;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int w = 0; w < kMatvecWarps; ++w) total += warp_part[w];
      pow_partials[slot] = total;
    }
  }
  if (tid == 0) bulk_wait_read();
}

template <int kPow>
void launch_matvec(bool head, dim3 grid, cudaStream_t s, const float* table,
                   const int32_t* ids, float* out, int64_t n_rows,
                   int64_t pitch, int hidden, const float* vecs,
                   int64_t vec_pitch, int stage_rows, int band_rows,
                   float* tmp, double* tmp_partials, double* pow_partials) {
  if (head)
    gather_rows_matvec<kPow, true><<<grid, kMatvecThreads, 0, s>>>(
        table, ids, out, n_rows, pitch, hidden, vecs, vec_pitch, stage_rows,
        band_rows, tmp, tmp_partials, pow_partials);
  else
    gather_rows_matvec<kPow, false><<<grid, kMatvecThreads, 0, s>>>(
        table, ids, out, n_rows, pitch, hidden, vecs, vec_pitch, stage_rows,
        band_rows, tmp, tmp_partials, pow_partials);
}

// A row's vector of four elements: float4 for fp32, uint2 (four bf16).
template <typename T> struct Vec4 { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void store4(float4* p, float4 v) { *p = v; }
__device__ __forceinline__ void store4(uint2* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *p = make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                  *reinterpret_cast<uint32_t*>(&hi));
}

__device__ __forceinline__ void add4(float4& a, float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ void add_squares4(float& s, float4 v) {
  s += v.x * v.x;
  s += v.y * v.y;
  s += v.z * v.z;
  s += v.w * v.w;
}

// The change of one element from its segment's summed gradient: Adagrad's
// -lr * sum(g) / std, or the plain row add's sum(delta).
template <bool kAdagrad>
__device__ __forceinline__ float step(float acc, float lr, float row_std) {
  return kAdagrad ? (-lr * acc) / row_std : acc;
}

template <bool kAdagrad>
__device__ __forceinline__ float4 update4(float4 x, float4 acc, float lr,
                                          float row_std) {
  x.x += step<kAdagrad>(acc.x, lr, row_std);
  x.y += step<kAdagrad>(acc.y, lr, row_std);
  x.z += step<kAdagrad>(acc.z, lr, row_std);
  x.w += step<kAdagrad>(acc.w, lr, row_std);
  return x;
}

// What both update routes are given.  Segment k of the grouping
// (group_ids.cu) is the occurrences order[heads[k] .. heads[k + 1]) of row
// seg_ids[k], for k < count[0]; seg_first[k] = order[heads[k]], so that a
// segment of one occurrence reads no order at all.  With rows (kRows, a
// mapped table) the row segment k starts from is read on the card, at
// rows[seg_first[k]] of the rows the caller gathered at the ids, and its
// state_sum entry at the table's; the results are written to the table's
// row seg_ids[k].
struct UpdateArgs {
  void* emb;
  float* state_sum;  // null: the plain row add
  int64_t n_rows, pitch;
  int dim;
  const int64_t* order;
  const int32_t* heads;
  const int32_t* seg_ids;
  const int32_t* seg_first;
  const int32_t* count;
  const float* grads;
  int64_t n;
  float lr;
  const float* rows;  // [n, dim] fp32 at the ids' positions, or null
};

struct Segment {
  int begin, end, u, first;
};

// Segment k, or false past the count.  The five loads are issued together;
// what they read past the count (inside the arrays, as k < n) is not used.
__device__ __forceinline__ bool load_segment(const UpdateArgs& a, int64_t k,
                                             Segment* s) {
  if (k >= a.n) return false;
  const int segs = *a.count;
  s->begin = a.heads[k];
  s->end = a.heads[k + 1];
  s->u = a.seg_ids[k];
  s->first = a.seg_first[k];
  if (k >= segs) return false;
  if (s->u < 0 || s->u >= a.n_rows) __trap();
  return true;
}

// The position in grads of the segment's j-th sorted occurrence.
__device__ __forceinline__ int64_t occurrence(const UpdateArgs& a,
                                              const Segment& s, int j) {
  return j == s.begin ? s.first : a.order[j];
}

// Adagrad: state_sum[u] += Sum g^2 / dim (the lanes' partial sums reduced
// in a fixed order), stored by lane 0; returns sqrt(state_sum[u]) + 1e-10.
// Sum g^2 is carried in fp64 across occurrences: a segment of a thousand
// occurrences adds some 20,000 squares on each lane, and an fp32 sum of
// that length strays by 1e-5 and more.
template <bool kAdagrad>
__device__ __forceinline__ float warp_std(const UpdateArgs& a, int u,
                                          float ss0, double sq, int lane) {
  if (!kAdagrad) return 1.f;
  const float ss = ss0 + static_cast<float>(warp_allsum(sq) / a.dim);
  if (lane == 0) a.state_sum[u] = ss;
  return sqrtf(ss) + 1e-10f;
}

// Where segment k's row starts from: the table's row u, or with kRows the
// caller's fp32 copy of it on the card.
template <typename T, bool kRows>
using Source = typename std::conditional<kRows, float, T>::type;

template <typename T, bool kRows>
__device__ __forceinline__ const Source<T, kRows>* source_row(
    const UpdateArgs& a, const Segment& s, const T* row) {
  if constexpr (kRows)
    return a.rows + int64_t(s.first) * a.dim;
  else
    return row;
}

// The warp route: one warp per segment, rows of up to 128 * K elements.
// kVec: lane l holds vectors l, l + 32, ... (K of them) of 16-byte aligned
// rows; otherwise elements l, l + 32, ... (4K of them).  The row and its
// state are loaded first and used last; each gradient row is loaded once,
// in ascending position order, into both sums.
template <typename T, bool kAdagrad, bool kVec, int K, bool kRows>
__global__ void __launch_bounds__(kUpdateThreads)
segment_update_warp(const UpdateArgs a) {
  using S = Source<T, kRows>;
  const int lane = threadIdx.x % kWarp;
  const int64_t k = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  Segment s;
  if (!load_segment(a, k, &s)) return;
  T* row = static_cast<T*>(a.emb) + int64_t(s.u) * a.pitch;
  const S* src = source_row<T, kRows>(a, s, row);
  const float ss0 = kAdagrad ? a.state_sum[s.u] : 0.f;
  double sq = 0.0;
  if constexpr (kVec) {
    using V = typename Vec4<T>::type;
    using VS = typename Vec4<S>::type;
    V* row4 = reinterpret_cast<V*>(row);
    const VS* src4 = reinterpret_cast<const VS*>(src);
    const int dim4 = a.dim / 4;
    VS raw[K];
    float4 acc[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int c = lane + kWarp * m;
      raw[m] = src4[c < dim4 ? c : 0];
      acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j = s.begin; j < s.end; ++j) {
      const float4* g =
          reinterpret_cast<const float4*>(a.grads + occurrence(a, s, j) * a.dim);
      float occ = 0.f;
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int c = lane + kWarp * m;
        if (c < dim4) {
          const float4 v = __ldg(g + c);
          add4(acc[m], v);
          add_squares4(occ, v);
        }
      }
      sq += occ;
    }
    const float row_std = warp_std<kAdagrad>(a, s.u, ss0, sq, lane);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const int c = lane + kWarp * m;
      if (c < dim4)
        store4(row4 + c, update4<kAdagrad>(widen4(raw[m]), acc[m], a.lr, row_std));
    }
  } else {
    constexpr int kE = 4 * K;
    S raw[kE];
    float acc[kE];
#pragma unroll
    for (int m = 0; m < kE; ++m) {
      const int c = lane + kWarp * m;
      raw[m] = src[c < a.dim ? c : 0];
      acc[m] = 0.f;
    }
    for (int j = s.begin; j < s.end; ++j) {
      const float* g = a.grads + occurrence(a, s, j) * a.dim;
      float occ = 0.f;
#pragma unroll
      for (int m = 0; m < kE; ++m) {
        const int c = lane + kWarp * m;
        if (c < a.dim) {
          const float v = __ldg(g + c);
          acc[m] += v;
          occ += v * v;
        }
      }
      sq += occ;
    }
    const float row_std = warp_std<kAdagrad>(a, s.u, ss0, sq, lane);
#pragma unroll
    for (int m = 0; m < kE; ++m) {
      const int c = lane + kWarp * m;
      if (c < a.dim)
        store(row + c, to_float(raw[m]) + step<kAdagrad>(acc[m], a.lr, row_std));
    }
  }
}

// The block route: one block per segment, for rows wider than a warp holds.
// Pass 1 sums g^2 over the segment (each thread over fixed columns in fp32
// for each occurrence, in fp64 across them, then the warps in order); pass
// 2 sums g per column in ascending position order and writes each element
// once.
template <typename T, bool kAdagrad, bool kVec, bool kRows>
__global__ void __launch_bounds__(kUpdateThreads)
segment_update_block(const UpdateArgs a) {
  using S = Source<T, kRows>;
  __shared__ double warp_part[kUpdateThreads / kWarp];
  __shared__ float seg_std;
  Segment s;
  const int64_t k = blockIdx.x;
  if (!load_segment(a, k, &s)) return;
  const int tid = threadIdx.x;
  T* row = static_cast<T*>(a.emb) + int64_t(s.u) * a.pitch;
  const S* src = source_row<T, kRows>(a, s, row);
  float row_std = 1.f;
  if constexpr (kAdagrad) {
    double part = 0.0;
    for (int j = s.begin; j < s.end; ++j) {
      const float* g = a.grads + occurrence(a, s, j) * a.dim;
      float occ = 0.f;
      if constexpr (kVec) {
        const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
        for (int c = tid; c < a.dim / 4; c += kUpdateThreads)
          add_squares4(occ, __ldg(g4 + c));
      } else {
#pragma unroll 4
        for (int c = tid; c < a.dim; c += kUpdateThreads) {
          const float x = __ldg(g + c);
          occ += x * x;
        }
      }
      part += occ;
    }
    part = warp_allsum(part);
    if (tid % kWarp == 0) warp_part[tid / kWarp] = part;
    __syncthreads();
    if (tid == 0) {
      double total = 0.0;
      for (int w = 0; w < kUpdateThreads / kWarp; ++w) total += warp_part[w];
      const float ss = a.state_sum[s.u] + static_cast<float>(total / a.dim);
      a.state_sum[s.u] = ss;
      seg_std = sqrtf(ss) + 1e-10f;
    }
    __syncthreads();
    row_std = seg_std;
  }
  if constexpr (kVec) {
    using V = typename Vec4<T>::type;
    using VS = typename Vec4<S>::type;
    V* row4 = reinterpret_cast<V*>(row);
    const VS* src4 = reinterpret_cast<const VS*>(src);
    for (int c = tid; c < a.dim / 4; c += kUpdateThreads) {
      const VS raw = src4[c];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = s.begin; j < s.end; ++j)
        add4(acc, __ldg(reinterpret_cast<const float4*>(
                            a.grads + occurrence(a, s, j) * a.dim) + c));
      store4(row4 + c, update4<kAdagrad>(widen4(raw), acc, a.lr, row_std));
    }
  } else {
    for (int c = tid; c < a.dim; c += kUpdateThreads) {
      const S raw = src[c];
      float acc = 0.f;
      for (int j = s.begin; j < s.end; ++j)
        acc += __ldg(a.grads + occurrence(a, s, j) * a.dim + c);
      store(row + c, to_float(raw) + step<kAdagrad>(acc, a.lr, row_std));
    }
  }
}

template <typename T, bool kAdagrad, bool kVec, bool kRows>
void launch_update(const UpdateArgs& a, int block_route, int lane_vecs,
                   cudaStream_t s) {
  if (block_route) {
    segment_update_block<T, kAdagrad, kVec, kRows>
        <<<static_cast<unsigned>(a.n), kUpdateThreads, 0, s>>>(a);
    return;
  }
  constexpr int kSegsPerBlock = kUpdateThreads / kWarp;
  const unsigned blocks =
      static_cast<unsigned>((a.n + kSegsPerBlock - 1) / kSegsPerBlock);
  switch (lane_vecs) {
    case 1:
      segment_update_warp<T, kAdagrad, kVec, 1, kRows>
          <<<blocks, kUpdateThreads, 0, s>>>(a);
      break;
    case 2:
      segment_update_warp<T, kAdagrad, kVec, 2, kRows>
          <<<blocks, kUpdateThreads, 0, s>>>(a);
      break;
    case 4:
      segment_update_warp<T, kAdagrad, kVec, 4, kRows>
          <<<blocks, kUpdateThreads, 0, s>>>(a);
      break;
    default:
      segment_update_warp<T, kAdagrad, kVec, 8, kRows>
          <<<blocks, kUpdateThreads, 0, s>>>(a);
  }
}

template <typename T, bool kRows>
void launch_update(const UpdateArgs& a, bool vec, int block_route,
                   int lane_vecs, cudaStream_t s) {
  if (a.state_sum != nullptr) {
    if (vec) launch_update<T, true, true, kRows>(a, block_route, lane_vecs, s);
    else launch_update<T, true, false, kRows>(a, block_route, lane_vecs, s);
  } else {
    if (vec) launch_update<T, false, true, kRows>(a, block_route, lane_vecs, s);
    else launch_update<T, false, false, kRows>(a, block_route, lane_vecs, s);
  }
}

}  // namespace

extern "C" {

// K1 on a table in mapped host memory (any dtype code, pitch and address):
// gather_rows_mapped, windows of `chunk` elements (ops/rows.py:
// mapped_chunk).  out: [n, dim] float32, contiguous.
int dglke_gather_rows_mapped(const void* table, int dtype, int64_t n_rows,
                             int64_t pitch, const int32_t* ids, int64_t n,
                             float* out, int64_t dim, int64_t chunk,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_gather_mapped(static_cast<const float*>(table), n_rows,
                                pitch, ids, n, out, dim, chunk, s);
  return launch_gather_mapped(static_cast<const __nv_bfloat16*>(table), n_rows,
                              pitch, ids, n, out, dim, chunk, s);
}

// dtype: 0 = float32 table, 1 = bfloat16 table.  pitch: table row stride in
// elements.  out: [n, dim] float32, contiguous.  wide: 0 = one warp per
// row, 1 = blocks of (row, chunk of 2,048 or 4,096 elements), aligned fp32
// rows copied by the TMA engine.  Requires 0 < n < 2^31, and with wide, at
// most 65,535 chunks of 2,048.
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
      gather_rows_wide_vec4<<<grid, kWideThreads, 0, s>>>(
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

// The wide bulk gather of dglke_gather_rows (an fp32 table; table, pitch,
// dim and out on 16-byte boundaries), which also writes partials[row *
// chunks + chunk] = the sum of |x|^p over that chunk of the row, p = 1, 2
// or 3, chunks = ceil(dim / 2,048): gather_rows_wide_pow_sum.  Requires 0
// < n < 2^31, at most 65,535 chunks and n * chunks fp64 slots of partials.
int dglke_gather_rows_pow_sum(const float* table, int64_t n_rows,
                              int64_t pitch, const int32_t* ids, int64_t n,
                              float* out, int64_t dim, int p,
                              double* partials, int64_t slots, void* stream) {
  const int64_t chunks = (dim + kCopyChunk - 1) / kCopyChunk;
  if (p < 1 || p > 3 || n <= 0 || pitch % 4 != 0 || dim % 4 != 0 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || slots < n * chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n), static_cast<unsigned>(chunks));
  if (p == 1)
    gather_rows_wide_pow_sum<1><<<grid, kWarp, 0, s>>>(table, ids, out, n_rows,
                                                        pitch, dim, partials);
  else if (p == 2)
    gather_rows_wide_pow_sum<2><<<grid, kWarp, 0, s>>>(table, ids, out, n_rows,
                                                        pitch, dim, partials);
  else
    gather_rows_wide_pow_sum<3><<<grid, kWarp, 0, s>>>(table, ids, out, n_rows,
                                                        pitch, dim, partials);
  return static_cast<int>(cudaGetLastError());
}

// The wide bulk copy of [hidden, hidden] fp32 rows (table, pitch and out on
// 16-byte boundaries, hidden * hidden a multiple of four) that also forms
// each gathered matrix R's product with its edge's vector vecs[row] (fp32,
// rows vec_pitch apart): head != 0, tmp[row] = R v ([n, hidden] fp32);
// head == 0, tmp_partials[row, band] = the band's part of v^T R ([n, bands,
// hidden] fp64).  p = 1, 2 or 3 also writes pow_partials[row, band], the
// band's sum of |x|^p; p = 0 sums nothing.  Bands of band_rows matrix
// rows, stages of stage_rows (stage_rows * hidden a multiple of four and at
// most 2,048; band_rows a multiple of stage_rows): gather_rows_matvec.
// Requires 0 < n < 2^31, 0 < hidden <= 1,024 and at most 65,535 bands.
int dglke_gather_rows_matvec(const float* table, int64_t n_rows,
                             int64_t pitch, const int32_t* ids, int64_t n,
                             float* out, int64_t hidden, const float* vecs,
                             int64_t vec_pitch, int head, int p,
                             int64_t stage_rows, int64_t band_rows,
                             float* tmp, double* tmp_partials,
                             double* pow_partials, void* stream) {
  if (p < 0 || p > 3 || n <= 0 || hidden <= 0 || hidden > kMatvecMaxHidden ||
      (hidden * hidden) % 4 != 0 || pitch % 4 != 0 || stage_rows <= 0 ||
      (stage_rows * hidden) % 4 != 0 || stage_rows * hidden > kMatvecStage ||
      band_rows <= 0 || band_rows % stage_rows != 0 ||
      (hidden + band_rows - 1) / band_rows > 65535 ||
      reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((hidden + band_rows - 1) / band_rows));
  const int h = static_cast<int>(hidden), sr = static_cast<int>(stage_rows),
            br = static_cast<int>(band_rows);
  if (p == 0)
    launch_matvec<0>(head != 0, grid, s, table, ids, out, n_rows, pitch, h,
                     vecs, vec_pitch, sr, br, tmp, tmp_partials, pow_partials);
  else if (p == 1)
    launch_matvec<1>(head != 0, grid, s, table, ids, out, n_rows, pitch, h,
                     vecs, vec_pitch, sr, br, tmp, tmp_partials, pow_partials);
  else if (p == 2)
    launch_matvec<2>(head != 0, grid, s, table, ids, out, n_rows, pitch, h,
                     vecs, vec_pitch, sr, br, tmp, tmp_partials, pow_partials);
  else
    launch_matvec<3>(head != 0, grid, s, table, ids, out, n_rows, pitch, h,
                     vecs, vec_pitch, sr, br, tmp, tmp_partials, pow_partials);
  return static_cast<int>(cudaGetLastError());
}

// Segment update over the grouping of group_ids.cu: order [n] int64,
// heads [n + 1], seg_ids [n], seg_first [n] and count [1] int32.  grads:
// [n, dim] float32, contiguous.  state_sum: [n_rows] float32 for the
// Adagrad update, or null for the plain row add.  rows: null to start each
// segment from the table's row; or [n, dim] float32 at the ids' positions,
// the table's rows at the ids as the step's gather left them (a table and
// state_sum in mapped host memory): segment k then starts from
// rows[seg_first[k]] with its state read in place, so only the results
// and the state cross the link, with the same sums in the same order: the
// same bits.  block_route: 0 = one warp per segment, holding lane_vecs (1,
// 2, 4 or 8) vectors of four elements a lane, which must cover dim; 1 =
// one block per segment.  Requires 0 < n < 2^31 and dim < 2^31.
int dglke_segment_update(void* emb, int dtype, int64_t n_rows, int64_t pitch,
                         int64_t dim, float* state_sum, const int64_t* order,
                         const int32_t* heads, const int32_t* seg_ids,
                         const int32_t* seg_first, const int32_t* count,
                         const float* grads, int64_t n, float lr,
                         int block_route, int lane_vecs, const float* rows,
                         void* stream) {
  if (!block_route && (lane_vecs < 1 || lane_vecs > 8 ||
                       (lane_vecs & (lane_vecs - 1)) != 0 ||
                       dim > int64_t(4 * kWarp) * lane_vecs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const UpdateArgs a{emb,   state_sum, n_rows,  pitch,     static_cast<int>(dim),
                     order, heads,     seg_ids, seg_first, count,
                     grads, n,         lr,      rows};
  const bool vec = pitch % 4 == 0 && dim % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(grads) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(emb) % (dtype == 0 ? 16 : 8) == 0;
  if (dtype == 0) {
    if (rows == nullptr) launch_update<float, false>(a, vec, block_route, lane_vecs, s);
    else launch_update<float, true>(a, vec, block_route, lane_vecs, s);
  } else {
    if (rows == nullptr)
      launch_update<__nv_bfloat16, false>(a, vec, block_route, lane_vecs, s);
    else launch_update<__nv_bfloat16, true>(a, vec, block_route, lane_vecs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Pins `bytes` of pageable host memory at `ptr` in place and maps it into
// the address space of every device (cudaHostRegisterMapped | Portable);
// *dev_ptr receives the address at which kernels reach it, so that K1 and
// K2 read and write a table in host memory over the host link, row by row.
// The pages stay locked until dglke_host_unregister(ptr).
int dglke_host_register(void* ptr, int64_t bytes, void** dev_ptr) {
  cudaError_t err = cudaHostRegister(
      ptr, static_cast<size_t>(bytes),
      cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaHostGetDevicePointer(dev_ptr, ptr, 0);
  if (err != cudaSuccess) cudaHostUnregister(ptr);
  return static_cast<int>(err);
}

int dglke_host_unregister(void* ptr) {
  return static_cast<int>(cudaHostUnregister(ptr));
}

}  // extern "C"
