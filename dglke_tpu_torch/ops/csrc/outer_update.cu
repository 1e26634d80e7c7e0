// RESCAL's relation Adagrad with a rank-1 gradient per edge, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of dglke_tpu/ops/pallas/outer_update.py
// (_kernel, pallas_call at outer_update.py:118, wrapper
// outer_adagrad_update).  For each occurrence j of a row u = ids[j]:
//   g_j = a_j (x) b_j + reg'(R[u]),  reg'(x) = coef * p * |x|^(p-1) * sign(x)
// taken from the row's value before the update; then, with all adds done
// before any read of the accumulator,
//   ss[u] += sum_j mean(g_j^2);  R[u] -= lr * sum_j g_j / (sqrt(ss[u]) + 1e-10).
// The [B, Da*Db] gradient is never materialized.
//
// What bounds it on an H100: bytes.  At RESCAL's FB15k shapes (rows of
// 500 x 500 fp32 = 1 MB, 1,000 ids of which ~706 distinct) each distinct
// row must be read and written once, ~1.41 GB, ~0.42 ms at 3.35 TB/s; the
// arithmetic is ~3 flops per element and occurrence, ~2 GFLOP, far below
// the fp32 peak.  wgmma and TMA have no place here: this is a rank-1
// update per edge, not a product.
//
// Design:
//   * The TPU kernel revisits a VMEM-resident row once per sorted id; a GPU
//     has no such residency and fp32 atomics would make the result depend
//     on the order blocks run in.  The caller sorts the ids (stable) and
//     passes the sorted ids and their order; a block at a sorted position
//     works only if it heads a segment of equal ids, and takes every
//     occurrence of the segment in a fixed order.
//   * The Adagrad step needs the row's whole sum of squares before any
//     element is written, so the row is split over blocks in three
//     launches:
//       pass 0  grid (tile of 2,048 elements of the row) x (sorted
//               position): one partial sum of g^2 per (segment, tile);
//       reduce  one thread per segment sums its partials in tile order,
//               updates ss[u] and writes std = sqrt(ss[u]) + 1e-10;
//       pass 1  the same grid as pass 0: each element gets
//               R -= lr * sum_j g_j / std, reg' from the value read before
//               the write; every touched element is written once.
//     Tiles run along x so that neighbouring blocks stream one row and
//     share the segment's factors in L1/L2.  Each thread loads its 8 row
//     elements before the arithmetic, so 8 loads are in flight per thread.
//   * No atomics anywhere: two runs give bit-identical tables and state.
//     The two passes read each distinct row twice (~0.63 ms at the bound's
//     rate instead of 0.42 ms).
//
// Interface: plain C functions taking pointers, sizes and the CUDA stream;
// each returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;   // row elements per block
constexpr int kReduceThreads = 128;
constexpr int64_t kMaxGridY = 65535;

// d/dx coef * |x|^p; reg_pow <= 0 means no regularization.  reg_scale is
// coef * p, computed by the caller.
__device__ __forceinline__ float reg_grad(float x, float reg_scale,
                                          int reg_pow) {
  if (reg_pow <= 0) return 0.f;
  const float ax = fabsf(x);
  float m = 1.f;
  for (int e = 1; e < reg_pow; ++e) m *= ax;
  const float sign = float(x > 0.f) - float(x < 0.f);
  return reg_scale * m * sign;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The segment [pos, *end) of equal sorted ids headed by pos, or false when
// pos does not head one.
__device__ __forceinline__ bool segment(const int32_t* __restrict__ sids,
                                        int64_t pos, int64_t n,
                                        int64_t n_rows, int64_t* end) {
  const int32_t u = sids[pos];
  if (pos > 0 && sids[pos - 1] == u) return false;
  if (u < 0 || u >= n_rows) __trap();
  int64_t e = pos + 1;
  while (e < n && sids[e] == u) ++e;
  *end = e;
  return true;
}

// One template for both passes: kApply false sums g^2 into partial[pos,
// tile]; kApply true writes the update with std[pos].
template <bool kApply>
__global__ void __launch_bounds__(kThreads)
outer_pass(float* __restrict__ emb, int64_t n_rows, int64_t pitch,
           const int32_t* __restrict__ sids, const int64_t* __restrict__ order,
           const float* __restrict__ a, const float* __restrict__ b,
           int64_t n, int64_t pos0, int da, int db, float reg_scale,
           int reg_pow, float lr, float* __restrict__ partial,
           const float* __restrict__ std_dev) {
  const int64_t pos = pos0 + blockIdx.y;
  int64_t end;
  if (!segment(sids, pos, n, n_rows, &end)) return;
  const int d2 = da * db;
  const int tile0 = blockIdx.x * kTile;
  float* row = emb + int64_t(sids[pos]) * pitch;

  float x[kPerThread];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const int e = tile0 + v * kThreads + threadIdx.x;
    x[v] = e < d2 ? row[e] : 0.f;
  }

  float part = 0.f;
  const float row_std = kApply ? std_dev[pos] : 1.f;
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const int e = tile0 + v * kThreads + threadIdx.x;
    if (e >= d2) continue;
    const int i = e / db;
    const int k = e - i * db;
    const float reg = reg_grad(x[v], reg_scale, reg_pow);
    float acc = 0.f;
    for (int64_t j = pos; j < end; ++j) {
      const int64_t o = order[j];
      const float g = a[o * da + i] * b[o * db + k] + reg;
      if (kApply) {
        acc += g;
      } else {
        part += g * g;
      }
    }
    if (kApply) row[e] = x[v] + (-lr * acc) / row_std;
  }
  if (kApply) return;

  // Fixed-order block reduction: the same sum on every run.
  __shared__ float warp_part[kThreads / kWarp];
  part = warp_sum(part);
  if (threadIdx.x % kWarp == 0) warp_part[threadIdx.x / kWarp] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / kWarp; ++w) total += warp_part[w];
    partial[pos * int64_t(gridDim.x) + blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
outer_reduce(float* __restrict__ state_sum, int64_t n_rows,
             const int32_t* __restrict__ sids, int64_t n,
             const float* __restrict__ partial, int tiles, float d2,
             float* __restrict__ std_dev) {
  const int64_t pos = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pos >= n) return;
  int64_t end;
  if (!segment(sids, pos, n, n_rows, &end)) return;
  const int32_t u = sids[pos];
  float total = 0.f;
  for (int t = 0; t < tiles; ++t) total += partial[pos * tiles + t];
  const float ss = state_sum[u] + total / d2;
  state_sum[u] = ss;
  std_dev[pos] = sqrtf(ss) + 1e-10f;
}

}  // namespace

extern "C" {

// emb: [n_rows, >= da*db] float32 with row stride pitch (elements);
// state_sum: [n_rows] float32; sids: [n] ids sorted ascending (stable);
// order: [n] positions of the sorted ids in a and b; a: [n, da], b: [n, db]
// float32, contiguous.  Scratch from the caller: partial [n * tiles] and
// std_dev [n] float32, tiles = ceil(da*db / 2048).  reg_pow <= 0: no
// regularization.  Requires n > 0 and da*db < 2^31.
int dglke_outer_adagrad(float* emb, int64_t n_rows, int64_t pitch,
                        float* state_sum, const int32_t* sids,
                        const int64_t* order, const float* a, const float* b,
                        int64_t n, int da, int db, float lr, float reg_scale,
                        int reg_pow, float* partial, float* std_dev,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d2 = da * db;
  const int tiles = (d2 + kTile - 1) / kTile;
  for (int64_t p0 = 0; p0 < n; p0 += kMaxGridY) {
    const dim3 grid(tiles, unsigned(n - p0 < kMaxGridY ? n - p0 : kMaxGridY));
    outer_pass<false><<<grid, kThreads, 0, s>>>(
        emb, n_rows, pitch, sids, order, a, b, n, p0, da, db, reg_scale,
        reg_pow, lr, partial, nullptr);
  }
  outer_reduce<<<unsigned((n + kReduceThreads - 1) / kReduceThreads),
                 kReduceThreads, 0, s>>>(state_sum, n_rows, sids, n, partial,
                                         tiles, float(d2), std_dev);
  for (int64_t p0 = 0; p0 < n; p0 += kMaxGridY) {
    const dim3 grid(tiles, unsigned(n - p0 < kMaxGridY ? n - p0 : kMaxGridY));
    outer_pass<true><<<grid, kThreads, 0, s>>>(
        emb, n_rows, pitch, sids, order, a, b, n, p0, da, db, reg_scale,
        reg_pow, lr, partial, std_dev);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
