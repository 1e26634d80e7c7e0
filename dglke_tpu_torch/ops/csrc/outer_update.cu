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
// 500 x 500 fp32 = 1 MB, 1,000 ids of which ~721 distinct) each distinct
// row must be read once and written once, with the factors and ids read
// once: 1.446 GB, 0.4316 ms at 3.35 TB/s.  The arithmetic is ~2.7 GFLOP,
// far below the fp32 peak.  wgmma has no place here: this is a rank-1
// update per edge, not a product.
//
// Design.  The caller sorts the ids (stable) and passes the sorted ids and
// their order, so the occurrences of a row form a segment of equal sorted
// ids, summed in a fixed order: no atomics, two runs give the same bits.
// Adagrad needs a row's whole sum of squares before any element of it is
// written.  The TPU kernel gets that from VMEM residency; one SM cannot
// hold a 1 MB row, but a thread-block cluster can.  Two routes, chosen by
// the wrapper from the width (ops/outer_update.py:plan_outer):
//
//   cluster (outer_heads, outer_cluster): a one-block pre-pass lists the
//     segments' heads in order; then a persistent grid of as many clusters
//     of `cluster` CTAs as fit on the card at once, each claiming its next
//     segment from a counter (one atomic per segment), so clusters that
//     run faster take more.  Each CTA owns a slice of `slice`
//     elements (a multiple of 4, so 16-byte aligned) of the row and, for
//     each of its segments,
//       1. loads the slice into shared memory once, with TMA bulk copies on
//          an mbarrier, while its threads stage the factors the slice needs
//          (a[o, i] for the rows i it covers, b[o, :]) beside it, when the
//          segment has at most `stage_occ` occurrences (longer segments
//          read the factors through L1);
//       2. sums g^2 over its slice, stepping (i, k) without a divide
//          (16-byte b vectors when db % 4 == 0, a loop-free body for a
//          single occurrence), and reduces the block in a fixed order;
//       3. writes its partial into slot `rank` of every CTA's shared array
//          through distributed shared memory; across the cluster barrier
//          (arrive, read the next segment's id and state, wait) each CTA
//          sums the slots in rank order, so all get the same std; rank 0
//          writes ss[u];
//       4. recomputes sum_j g_j from the slice in shared memory and writes
//          the new slice once, as 16-byte stores.
//     Each touched row is read once and written once.  At hidden 500 the
//     cluster is 16 CTAs of 62.5 KB (size 16 is non-portable and is
//     allowed explicitly), two CTAs to an SM; 14 such clusters fit an
//     H100.  What holds it below the bound (PERF.md, section 6): each CTA
//     alternates between its slice's traffic and its arithmetic, and only
//     the other CTA on the SM fills the gaps.  Starting the next slice's
//     load earlier (during pass 2, or with the factors copied ahead) moved
//     the wait elsewhere and measured slower.
//   tiles (outer_pass, outer_reduce): rows wider than 16 slices of ~200 KB
//     (hidden >= ~905) keep three launches over (2,048-element tile) x
//     (sorted position): pass 0 writes one partial sum of g^2 per (segment,
//     tile), a reduce sums them in tile order and writes std, pass 1 writes
//     each touched element once.  It reads each touched row twice.
//
// Interface: plain C functions taking pointers, sizes and the CUDA stream;
// each returns the launch's error, then cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;   // row elements per block
constexpr int kReduceThreads = 128;
constexpr int64_t kMaxGridY = 65535;

constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 16;
constexpr uint32_t kBulkBytes = 16384;         // bytes per bulk copy
constexpr int kHeadThreads = 1024;

// d/dx coef * |x|^p; reg_pow <= 0 means no regularization.  reg_scale is
// coef * p, computed by the caller.
__device__ __forceinline__ float reg_grad(float x, float reg_scale,
                                          int reg_pow) {
  if (reg_pow <= 0) return 0.f;
  // The same bits as the loop below: |x|^(p-1) sign(x) is x |x| for p = 3
  // and x for p = 2 (multiplying by a sign of +-1 is exact).
  if (reg_pow == 3) return reg_scale * (x * fabsf(x));
  if (reg_pow == 2) return reg_scale * x;
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

// Sum over the block in a fixed order: the same bits on every run.  Every
// thread gets the total.  `scratch` holds one float per warp plus one.
__device__ __forceinline__ float block_sum(float x, float* scratch) {
  x = warp_sum(x);
  if (threadIdx.x % kWarp == 0) scratch[threadIdx.x / kWarp] = x;
  __syncthreads();
  const int warps = blockDim.x / kWarp;
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += scratch[w];
    scratch[warps] = total;
  }
  __syncthreads();
  return scratch[warps];
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

// ---------------------------------------------------------------------------
// Route "cluster"

// The heads of the segments of equal sorted ids, in order: heads[k] is
// the position of the k-th segment's first id, and heads[k] = n from the
// number of segments up to k = n (so heads[k + 1] ends segment k);
// heads[n + 1] = 0 starts the count of claimed segments.  One block: each
// tile of positions is counted with a warp ballot and a scan over the
// warps, on top of the count of the tiles before.
__global__ void __launch_bounds__(kHeadThreads)
outer_heads(const int32_t* __restrict__ sids, int64_t n,
            int64_t* __restrict__ heads) {
  __shared__ int warp_heads[kHeadThreads / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int64_t base = 0;                           // heads in the tiles before
  for (int64_t t0 = 0; t0 < n; t0 += kHeadThreads) {
    const int64_t p = t0 + threadIdx.x;
    const bool head = p < n && (p == 0 || sids[p - 1] != sids[p]);
    const unsigned mask = __ballot_sync(0xffffffffu, head);
    if (lane == 0) warp_heads[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kHeadThreads / kWarp; ++w) {
      before += w < warp ? warp_heads[w] : 0;
      total += warp_heads[w];
    }
    if (head) heads[base + before + __popc(mask & ((1u << lane) - 1u))] = p;
    base += total;
    __syncthreads();                          // warp_heads is rewritten next
  }
  for (int64_t k = base + threadIdx.x; k <= n; k += kHeadThreads) heads[k] = n;
  if (threadIdx.x == 0) heads[n + 1] = 0;
}

// The two halves of cluster.sync(), so that work can go between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A segment of equal sorted ids: its first position, id, occurrences and
// Adagrad state before the update; pos == n when there is none.
struct Segment {
  int64_t pos;
  int32_t u;
  int cnt;
  float ss_old;
};

// Segment k (k <= n) from the heads of outer_heads.
__device__ __forceinline__ Segment load_segment(
    const int64_t* __restrict__ heads, const int32_t* __restrict__ sids,
    const float* __restrict__ state_sum, int64_t k, int64_t n,
    int64_t n_rows) {
  Segment g{k < n ? heads[k] : n, 0, 0, 0.f};
  if (g.pos < n) {
    g.u = sids[g.pos];
    if (g.u < 0 || g.u >= n_rows) __trap();
    g.cnt = static_cast<int>(heads[k + 1] - g.pos);
    g.ss_old = state_sum[g.u];
  }
  return g;
}

// Phase stamps of the cluster route, compiled in only with
// DGLKE_OUTER_STAMPS (csrc/outer_update_stamps.cu): thread 0 of each CTA
// records %globaltimer at six points of each of its first kStampSegs
// segments; dglke_outer_stamps() copies them out.
#ifdef DGLKE_OUTER_STAMPS
constexpr int kStampCtas = 1024, kStampSegs = 128, kStamps = 6;
__device__ unsigned long long g_stamps[kStampCtas * kStampSegs * kStamps];
__device__ unsigned g_segments[kStampCtas];
__device__ __forceinline__ void stamp(uint32_t it, int k) {
  if (threadIdx.x != 0 || it >= kStampSegs || blockIdx.x >= kStampCtas) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[(blockIdx.x * kStampSegs + it) * kStamps + k] = t;
}
#define STAMP(it, k) stamp(it, k)
#else
#define STAMP(it, k)
#endif

// What one CTA of the cluster route works on.
struct Slice {
  const float* xs;       // the slice in shared memory
  const float* as;       // staged a[o, i0 + r] at [j * span_cap + r]
  const float* bs;       // staged b[o, k] at [j * db + k]
  float* row;            // the slice in the table
  const int64_t* order;  // order of the segment's first occurrence
  const float* a;
  const float* b;
  int len, e0, i0, da, db, span_cap, cnt;
  float reg_scale;
  int reg_pow;
  bool vec;              // 16-byte aligned slices: vector stores
};

// One sweep over the thread's quads of the slice, for any db.  kApply
// false: returns the thread's sum of g_j^2 over elements and occurrences;
// true: writes x + scale * sum_j g_j for every element, scale = -lr / std.
// kStaged: the factors come from shared memory, else from global memory
// through L1.
template <bool kApply, bool kStaged>
__device__ __forceinline__ float sweep_any(const Slice& s, float scale) {
  float part = 0.f;
  const int quads = (s.len + 3) / 4;
  const int step = 4 * blockDim.x;           // elements between a thread's quads
  const int di = step / s.db, dk = step - di * s.db;
  int e = s.e0 + 4 * int(threadIdx.x);
  int i = e / s.db, k = e - i * s.db;        // (i, k) of the quad's first element
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 x4 = reinterpret_cast<const float4*>(s.xs)[q];
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    float y[4];
    int ii = i, kk = k;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float acc = 0.f;
      if (4 * q + v < s.len) {
        const float reg = reg_grad(x[v], s.reg_scale, s.reg_pow);
        for (int j = 0; j < s.cnt; ++j) {
          float fa, fb;
          if (kStaged) {
            fa = s.as[j * s.span_cap + (ii - s.i0)];
            fb = s.bs[j * s.db + kk];
          } else {
            const int64_t o = __ldg(s.order + j);
            fa = __ldg(s.a + o * s.da + ii);
            fb = __ldg(s.b + o * s.db + kk);
          }
          const float g = fa * fb + reg;
          if (kApply) {
            acc += g;
          } else {
            part += g * g;
          }
        }
      }
      y[v] = x[v] + acc * scale;
      if (++kk == s.db) {
        kk = 0;
        ++ii;
      }
    }
    if (kApply) {
      if (s.vec) {
        reinterpret_cast<float4*>(s.row)[q] = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (4 * q + v < s.len) s.row[4 * q + v] = y[v];
      }
    }
    i += di;
    k += dk;
    if (k >= s.db) {
      k -= s.db;
      ++i;
    }
  }
  return part;
}

// The same sweep when db % 4 == 0 and the slices are aligned: a quad never
// leaves its row of a, so each occurrence costs one a value and one
// 16-byte b vector per quad.  The same arithmetic, element by element.
// kOnce: the segment has one occurrence (most of them), a loop-free body.
template <bool kApply, bool kStaged, bool kOnce>
__device__ __forceinline__ float sweep_row4(const Slice& s, float scale) {
  float part = 0.f;
  const int quads = s.len / 4;
  const int step = 4 * blockDim.x;
  const int di = step / s.db, dk = step - di * s.db;
  int e = s.e0 + 4 * int(threadIdx.x);
  int i = e / s.db, k = e - i * s.db;
  for (int q = threadIdx.x; q < quads; q += blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(s.xs)[q];
    const float r0 = reg_grad(x.x, s.reg_scale, s.reg_pow);
    const float r1 = reg_grad(x.y, s.reg_scale, s.reg_pow);
    const float r2 = reg_grad(x.z, s.reg_scale, s.reg_pow);
    const float r3 = reg_grad(x.w, s.reg_scale, s.reg_pow);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const int cnt = kOnce ? 1 : s.cnt;
    for (int j = 0; j < cnt; ++j) {
      float fa;
      float4 fb;
      if (kStaged) {
        fa = s.as[j * s.span_cap + (i - s.i0)];
        fb = *reinterpret_cast<const float4*>(s.bs + j * s.db + k);
      } else {
        const int64_t o = __ldg(s.order + j);
        fa = __ldg(s.a + o * s.da + i);
        fb = __ldg(reinterpret_cast<const float4*>(s.b + o * s.db + k));
      }
      const float g0 = fa * fb.x + r0, g1 = fa * fb.y + r1;
      const float g2 = fa * fb.z + r2, g3 = fa * fb.w + r3;
      if (kApply) {
        acc.x += g0;
        acc.y += g1;
        acc.z += g2;
        acc.w += g3;
      } else {
        part += g0 * g0;
        part += g1 * g1;
        part += g2 * g2;
        part += g3 * g3;
      }
    }
    if (kApply) {
      reinterpret_cast<float4*>(s.row)[q] =
          make_float4(x.x + acc.x * scale, x.y + acc.y * scale,
                      x.z + acc.z * scale, x.w + acc.w * scale);
    }
    i += di;
    k += dk;
    if (k >= s.db) {
      k -= s.db;
      ++i;
    }
  }
  return part;
}

template <bool kApply>
__device__ __forceinline__ float sweep(const Slice& s, bool row4, bool staged,
                                       float scale) {
  if (row4) {
    if (s.cnt == 1) {
      return staged ? sweep_row4<kApply, true, true>(s, scale)
                    : sweep_row4<kApply, false, true>(s, scale);
    }
    return staged ? sweep_row4<kApply, true, false>(s, scale)
                  : sweep_row4<kApply, false, false>(s, scale);
  }
  return staged ? sweep_any<kApply, true>(s, scale)
                : sweep_any<kApply, false>(s, scale);
}

// A persistent grid of C clusters over the segments of outer_heads:
// cluster c starts with segments c and c + C, then claims one more at each
// segment (heads[n + 1] counts the claims past 2C), so a cluster that runs
// ahead takes more.  The claim is made at the top of a segment, and rank 0
// passes it on at the segment after, so its latency is hidden.  Dynamic
// shared memory: the slice (`slice` floats), then the staged b (stage_occ
// x db) and a (stage_occ x span_cap).  vec: the table's rows and slices
// are 16-byte aligned (bulk copies and 16-byte stores); row4: also db % 4
// == 0 and b 16-byte aligned.
__global__ void __launch_bounds__(kClusterThreads, 2)
outer_cluster(float* __restrict__ emb, int64_t n_rows, int64_t pitch,
              float* __restrict__ state_sum, const int32_t* __restrict__ sids,
              const int64_t* __restrict__ order, int64_t* __restrict__ heads,
              const float* __restrict__ a,
              const float* __restrict__ b, int64_t n, int da, int db,
              float reg_scale, int reg_pow, float lr, int slice, int span_cap,
              int stage_occ, int vec, int row4) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2][kMaxCluster];      // by segment parity
  __shared__ int64_t claims[2];              // rank 0's, by segment parity
  __shared__ float scratch[kClusterThreads / kWarp + 1];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t clusters = gridDim.x / cs;
  const int d2 = da * db;
  Slice s;
  s.e0 = rank * slice;
  s.len = max(0, min(d2 - s.e0, slice));
  s.i0 = s.e0 / db;
  s.da = da;
  s.db = db;
  s.span_cap = span_cap;
  s.reg_scale = reg_scale;
  s.reg_pow = reg_pow;
  s.vec = vec != 0;
  s.a = a;
  s.b = b;
  float* xs = smem;
  float* bs = xs + slice;
  float* as = bs + stage_occ * db;
  s.xs = xs;
  s.as = as;
  s.bs = bs;
  const int span = s.len > 0 ? (s.e0 + s.len - 1) / db - s.i0 + 1 : 0;
  const bool bulk = s.vec && s.len > 0;
  const uint32_t bytes = uint32_t(s.len) * 4u;
  const uint32_t bar_u = smem_u32(&bar);
  if (bulk && threadIdx.x == 0) mbar_init(bar_u, 1);
  // Every CTA of the cluster has started (and this CTA's mbarrier is
  // initialized) before any CTA writes to another's shared memory.
  cluster.sync();

  auto* claimed = reinterpret_cast<unsigned long long*>(heads + n + 1);
  int64_t k_next = int64_t(blockIdx.x) / cs + clusters;
  Segment seg = load_segment(heads, sids, state_sum, k_next - clusters, n,
                             n_rows);
  uint32_t it = 0;
  for (; seg.pos < n; ++it) {
    STAMP(it, 0);
    const int64_t pos = seg.pos;
    // Rank 0 claims the segment after next now and hands it on in step 3.
    int64_t k_claim = 0;
    if (rank == 0 && threadIdx.x == 0)
      k_claim = 2 * clusters + int64_t(atomicAdd(claimed, 1ull));
    s.cnt = seg.cnt;
    s.order = order + pos;
    s.row = emb + int64_t(seg.u) * pitch + s.e0;

    // 1. The slice into shared memory; the factors beside it.
    if (bulk) {
      if (threadIdx.x == 0) {
        // Every thread's reads of the buffer came first (the barrier that
        // ended the segment before).
        fence_proxy_async();
        mbar_expect_tx(bar_u, bytes);
        for (uint32_t off = 0; off < bytes; off += kBulkBytes)
          bulk_load(smem_u32(xs) + off,
                    reinterpret_cast<const char*>(s.row) + off,
                    min(kBulkBytes, bytes - off), bar_u);
      }
    } else {
      for (int e = threadIdx.x; e < s.len; e += blockDim.x) xs[e] = s.row[e];
    }
    const bool staged = s.cnt <= stage_occ;
    if (staged) {
      for (int j = 0; j < s.cnt; ++j) {
        const int64_t o = order[pos + j];
        for (int r = threadIdx.x; r < span; r += blockDim.x)
          as[j * span_cap + r] = a[o * da + s.i0 + r];
        for (int k = threadIdx.x; k < db; k += blockDim.x)
          bs[j * db + k] = b[o * db + k];
      }
    }
    __syncthreads();
    STAMP(it, 1);
    if (bulk) mbar_wait(bar_u, it & 1);
    STAMP(it, 2);

    // 2. This CTA's sum of g^2.
    const float total = block_sum(sweep<false>(s, row4, staged, 0.f), scratch);
    STAMP(it, 3);

    // 3. Exchange partials: slot `rank` of every CTA's red[it & 1], and
    // rank 0's claim in its claims[it & 1].  The cluster barrier of the
    // segment before ordered every read of those slots.  While the barrier
    // completes, read this cluster's next segment (its state_sum is no
    // other segment's, so reading it early is safe).
    if (threadIdx.x < cs)
      *cluster.map_shared_rank(&red[it & 1][rank], threadIdx.x) = total;
    if (rank == 0 && threadIdx.x == 0) claims[it & 1] = k_claim;
    cluster_arrive();
    const Segment next = load_segment(heads, sids, state_sum, k_next, n,
                                      n_rows);
    cluster_wait();
    k_next = *cluster.map_shared_rank(&claims[it & 1], 0);
    STAMP(it, 4);
    float sum = 0.f;
    for (int r = 0; r < cs; ++r) sum += red[it & 1][r];
    const float ss = seg.ss_old + sum / float(d2);
    if (rank == 0 && threadIdx.x == 0) state_sum[seg.u] = ss;
    const float scale = -lr / (sqrtf(ss) + 1e-10f);

    // 4. The new slice, written once.
    sweep<true>(s, row4, staged, scale);
    __syncthreads();               // the buffers are free for the next one
    STAMP(it, 5);
    seg = next;
  }
#ifdef DGLKE_OUTER_STAMPS
  if (threadIdx.x == 0 && blockIdx.x < kStampCtas) g_segments[blockIdx.x] = it;
#endif
}

size_t cluster_smem_bytes(int slice, int span_cap, int stage_occ, int db) {
  return size_t(slice + int64_t(stage_occ) * (span_cap + db)) * sizeof(float);
}

// Raise the kernel's dynamic shared memory limit and allow cluster sizes
// above 8 (non-portable), once for each larger value.
cudaError_t configure_cluster(int cluster, size_t smem) {
  static size_t smem_set = 0;
  static bool nonportable_set = false;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        outer_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (cluster > 8 && !nonportable_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        outer_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonportable_set = true;
  }
  return cudaSuccess;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int64_t clusters, int cluster, size_t smem,
                    cudaStream_t s) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = unsigned(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(unsigned(clusters * cluster));
  cfg->blockDim = dim3(kClusterThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// cudaOccupancyMaxActiveClusters for this launch shape: the size of the
// persistent grid.  Cached for the last shape asked.
cudaError_t max_active_clusters(int cluster, size_t smem, int* out) {
  static int last_cluster = 0, last = 0;
  static size_t last_smem = 0;
  if (cluster != last_cluster || smem != last_smem) {
    cudaError_t err = configure_cluster(cluster, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(&cfg, &attr, 1024, cluster, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&last, outer_cluster, &cfg);
    if (err != cudaSuccess) return err;
    last_cluster = cluster;
    last_smem = smem;
  }
  *out = last;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Route "tiles"

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

  __shared__ float scratch[kThreads / kWarp + 1];
  const float total = block_sum(part, scratch);
  if (threadIdx.x == 0) partial[pos * int64_t(gridDim.x) + blockIdx.x] = total;
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

// Common arguments of both routes.  emb: [n_rows, >= da*db] float32 with
// row stride pitch (elements); state_sum: [n_rows] float32; sids: [n] ids
// sorted ascending (stable); order: [n] positions of the sorted ids in a
// and b; a: [n, da], b: [n, db] float32, contiguous.  reg_pow <= 0: no
// regularization.  Requires n > 0 and da*db < 2^31.

// Route "cluster": cluster in 1..16 CTAs of `slice` elements each (a
// multiple of 4, cluster * slice >= da*db); span_cap >= the rows of a one
// slice can cover; stage_occ: the longest segment whose factors are staged
// in shared memory (0: none).  Scratch from the caller: heads [n + 2]
// int64.  The grid holds as many clusters as fit on the card at once (at
// most n); each takes segments as it goes.
int dglke_outer_adagrad_cluster(float* emb, int64_t n_rows, int64_t pitch,
                                float* state_sum, const int32_t* sids,
                                const int64_t* order, const float* a,
                                const float* b, int64_t n, int da, int db,
                                float lr, float reg_scale, int reg_pow,
                                int cluster, int slice, int span_cap,
                                int stage_occ, int64_t* heads, void* stream) {
  const size_t smem = cluster_smem_bytes(slice, span_cap, stage_occ, db);
  int fit = 0;
  cudaError_t err = max_active_clusters(cluster, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vec = pitch % 4 == 0 && (int64_t(da) * db) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  const int row4 = vec && db % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  outer_heads<<<1, kHeadThreads, 0, s>>>(sids, n, heads);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, n < fit ? n : fit, cluster, smem, s);
  err = cudaLaunchKernelEx(&cfg, outer_cluster, emb, n_rows, pitch, state_sum,
                           sids, order, heads, a, b, n, da, db, reg_scale,
                           reg_pow, lr, slice, span_cap, stage_occ, vec, row4);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The cluster route's grid: cudaOccupancyMaxActiveClusters for `cluster`
// CTAs with `smem` bytes of dynamic shared memory each, into *clusters.
int dglke_outer_cluster_occupancy(int cluster, int64_t smem,
                                  int* clusters) {
  return static_cast<int>(max_active_clusters(cluster, size_t(smem),
                                              clusters));
}

// Route "tiles".  Scratch from the caller: partial [n * tiles] and std_dev
// [n] float32, tiles = ceil(da*db / 2048).
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

#ifdef DGLKE_OUTER_STAMPS
// The phase stamps of the last cluster-route launch: stamps [1024 CTAs x
// 128 segments x 6] and segments [1024] (segments each CTA took).
int dglke_outer_stamps(unsigned long long* stamps, unsigned* segments) {
  cudaError_t err = cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(g_stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaMemcpyFromSymbol(segments, g_segments, sizeof(g_segments)));
}
#endif

}  // extern "C"
