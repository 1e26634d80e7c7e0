// Id grouping for Hopper (sm_90a): a batch of row ids sorted (stable) into
// segments of equal ids, ahead of the segment updates of K2
// (ops/csrc/rows.cu) and K3 (ops/csrc/outer_update.cu).
//
// Replaces, on K2's path, what the TPU kernel of
// dglke_tpu/ops/pallas/rows.py:scatter_add_rows (pallas_call at :227) is
// handed before it runs: the conflict flags of window_conflicts (:99), which
// serialise duplicate ids inside its DMA window.  On a GPU the duplicates of
// an id are summed in a fixed order instead, and that needs the ids grouped.
// The output is exactly torch.sort(ids.int32, stable=True) -- the sorted
// ids and the order permutation -- and the segments: the position of each
// segment's first id, its id and its first occurrence's position, and the
// number of segments.
//
// What bounds it on an H100: neither bytes nor operations of the card.  At
// the main paths' shapes (1,000 and 3,000 ids) it moves ~70 KB, nanoseconds
// at the card's rates.  It runs on few SMs, and there it is bound by the
// instructions each SM issues (four warp-instructions a cycle): every
// instruction of a block's code is paid once for each of its warps, and by
// the latency of each launch.  So the design keeps the instruction count per
// id small, the fixed work per thread smaller and the launches few.
//
// Two routes, chosen by the wrapper (ops/rows.py:plan_group):
//
// Up to 8,192 ids, one launch (group_ids): one block of 256 threads holds
// all the ids, 1 to 32 a thread in registers, and sorts them with CUB's
// block radix sort over the bits that n_rows - 1 needs (14 at 14,951 rows;
// more ids cost no more bits), kRadixBits a pass, with their positions as
// values.  CUB's block primitives rank by digit counters packed in shared
// memory and are stable in blocked order (thread t holds positions t *
// kItems ...), so the sort is.  The number of ids a thread holds is the
// kernel's template argument, the least of 1, 2, 4, 8, 12, 16, 24 and 32
// that covers n; padding ids sort last.  Global memory is touched only in
// whole-warp runs: the ids are loaded coalesced and transposed to blocked
// order in shared memory (BlockLoad), and the sort leaves its result
// striped (thread t holds ranks t, t + 256, ...), so sids and order are
// stored coalesced as they are.  A segment head is flagged against its
// neighbour rank (a lane shuffle, or a warp's edge in shared memory), and
// each head's place in the list is the heads of earlier (rank row, warp)
// cells plus the lower lanes of its own.
//
// Above that, the tiles route (4 + passes launches, sizes from n alone):
//   1. sort_tile: one block a tile of 8,192 ids sorts it as above (32 ids a
//      thread; positions in a tile fit the 16-bit values, the last tile is
//      padded) into a sorted run of (id, position) pairs in scratch;
//   2. merge_runs, ceil(log2(tiles)) passes: adjacent runs merged pairwise
//      into the other scratch buffer (the last pass into sids and order).
//      Each block owns 2,048 ranks of the output: two threads find where
//      the block's first and last rank lie on the merge path (a binary
//      search over the two runs), the block stages its share of both runs
//      in shared memory, and each thread merges 8 ranks from its own point
//      on the path.  Ties go to the left run, which holds the earlier
//      positions, so the merge is stable and the result is torch.sort's;
//   3. count_heads, scan_heads, place_heads: each block of 2,048 ranks
//      counts its segment heads, one block scans those counts in a fixed
//      order (and writes count and heads[count] = n), and each head is
//      written at its block's offset plus the heads before it in the block
//      (a block scan).
//
// No atomics on either route: the same bits on every run.  Nothing is
// proportional to n_rows, and ids outside [0, n_rows) trap.  The phase
// stamps of group_ids_stamps.cu cover the one-block kernel only.
//
// Interface: one plain C function a route, taking pointers, sizes, the
// scratch (tiles route) and the CUDA stream; each returns the first error
// of its launches (cudaGetLastError()).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxItems = 32;                  // at most a warp's lanes
constexpr int kMaxIds = kThreads * kMaxItems;  // positions fit 16 bits
constexpr int kRadixBits = 5;   // measured: 256 x 5 beat 4 and 6 at 14 bits
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Inclusive scan over the warp's lanes.
__device__ __forceinline__ uint32_t warp_scan(uint32_t x, int lane) {
  for (int off = 1; off < kWarp; off *= 2) {
    const uint32_t y = __shfl_up_sync(kAll, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// DGLKE_GROUP_STAMPS (csrc/group_ids_stamps.cu): thread 0 records
// %globaltimer after each phase of the last launch (after a barrier of the
// block); dglke_group_stamps() copies them out.
#ifdef DGLKE_GROUP_STAMPS
constexpr int kStamps = 5;
__device__ unsigned long long g_stamps[kStamps];
__device__ __forceinline__ void stamp(int k) {
  __syncthreads();
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (threadIdx.x == 0) g_stamps[k] = t;
}
#define STAMP(k) stamp(k)
#else
#define STAMP(k)
#endif

template <typename I, int kItems>
__global__ void __launch_bounds__(kThreads)
group_ids(const I* __restrict__ ids, int n, int64_t n_rows, int bits,
          int32_t* __restrict__ sids, int64_t* __restrict__ order,
          int32_t* __restrict__ heads, int32_t* __restrict__ seg_ids,
          int32_t* __restrict__ seg_first, int32_t* __restrict__ count) {
  // int64 ids transpose one warp at a time: a whole block of them would
  // not fit the 48 KB of static shared memory at 24 and 32 a thread.
  using Load = cub::BlockLoad<I, kThreads, kItems,
                              sizeof(I) == 4
                                  ? cub::BLOCK_LOAD_WARP_TRANSPOSE
                                  : cub::BLOCK_LOAD_WARP_TRANSPOSE_TIMESLICED>;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kItems, uint16_t,
                                   kRadixBits>;
  __shared__ union {
    typename Load::TempStorage load;
    typename Sort::TempStorage sort;
  } tmp;
  __shared__ uint32_t edge[kItems][kWarps];       // lane 31's key, per row
  __shared__ uint32_t row_heads[kItems][kWarps];  // heads per (row, warp)

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const unsigned below = lanemask_lt();

  STAMP(0);
  I raw[kItems];
  Load(tmp.load).Load(ids, raw, n, I(0));
  uint32_t key[kItems];
  uint16_t val[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = tid * kItems + k;
    val[k] = static_cast<uint16_t>(i);
    key[k] = 0xffffffffu;  // padding: sorts after every id
    if (i < n) {
      if (raw[k] < 0 || raw[k] >= n_rows) __trap();
      key[k] = static_cast<uint32_t>(raw[k]);
    }
  }
  __syncthreads();
  STAMP(1);
  Sort(tmp.sort).SortBlockedToStriped(key, val, 0, bits);
  STAMP(2);

  // Rank k * kThreads + tid is now key[k]: store it, and flag the heads.
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < n) {
      sids[i] = static_cast<int32_t>(key[k]);
      order[i] = val[k];
    }
    if (lane == kWarp - 1) edge[k][warp] = key[k];
  }
  __syncthreads();
  unsigned flags = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    uint32_t prev = __shfl_up_sync(kAll, key[k], 1);
    if (lane == 0)
      prev = warp > 0 ? edge[k][warp - 1]
                      : k > 0 ? edge[k - 1][kWarps - 1] : ~key[k];
    const bool h = k * kThreads + tid < n && prev != key[k];
    const unsigned ballot = __ballot_sync(kAll, h);
    if (lane == 0) row_heads[k][warp] = __popc(ballot);
    flags |= static_cast<unsigned>(h) << k;
  }
  __syncthreads();
  STAMP(3);

  // Lane k of each warp: the heads ahead of cell (row k, this warp).
  uint32_t ahead = 0, in_row = 0;
  if (lane < kItems) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = row_heads[lane][w];
      in_row += c;
      if (w < warp) ahead += c;
    }
  }
  const uint32_t incl = warp_scan(in_row, lane);
  const uint32_t base = incl - in_row + ahead;
  const uint32_t segments = __shfl_sync(kAll, incl, kWarp - 1);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool h = (flags >> k) & 1u;
    const unsigned ballot = __ballot_sync(kAll, h);
    const uint32_t cell = __shfl_sync(kAll, base, k);
    if (h) {
      const uint32_t at = cell + __popc(ballot & below);
      heads[at] = k * kThreads + tid;
      seg_ids[at] = static_cast<int32_t>(key[k]);
      seg_first[at] = val[k];
    }
  }
  if (tid == 0) {
    heads[segments] = n;
    *count = static_cast<int32_t>(segments);
  }
  STAMP(4);
}

template <typename I>
int launch(const void* ids, int n, int64_t n_rows, int bits, int items,
           int32_t* sids, int64_t* order, int32_t* heads, int32_t* seg_ids,
           int32_t* seg_first, int32_t* count, cudaStream_t s) {
  const I* in = static_cast<const I*>(ids);
  switch (items) {
#define DGLKE_GROUP_CASE(k)                                                  \
  case k:                                                                    \
    group_ids<I, k><<<1, kThreads, 0, s>>>(in, n, n_rows, bits, sids, order, \
                                           heads, seg_ids, seg_first, count);\
    break;
    DGLKE_GROUP_CASE(1)
    DGLKE_GROUP_CASE(2)
    DGLKE_GROUP_CASE(4)
    DGLKE_GROUP_CASE(8)
    DGLKE_GROUP_CASE(12)
    DGLKE_GROUP_CASE(16)
    DGLKE_GROUP_CASE(24)
    DGLKE_GROUP_CASE(32)
#undef DGLKE_GROUP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tiles route (above kMaxIds ids)

constexpr int kMergeItems = 8;                      // ranks a thread merges
constexpr int kMergeIds = kThreads * kMergeItems;   // ranks a merge block owns
constexpr int kSegItems = 8;                        // ranks a thread flags
constexpr int kSegIds = kThreads * kSegItems;       // ranks a segment block

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// Where a pass writes its sorted (id, position) pairs: a scratch run, or,
// from the last pass, the outputs sids and order (when sids is set).
struct Runs {
  uint32_t* keys;
  int32_t* pos;
  int32_t* sids;
  int64_t* order;
  __device__ __forceinline__ void put(int64_t r, uint32_t key,
                                      int32_t at) const {
    if (sids != nullptr) {
      sids[r] = static_cast<int32_t>(key);
      order[r] = at;
    } else {
      keys[r] = key;
      pos[r] = at;
    }
  }
};

// Tile blockIdx.x (ids [kMaxIds * b, ...)) sorted by the low `bits` bits,
// stable, with each id's position in ids.
template <typename I>
__global__ void __launch_bounds__(kThreads)
sort_tile(const I* __restrict__ ids, int n, int64_t n_rows, int bits,
          Runs out) {
  using Load = cub::BlockLoad<I, kThreads, kMaxItems,
                              sizeof(I) == 4
                                  ? cub::BLOCK_LOAD_WARP_TRANSPOSE
                                  : cub::BLOCK_LOAD_WARP_TRANSPOSE_TIMESLICED>;
  using Sort = cub::BlockRadixSort<uint32_t, kThreads, kMaxItems, uint16_t,
                                   kRadixBits>;
  __shared__ union {
    typename Load::TempStorage load;
    typename Sort::TempStorage sort;
  } tmp;

  const int tid = threadIdx.x;
  const int64_t base = int64_t(blockIdx.x) * kMaxIds;
  const int m = static_cast<int>(min64(kMaxIds, n - base));
  I raw[kMaxItems];
  Load(tmp.load).Load(ids + base, raw, m, I(0));
  uint32_t key[kMaxItems];
  uint16_t val[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int i = tid * kMaxItems + k;
    val[k] = static_cast<uint16_t>(i);
    key[k] = 0xffffffffu;  // padding: sorts after every id
    if (i < m) {
      if (raw[k] < 0 || raw[k] >= n_rows) __trap();
      key[k] = static_cast<uint32_t>(raw[k]);
    }
  }
  __syncthreads();
  Sort(tmp.sort).SortBlockedToStriped(key, val, 0, bits);
  // Rank k * kThreads + tid of the tile is now key[k].
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int r = k * kThreads + tid;
    if (r < m) out.put(base + r, key[k], static_cast<int32_t>(base + val[k]));
  }
}

// How many of the first d ranks of the stable merge of a [na] and b [nb]
// (both sorted; ties to a) come from a.
__device__ __forceinline__ int merge_path(const uint32_t* a, int na,
                                          const uint32_t* b, int nb, int d) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (a[mid] <= b[d - mid - 1]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One merge pass: runs [2jw, 2jw + w) and [2jw + w, 2jw + 2w) (cut at n)
// merged into ranks [2jw, 2jw + 2w) of `out`.  Block b owns ranks
// [kMergeIds * b, ...), which lie in one pair (2w is a multiple of
// kMergeIds).
__global__ void __launch_bounds__(kThreads)
merge_runs(const uint32_t* __restrict__ keys, const int32_t* __restrict__ pos,
           int n, int64_t width, Runs out) {
  __shared__ uint32_t sk[kMergeIds];
  __shared__ int32_t sp[kMergeIds];
  __shared__ int split[2];

  const int tid = threadIdx.x;
  const int64_t o0 = int64_t(blockIdx.x) * kMergeIds;
  const int m = static_cast<int>(min64(kMergeIds, n - o0));
  const int64_t s = o0 - o0 % (2 * width);    // the pair's first rank
  const int64_t mid = min64(s + width, n);    // its right run's first rank
  const int na = static_cast<int>(mid - s);
  const int nb = static_cast<int>(min64(s + 2 * width, n) - mid);
  const int d0 = static_cast<int>(o0 - s);
  if (tid < 2)
    split[tid] = merge_path(keys + s, na, keys + mid, nb, d0 + tid * m);
  __syncthreads();
  // The block's ranks: la from the left run (from i0), lb from the right
  // (from j0), staged left then right.
  const int i0 = split[0], la = split[1] - split[0];
  const int j0 = d0 - i0, lb = m - la;
  for (int t = tid; t < m; t += kThreads) {
    const int64_t src = t < la ? s + i0 + t : mid + j0 + (t - la);
    sk[t] = keys[src];
    sp[t] = pos[src];
  }
  __syncthreads();
  const int d = min(tid * kMergeItems, m);
  int ia = merge_path(sk, la, sk + la, lb, d);
  int ib = la + d - ia;
  uint32_t k_out[kMergeItems];
  int32_t p_out[kMergeItems];
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    if (d + k < m) {
      const bool left = ia < la && (ib >= m || sk[ia] <= sk[ib]);
      const int at = left ? ia++ : ib++;
      k_out[k] = sk[at];
      p_out[k] = sp[at];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMergeItems; ++k) {
    if (d + k < m) {
      sk[d + k] = k_out[k];
      sp[d + k] = p_out[k];
    }
  }
  __syncthreads();
  for (int t = tid; t < m; t += kThreads) out.put(o0 + t, sk[t], sp[t]);
}

// Bit k: rank r0 + k of the sorted ids starts a segment.
__device__ __forceinline__ unsigned head_flags(const int32_t* sids,
                                               int64_t r0, int n) {
  unsigned flags = 0;
  int32_t prev = r0 > 0 && r0 < n ? sids[r0 - 1] : 0;
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    const int64_t r = r0 + k;
    if (r < n) {
      const int32_t key = sids[r];
      if (r == 0 || key != prev) flags |= 1u << k;
      prev = key;
    }
  }
  return flags;
}

__device__ __forceinline__ int64_t seg_rank0() {
  return int64_t(blockIdx.x) * kSegIds + threadIdx.x * kSegItems;
}

// block_heads[b]: the segment heads among block b's ranks.
__global__ void __launch_bounds__(kThreads)
count_heads(const int32_t* __restrict__ sids, int n,
            int32_t* __restrict__ block_heads) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const int c = Reduce(tmp).Sum(__popc(head_flags(sids, seg_rank0(), n)));
  if (threadIdx.x == 0) block_heads[blockIdx.x] = c;
}

// In place, in block order: block_heads[b] becomes the heads of the
// blocks before b.  One block; writes count and heads[count] = n.
__global__ void __launch_bounds__(kThreads)
scan_heads(int32_t* __restrict__ block_heads, int blocks, int n,
           int32_t* __restrict__ heads, int32_t* __restrict__ count) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (int base = 0; base < blocks; base += kThreads) {
    const int i = base + threadIdx.x;
    const int c = i < blocks ? block_heads[i] : 0;
    int before, all;
    Scan(tmp).ExclusiveSum(c, before, all);
    if (i < blocks) block_heads[i] = carry + before;
    carry += all;
    __syncthreads();  // tmp is taken again
  }
  if (threadIdx.x == 0) {
    heads[carry] = n;
    *count = carry;
  }
}

// Each head of block b's ranks written at its place in the segment list.
__global__ void __launch_bounds__(kThreads)
place_heads(const int32_t* __restrict__ sids,
            const int64_t* __restrict__ order, int n,
            const int32_t* __restrict__ block_heads,
            int32_t* __restrict__ heads, int32_t* __restrict__ seg_ids,
            int32_t* __restrict__ seg_first) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int64_t r0 = seg_rank0();
  const unsigned flags = head_flags(sids, r0, n);
  int at;
  Scan(tmp).ExclusiveSum(__popc(flags), at);
  at += block_heads[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kSegItems; ++k) {
    if ((flags >> k) & 1u) {
      const int64_t r = r0 + k;
      heads[at] = static_cast<int32_t>(r);
      seg_ids[at] = sids[r];
      seg_first[at] = static_cast<int32_t>(order[r]);
      ++at;
    }
  }
}

int64_t tiles_scratch_slots(int64_t n) {
  return 4 * n + (n + kSegIds - 1) / kSegIds;
}

template <typename I>
int launch_tiles(const void* ids, int n, int64_t n_rows, int bits,
                 int32_t* sids, int64_t* order, int32_t* heads,
                 int32_t* seg_ids, int32_t* seg_first, int32_t* count,
                 int32_t* scratch, cudaStream_t s) {
  const int tiles = static_cast<int>((int64_t(n) + kMaxIds - 1) / kMaxIds);
  int passes = 0;
  while ((int64_t(1) << passes) < tiles) ++passes;
  // scratch: two runs of keys, two of positions, the blocks' head counts
  uint32_t* keys = reinterpret_cast<uint32_t*>(scratch);
  const Runs run[2] = {{keys, scratch + 2 * int64_t(n), nullptr, nullptr},
                       {keys + n, scratch + 3 * int64_t(n), nullptr,
                        nullptr}};
  const Runs last = {nullptr, nullptr, sids, order};
  int32_t* block_heads = scratch + 4 * int64_t(n);

  cudaError_t err;
  auto failed = [&err] { return (err = cudaGetLastError()) != cudaSuccess; };
  sort_tile<I><<<tiles, kThreads, 0, s>>>(static_cast<const I*>(ids), n,
                                           n_rows, bits,
                                           passes > 0 ? run[0] : last);
  if (failed()) return static_cast<int>(err);
  const int merge_blocks =
      static_cast<int>((int64_t(n) + kMergeIds - 1) / kMergeIds);
  int64_t width = kMaxIds;
  for (int p = 0; p < passes; ++p, width *= 2) {
    const Runs& in = run[p % 2];
    merge_runs<<<merge_blocks, kThreads, 0, s>>>(
        in.keys, in.pos, n, width, p + 1 < passes ? run[(p + 1) % 2] : last);
    if (failed()) return static_cast<int>(err);
  }
  const int seg_blocks =
      static_cast<int>((int64_t(n) + kSegIds - 1) / kSegIds);
  count_heads<<<seg_blocks, kThreads, 0, s>>>(sids, n, block_heads);
  if (failed()) return static_cast<int>(err);
  scan_heads<<<1, kThreads, 0, s>>>(block_heads, seg_blocks, n, heads,
                                    count);
  if (failed()) return static_cast<int>(err);
  place_heads<<<seg_blocks, kThreads, 0, s>>>(sids, order, n, block_heads,
                                              heads, seg_ids, seg_first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ids: [n] int32 (ids64 = 0) or int64 (ids64 = 1), each in [0, n_rows).
// Sorts over the low `bits` bits (1 <= bits <= 32, covering n_rows - 1)
// with `items` ids a thread (1, 2, 4, 8, 12, 16, 24 or 32; 256 * items >=
// n).  Writes sids [n] int32 and order [n] int64, as torch.sort(ids.int32,
// stable=True) returns them; heads [n + 1] int32, the position of each
// segment's first id with heads[count] = n; seg_ids [n] int32, each
// segment's id; seg_first [n] int32, the position in ids of each segment's
// first occurrence (order[heads[k]]); count [1] int32, the number of
// segments.  Entries of heads, seg_ids and seg_first past the count are
// left as they were.  Requires 0 < n <= 8,192.
int dglke_group_ids(const void* ids, int ids64, int64_t n, int64_t n_rows,
                    int bits, int items, int32_t* sids, int64_t* order,
                    int32_t* heads, int32_t* seg_ids, int32_t* seg_first,
                    int32_t* count, void* stream) {
  if (n <= 0 || n > kMaxIds || bits < 1 || bits > 32 ||
      int64_t(items) * kThreads < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  return ids64 ? launch<int64_t>(ids, m, n_rows, bits, items, sids, order,
                                 heads, seg_ids, seg_first, count, s)
               : launch<int32_t>(ids, m, n_rows, bits, items, sids, order,
                                 heads, seg_ids, seg_first, count, s);
}

// The tiles route, for any 0 < n <= 2^31 - 1 (ids, bits and the outputs as
// dglke_group_ids takes them): 4 + ceil(log2(ceil(n / 8,192))) launches.
// scratch: int32 [scratch_slots], at least 4n + ceil(n / 2,048) slots
// (ops/rows.py:group_scratch_slots), left unspecified.
int dglke_group_ids_tiles(const void* ids, int ids64, int64_t n,
                          int64_t n_rows, int bits, int32_t* sids,
                          int64_t* order, int32_t* heads, int32_t* seg_ids,
                          int32_t* seg_first, int32_t* count,
                          int32_t* scratch, int64_t scratch_slots,
                          void* stream) {
  if (n <= 0 || n > INT32_MAX || bits < 1 || bits > 32 ||
      scratch_slots < tiles_scratch_slots(n))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  return ids64 ? launch_tiles<int64_t>(ids, m, n_rows, bits, sids, order,
                                       heads, seg_ids, seg_first, count,
                                       scratch, s)
               : launch_tiles<int32_t>(ids, m, n_rows, bits, sids, order,
                                       heads, seg_ids, seg_first, count,
                                       scratch, s);
}

#ifdef DGLKE_GROUP_STAMPS
// The phase stamps of the last launch: [5] ns of %globaltimer.
int dglke_group_stamps(unsigned long long* stamps) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(g_stamps)));
}
#endif

}  // extern "C"
