// TransE_l2's training loss and its gradients with respect to the gathered
// rows, for Hopper (sm_90a): the element-wise work of the forward and the
// backward, and the backward's two products, in two launches.
//
// Replaces no TPU kernel: the JAX package leaves this part of the step to
// XLA's fusion (dglke_tpu/models/ke_model.py, score_functions.py, loss.py).
// In the port it was autograd over some eighty PyTorch launches a step,
// each a few microseconds on a [B, K] or [B, D] array: three quarters of a
// TransE step's device time.
//
// What it computes (ops/transe_l2.py:loss_and_grads_plain repeats the
// arithmetic), for B positives in C chunks of Bc, each chunk's Bc queries
// against its K shared negatives, rows of D fp32:
//   pos_i   = gamma - sqrt(|h_i + r_i - t_i|^2 + 1e-30)
//   q_i     = h_i + r_i (tail-corrupt) or t_i - r_i (head-corrupt)
//   sq_ik   = (|q_i|^2 + |n_k|^2) - 2 q_i.n_k       (dgl-ke's expansion)
//   neg_ik  = gamma - sqrt(max(sq_ik, 1e-30))
//   loss    = share (mean_i w_i L(pos_i)
//                    + mean_i w_i sum_k a_ik L(-neg_ik)) / 2
// with L(x) = -logsigmoid(x), a_ik = softmax_k(T neg_ik) held constant
// (self-adversarial) or 1/K, edge weights w_i (1 without them), plus
// coef * sum |x|^p over every gathered row.  With s_ik = dloss/dsq_ik:
//   dloss/dq_i = 2 q_i sum_k s_ik - 2 sum_k s_ik n_k
//   dloss/dn_k = 2 n_k sum_i s_ik - 2 sum_i s_ik q_i
// and the positive's and the regularization's terms.
//
// What bounds it on an H100: fp32 operations.  Each of the three products
// is C Bc K D multiply-adds (FB15k's recipe: 5 x 200 x 200 x 400, 0.48
// GFLOP in all, 7 us at 67 TFLOP/s; ogbl-wikikg2's 4 x 128 x 128 x 500),
// while the rows read and the gradients written are 6-7 MB (2 us at 3.35
// TB/s).  They must be IEEE fp32, as the autograd route's with TF32 off, so
// the tensor cores (TF32 at best) are out: the products run as fp32 FMAs on
// the CUDA cores.
//
// Which sums stay PyTorch's: a row's gradient scales with the sums that
// are shared by all of its elements (|q_i|^2, |n_k|^2 and q_i.n_k through
// the scores, the softmax's sum, and sum_k s_ik, sum_i s_ik), so summing
// one of them in another order moves the norm of a table's gradient by
// 1e-9 to 6e-9 of itself at these shapes (measured on the card against
// kgbench's reference, one reduction at a time), against a check that
// allows 3e-9 (FB15k) and 5e-9 (wikikg2).  Those sums are taken by the
// same PyTorch calls as the reference's, on the same bits (ops/
// transe_l2.py), and the softmax here runs in the order of PyTorch's warp
// softmax (a lane's elements k = lane + 32 j summed in j, then a butterfly
// over the warp; PyTorch takes it up to K = 1,024 and a block softmax
// above, where the norms measured 4.1e-10 at K = 2,048: tests/
// test_torch_transe_l2_fused.py holds both sides within 1e-9, so a PyTorch
// that reorders these sums fails there first); the backward's products and
// every element-wise step are free, since their roundings do not share a
// factor across a row.
//
// Design:
//   * two launches: a pass over the rows (transe_l2_rows), then the two
//     gradient products with the gradients' assembly (transe_l2_grads).
//   * the row pass: a warp per positive: its score, loss and the
//     coefficient of its gradient; its K scores from |q_i|^2, |n_k|^2 and
//     q_i.n_k, the softmax over them, their losses and s_ik, written as
//     [C, Bc, K] (0.8 MB at FB15k, in L2); and, with regularization, a
//     warp per negative row for its sum of |x|^p.  Each block writes one
//     fp64 partial of each log value; the last block of transe_l2_grads
//     adds them in a fixed order and rounds once to fp32.
//   * each product tile: 256 threads in four groups, each group a quarter of
//     a 32-deep slab of the reduction staged in shared memory, each thread a
//     4 x 4 register tile of the 32 x 32 output; the four groups' partial
//     tiles are added in group order at the end.  The operands are read as
//     16-byte vectors where D and K are multiples of four and the rows lie
//     on 16-byte boundaries (both benchmark cells), else element by element
//     with a bound check on each (the same products in the same order, so
//     a width off four costs loads, not another result); the loads of the
//     next two slabs are issued before the current slab's
//     products, so that they are in flight while the block computes:
//     without that the products waited on L2 and ran at half the speed.  A
//     slab is laid out in shared memory so that the vector stores and the
//     16-byte fragment reads are free of bank conflicts ([row][depth] rows
//     of 36 where the operand is contiguous along the reduction,
//     [depth][row] rows of 36 where it is contiguous along the output).
//     Measured on an H100 80GB HBM3 at 700 W: slab depths 32 and 64 and one
//     to three blocks an SM are within 10% of each other at both benchmark
//     cells' shapes; the slab of 32 was the faster at FB15k's.
//   * the row pass's loops are left rolled: unrolled by four they took
//     twice as long on the card.
//   * no atomics: every sum has a fixed order, so two launches on the same
//     rows give the same bits (a replayed CUDA graph, the tables after it).
//
// Interface: one plain C function for each launch, taking the call's
// arguments (DglkeTranseL2) and the CUDA stream; each returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kTile = 32;                 // output tile edge
constexpr int kSlab = 32;                 // reduction depth staged at once
constexpr int kGroupDepth = kSlab / 4;    // a thread group's share of it
constexpr int kSlabVecs = kSlab / 4;      // 16-byte vectors along a slab row
constexpr int kVecs = kTile * kSlab / 4 / kThreads;  // a thread's, a slab
constexpr int kAhead = 2;                 // slabs whose loads are in flight
constexpr int kPitchRC = kSlab + 4;       // [row][depth] layout
constexpr int kPitchMC = kTile + 4;       // [depth][row] layout
constexpr int kRedPitch = kTile + 1;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// a slab in either layout, and half of the four groups' partial tiles
constexpr int kOperand =
    cmax(cmax(kSlab * kPitchMC, kTile * kPitchRC), 2 * kTile * kRedPitch);
constexpr int kRowsPerBlock = kThreads / kWarp;
constexpr int kLogs = 3;                  // pos, neg, regularization partials

static_assert(kVecs >= 1 && kSlabVecs <= kWarp,
              "a slab is whole vectors of the block's threads");

struct Params {
  const float* ent;      // [2B + C K, D]: h rows, t rows, negative rows
  const float* rel;      // [B, D]
  const float* weights;  // [B] or null
  const float* q;        // [B, D]: h + r or t - r
  const float* q_sq;     // [B]: |q_i|^2
  const float* n_sq;     // [C K]: |n_k|^2
  const float* dot;      // [C, Bc, K]: q_i.n_k
  const float* row_sum;  // [C, Bc]: sum_k s_ik
  const float* col_sum;  // [C, K]: sum_i s_ik
  float* s;              // [C, Bc, K]: s_ik = dloss/dsq_ik
  float* cpos;           // [B]: dloss/de_i / e_i of the positive's e
  double* partials;      // [row blocks, kLogs]
  float* ent_grad;       // [2B + C K, D]
  float* rel_grad;       // [B, D]
  float* out;            // pos_loss, neg_loss, loss, regularization, total
  int64_t b, chunks, bc, k, dim;
  int neg_head, adv, reg_pow, row_blocks;
  float gamma, temp, scale, share, coef;
};

struct Smem {
  float op[2][kOperand];
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// An operand of a tile product: four elements of the tile's row (or
// column) m < 32 at the reduction index r; zero outside.  kRC: contiguous
// along r in global memory, the four at r..r+3 of row m; else contiguous
// along m, the four at m..m+3 of depth r.  kVec: one 16-byte load, for
// pitches and extents that are multiples of four on 16-byte boundaries
// (a load is then wholly inside or wholly outside); else four loads, each
// checked.
template <bool kRC, bool kVec>
struct Operand {
  static constexpr bool kRowContig = kRC;
  const float* base;
  int64_t pitch;
  int64_t rows, depth;
  __device__ __forceinline__ float4 operator()(int m, int64_t r) const {
    if (m >= rows || r >= depth) return zero4();
    if constexpr (kVec) {
      return *reinterpret_cast<const float4*>(
          base + (kRC ? m * pitch + r : r * pitch + m));
    } else {
      float e[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = kRC ? r + q < depth : m + q < rows;
        e[q] = in ? base[kRC ? m * pitch + r + q : r * pitch + m + q] : 0.f;
      }
      return make_float4(e[0], e[1], e[2], e[3]);
    }
  }
};

// A slab [32 rows x kSlab deep] is kVecs 16-byte vectors a thread.  RC
// ([row][depth] in shared memory): thread t loads rows t / kSlabVecs +
// (kThreads / kSlabVecs) j at depth 4 (t % kSlabVecs); else
// ([depth][row]): rows 4 (t % 8) .. + 3 at depths t/8 + 32 j.
template <class L>
__device__ __forceinline__ void fetch_slab(const L& ld, int64_t r0,
                                           float4 (&v)[kVecs]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if constexpr (L::kRowContig)
      v[j] = ld(t / kSlabVecs + (kThreads / kSlabVecs) * j,
                r0 + 4 * (t % kSlabVecs));
    else
      v[j] = ld(4 * (t % 8), r0 + t / 8 + 32 * j);
  }
}

template <bool kRC>
__device__ __forceinline__ void stash_slab(const float4 (&v)[kVecs],
                                           float* s) {
  const int t = threadIdx.x;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if constexpr (kRC)
      *reinterpret_cast<float4*>(
          s + (t / kSlabVecs + (kThreads / kSlabVecs) * j) * kPitchRC +
          4 * (t % kSlabVecs)) = v[j];
    else
      *reinterpret_cast<float4*>(s + (t / 8 + 32 * j) * kPitchMC +
                                 4 * (t % 8)) = v[j];
  }
}

// The tile rows a thread's register tile covers: t + 8j ([row][depth]
// slabs, whose 16-byte reads along the depth then hit distinct banks) or
// 4t + j ([depth][row] slabs, one 16-byte read across four rows).
template <bool kRC>
__device__ __forceinline__ int tile_row(int t, int j) {
  return kRC ? t + 8 * j : 4 * t + j;
}

// f[j][q]: the thread's row j at depth r + q.
template <bool kRC>
__device__ __forceinline__ void fragment(const float* s, int t, int r,
                                         float (&f)[4][4]) {
  if constexpr (kRC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(s + (t + 8 * j) * kPitchRC + r);
      f[j][0] = v.x; f[j][1] = v.y; f[j][2] = v.z; f[j][3] = v.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(s + (r + q) * kPitchMC + 4 * t);
      f[0][q] = v.x; f[1][q] = v.y; f[2][q] = v.z; f[3][q] = v.w;
    }
  }
}

// sum_r A(m, r) B(n, r) over r < depth for the 32 x 32 tile, left in shared
// memory for tile_value.  The loads of the kAhead slabs after the current
// one are issued before its products, so that they are in flight while the
// block computes.
template <class LA, class LB>
__device__ void tile_product(const LA& la, const LB& lb, int64_t depth,
                             Smem& sm) {
  const int tid = threadIdx.x, g = tid / 64, t = tid % 64;
  const int tm = t % 8, tn = t / 8;
  float acc[4][4] = {};
  float4 va[kAhead][kVecs], vb[kAhead][kVecs];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    fetch_slab(la, u * kSlab, va[u]);
    fetch_slab(lb, u * kSlab, vb[u]);
  }
  for (int64_t r0 = 0; r0 < depth; r0 += kAhead * kSlab) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t rs = r0 + u * kSlab;
      if (rs >= depth) break;
      stash_slab<LA::kRowContig>(va[u], sm.op[0]);
      stash_slab<LB::kRowContig>(vb[u], sm.op[1]);
      __syncthreads();
      fetch_slab(la, rs + kAhead * kSlab, va[u]);
      fetch_slab(lb, rs + kAhead * kSlab, vb[u]);
#pragma unroll
      for (int rk = 0; rk < kGroupDepth; rk += 4) {
        const int r = g * kGroupDepth + rk;
        float a[4][4], bf[4][4];
        fragment<LA::kRowContig>(sm.op[0], tm, r, a);
        fragment<LB::kRowContig>(sm.op[1], tn, r, bf);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int l = 0; l < 4; ++l)
              acc[j][l] = fmaf(a[j][q], bf[l][q], acc[j][l]);
      }
      __syncthreads();
    }
  }
  float* red = &sm.op[0][0];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int l = 0; l < 4; ++l)
      red[(g * kTile + tile_row<LA::kRowContig>(tm, j)) * kRedPitch +
          tile_row<LB::kRowContig>(tn, l)] = acc[j][l];
  __syncthreads();
}

// Element (m, n) of the product: the four groups' partials in group order.
__device__ __forceinline__ float tile_value(const Smem& sm, int m, int n) {
  const float* red = &sm.op[0][0];
  const int o = m * kRedPitch + n, g = kTile * kRedPitch;
  return ((red[o] + red[g + o]) + red[2 * g + o]) + red[3 * g + o];
}

template <class T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = kWarp / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// -logsigmoid(x), stably.
__device__ __forceinline__ float neg_logsigmoid(float x) {
  return fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x)));
}

// d logsigmoid(x) / dx as PyTorch's log_sigmoid_backward forms it.
__device__ __forceinline__ float logsigmoid_deriv(float x) {
  const bool negative = x < 0.f;
  const float z = expf(-fabsf(x));
  return (negative ? 1.f : 0.f) - (negative ? 1.f : -1.f) * (z / (1.f + z));
}

// |x|^p as torch.pow takes p = 1, 2, 3 (products), else powf.
__device__ __forceinline__ float pow_abs(float x, int p) {
  const float a = fabsf(x);
  if (p == 1) return a;
  if (p == 2) return a * a;
  if (p == 3) return a * a * a;
  return powf(a, static_cast<float>(p));
}

// d/dx coef |x|^p = coef p |x|^(p-1) sign(x); 0 without regularization.
__device__ __forceinline__ float reg_grad(float x, const Params& p) {
  if (p.reg_pow == 0) return 0.f;
  const float sign = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float d = p.reg_pow == 1 ? 1.f : pow_abs(x, p.reg_pow - 1);
  return p.coef * (static_cast<float>(p.reg_pow) * d) * sign;
}

__device__ __forceinline__ float4 pow_abs4(float4 v, int p) {
  return make_float4(pow_abs(v.x, p), pow_abs(v.y, p), pow_abs(v.z, p),
                     pow_abs(v.w, p));
}

__device__ __forceinline__ float sum4(float4 v) {
  return ((v.x + v.y) + v.z) + v.w;
}

// A row's sums of e^2 = ((h + r) - t)^2 and, with regularization, of
// |h|^p + |r|^p + |t|^p (fp64) over the lane's elements: kVec, 16-byte
// vectors x = lane + 32 j of D / 4; else elements x = lane + 32 j of D.
template <bool kVec>
__device__ __forceinline__ float positive_sums(const Params& p, int64_t row,
                                               int lane, double& reg) {
  float s = 0.f;
  if constexpr (kVec) {
    const int64_t d4 = p.dim / 4;
    const float4* h = reinterpret_cast<const float4*>(p.ent) + row * d4;
    const float4* t =
        reinterpret_cast<const float4*>(p.ent) + (p.b + row) * d4;
    const float4* r = reinterpret_cast<const float4*>(p.rel) + row * d4;
    for (int64_t x = lane; x < d4; x += kWarp) {
      const float4 hv = h[x], rv = r[x], tv = t[x];
      const float ex = (hv.x + rv.x) - tv.x, ey = (hv.y + rv.y) - tv.y,
                  ez = (hv.z + rv.z) - tv.z, ew = (hv.w + rv.w) - tv.w;
      s += ((ex * ex + ey * ey) + ez * ez) + ew * ew;
      if (p.reg_pow)
        reg += (double(sum4(pow_abs4(hv, p.reg_pow))) +
                double(sum4(pow_abs4(rv, p.reg_pow)))) +
               double(sum4(pow_abs4(tv, p.reg_pow)));
    }
  } else {
    const float* h = p.ent + row * p.dim;
    const float* t = p.ent + (p.b + row) * p.dim;
    const float* r = p.rel + row * p.dim;
    for (int64_t x = lane; x < p.dim; x += kWarp) {
      const float hv = h[x], rv = r[x], tv = t[x];
      const float e = (hv + rv) - tv;
      s += e * e;
      if (p.reg_pow)
        reg += (double(pow_abs(hv, p.reg_pow)) +
                double(pow_abs(rv, p.reg_pow))) +
               double(pow_abs(tv, p.reg_pow));
    }
  }
  return s;
}

// A negative row's sum of |x|^p over the lane's elements (fp64), as
// positive_sums takes them.
template <bool kVec>
__device__ __forceinline__ double negative_reg(const Params& p, int64_t row,
                                               int lane) {
  double reg = 0.0;
  if constexpr (kVec) {
    const int64_t d4 = p.dim / 4;
    const float4* n =
        reinterpret_cast<const float4*>(p.ent) + (2 * p.b + row) * d4;
    for (int64_t x = lane; x < d4; x += kWarp)
      reg += double(sum4(pow_abs4(n[x], p.reg_pow)));
  } else {
    const float* n = p.ent + (2 * p.b + row) * p.dim;
    for (int64_t x = lane; x < p.dim; x += kWarp)
      reg += double(pow_abs(n[x], p.reg_pow));
  }
  return reg;
}

// The positives' blocks: a warp per positive.  With regularization, the
// negatives' blocks after them: a warp per negative row (its sum of |x|^p).
// A positive's K scores, softmax and s_ik go through its elements k = lane
// + 32 j in j order, as PyTorch's warp softmax takes them.  One fp64
// partial of each log value a block.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) transe_l2_rows(Params p) {
  __shared__ double parts[kRowsPerBlock][kLogs];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t pos_blocks = (p.b + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t k = p.k;
  double pos_term = 0.0, neg_term = 0.0, reg = 0.0;
  if (blockIdx.x < pos_blocks) {
    const int64_t row = int64_t(blockIdx.x) * kRowsPerBlock + warp;
    if (row < p.b) {
      const float s = warp_sum(positive_sums<kVec>(p, row, lane, reg));
      const float pnorm = sqrtf(s + 1e-30f);
      const float pos = p.gamma - pnorm;
      const float w = p.weights ? p.weights[row] : 1.f;
      const float sw = p.scale * w;
      pos_term = double(neg_logsigmoid(pos) * w);
      // dloss/de = -(dloss/dpos) e / pnorm, dloss/dpos = -sw dlogsigmoid(pos)
      if (lane == 0) p.cpos[row] = sw * logsigmoid_deriv(pos) / pnorm;
      // the chunk's |n_k|^2, this row's q_i.n_k and s_ik
      const float* n_sq = p.n_sq + row / p.bc * k;
      const float* dot = p.dot + row * k;
      float* s_row = p.s + row * k;
      const float q_sq = p.q_sq[row];
      float mx = -INFINITY, den = 0.f;
      if (p.adv) {
        for (int64_t x = lane; x < k; x += kWarp) {
          const float sq = (q_sq + n_sq[x]) - 2.f * dot[x];
          mx = fmaxf(mx, (p.gamma - sqrtf(fmaxf(sq, 1e-30f))) * p.temp);
        }
        mx = warp_max(mx);
        for (int64_t x = lane; x < k; x += kWarp) {
          const float sq = (q_sq + n_sq[x]) - 2.f * dot[x];
          den += expf((p.gamma - sqrtf(fmaxf(sq, 1e-30f))) * p.temp - mx);
        }
        den = warp_sum(den);
      }
      const float inv_k = 1.f / static_cast<float>(k);
      float nl = 0.f;
      for (int64_t x = lane; x < k; x += kWarp) {
        const float sq = (q_sq + n_sq[x]) - 2.f * dot[x];
        const float dist = sqrtf(fmaxf(sq, 1e-30f));
        const float neg = p.gamma - dist;
        const float a = p.adv ? expf(neg * p.temp - mx) / den : inv_k;
        const float term = neg_logsigmoid(-neg) * w;
        nl += p.adv ? a * term : term;
        // dloss/dneg = (scale w a) dlogsigmoid(x)/dx at x = -neg
        const float dneg = (sw * a) * logsigmoid_deriv(-neg);
        s_row[x] = sq >= 1e-30f ? -dneg / (2.f * dist) : 0.f;
      }
      nl = warp_sum(nl);
      neg_term = double(p.adv ? nl : nl / static_cast<float>(k));
    }
  } else {
    const int64_t row =
        int64_t(blockIdx.x - pos_blocks) * kRowsPerBlock + warp;
    if (row < p.chunks * k) reg = negative_reg<kVec>(p, row, lane);
  }
  // pos_term and neg_term are the same on every lane; reg is the lane's
  reg = warp_sum(reg);
  if (lane == 0) {
    parts[warp][0] = pos_term;
    parts[warp][1] = neg_term;
    parts[warp][2] = reg;
  }
  __syncthreads();
  if (threadIdx.x < kLogs) {
    double s = 0.0;
    for (int w = 0; w < kRowsPerBlock; ++w) s += parts[w][threadIdx.x];
    p.partials[int64_t(blockIdx.x) * kLogs + threadIdx.x] = s;
  }
}

// The gradient rows: blocks over (chunk, query tile, column tile) write
// h, t and r's; blocks over (chunk, negative tile, column tile) the
// negatives'; the last block the log values.  kVec as transe_l2_rows.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) transe_l2_grads(Params p) {
  __shared__ __align__(16) Smem sm;
  const int64_t d = p.dim, k = p.k, bc = p.bc;
  const int64_t td = (d + kTile - 1) / kTile;
  const int64_t tq = (bc + kTile - 1) / kTile * td;
  const int64_t tn = (k + kTile - 1) / kTile * td;
  int64_t blk = blockIdx.x;
  if (blk < p.chunks * tq) {
    // dloss/dq_i = 2 q_i sum_k s_ik - 2 sum_k s_ik n_k, with the
    // positives' and the regularization's terms: the rows of h, t and r.
    const int64_t c = blk / tq, i0 = (blk % tq) / td * kTile,
                  d0 = (blk % td) * kTile;
    const int64_t row0 = c * bc + i0;
    const Operand<true, kVec> s{p.s + row0 * k, k, bc - i0, k};
    const Operand<false, kVec> n{p.ent + (2 * p.b + c * k) * d + d0, d,
                                 d - d0, k};
    tile_product(s, n, k, sm);
    for (int o = threadIdx.x; o < kTile * kTile; o += kThreads) {
      const int m = o / kTile, l = o % kTile;
      if (i0 + m >= bc || d0 + l >= d) continue;
      const int64_t row = row0 + m, x = row * d + d0 + l;
      const float hv = p.ent[x], tv = p.ent[p.b * d + x], rv = p.rel[x];
      const float pe = p.cpos[row] * ((hv + rv) - tv);
      const float gq =
          2.f * (p.row_sum[row] * p.q[x]) - 2.f * tile_value(sm, m, l);
      float gh = pe, gt = -pe, gr = pe;
      if (p.neg_head) {
        gt += gq;
        gr -= gq;
      } else {
        gh += gq;
        gr += gq;
      }
      p.ent_grad[x] = gh + reg_grad(hv, p);
      p.ent_grad[p.b * d + x] = gt + reg_grad(tv, p);
      p.rel_grad[x] = gr + reg_grad(rv, p);
    }
    return;
  }
  blk -= p.chunks * tq;
  if (blk < p.chunks * tn) {
    // dloss/dn_k = 2 n_k sum_i s_ik - 2 sum_i s_ik q_i, with the
    // regularization's term.
    const int64_t c = blk / tn, k0 = (blk % tn) / td * kTile,
                  d0 = (blk % td) * kTile;
    const Operand<false, kVec> s{p.s + c * bc * k + k0, k, k - k0, bc};
    const Operand<false, kVec> q{p.q + c * bc * d + d0, d, d - d0, bc};
    tile_product(s, q, bc, sm);
    for (int o = threadIdx.x; o < kTile * kTile; o += kThreads) {
      const int m = o / kTile, l = o % kTile;
      if (k0 + m >= k || d0 + l >= d) continue;
      const int64_t x = (2 * p.b + c * k + k0 + m) * d + d0 + l;
      const float nv = p.ent[x];
      p.ent_grad[x] = (2.f * (p.col_sum[c * k + k0 + m] * nv) -
                       2.f * tile_value(sm, m, l)) + reg_grad(nv, p);
    }
    return;
  }
  // The log values: each partial column summed by lane in a fixed order,
  // then across the warp; one rounding to fp32.
  if (threadIdx.x >= kWarp) return;
  double s[kLogs] = {};
  for (int64_t j = threadIdx.x; j < p.row_blocks; j += kWarp)
    for (int v = 0; v < kLogs; ++v) s[v] += p.partials[j * kLogs + v];
  for (int v = 0; v < kLogs; ++v) s[v] = warp_sum(s[v]);
  if (threadIdx.x == 0) {
    const float pos = static_cast<float>(s[0] / double(p.b));
    const float neg = static_cast<float>(s[1] / double(p.b));
    const float loss = (pos + neg) / 2.f * p.share;
    const float reg = p.coef * static_cast<float>(s[2]);
    p.out[0] = pos * p.share;
    p.out[1] = neg * p.share;
    p.out[2] = loss;
    p.out[3] = reg;
    p.out[4] = p.reg_pow ? loss + reg : loss;
  }
}

int64_t row_blocks(int64_t b, int64_t chunks, int64_t k, int reg_pow) {
  return (b + kRowsPerBlock - 1) / kRowsPerBlock +
         (reg_pow ? (chunks * k + kRowsPerBlock - 1) / kRowsPerBlock : 0);
}

bool misaligned(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 != 0;
}

// The 16-byte loads' case: D and K multiples of four, every row table on
// 16-byte boundaries.
bool vector_loads(const Params& p) {
  return p.dim % 4 == 0 && p.k % 4 == 0 && !misaligned(p.ent) &&
         !misaligned(p.rel) && !misaligned(p.q) && !misaligned(p.s);
}

}  // namespace

extern "C" {

// One call's arguments, shared by both launches.  ent: [2b + chunks k, dim]
// fp32 rows (h, t, negatives), rel: [b, dim], weights: [b] or null, q: [b,
// dim] (h + r, or t - r with neg_head), q_sq [b], n_sq [chunks k], dot
// [chunks, bc, k], all contiguous; b = chunks * bc (16-byte loads where
// dim and k are multiples of 4 and ent, rel, q and s lie on 16-byte
// boundaries, element loads otherwise).  adv: the
// self-adversarial weights at temperature temp; scale = share / (2 b);
// reg_pow 0 without regularization.  s [chunks, bc, k], cpos [b] and
// partials [ceil(b / 8) + (reg_pow ? ceil(chunks k / 8) : 0), 3] fp64
// (slots, at least that many) are the row pass's outputs.  The gradient
// pass also takes row_sum [chunks, bc] and col_sum [chunks, k] (the sums
// of s over k and over i) and writes ent_grad, rel_grad (shaped as ent,
// rel) and out [5]: pos_loss, neg_loss, loss, regularization, loss +
// regularization.
struct DglkeTranseL2 {
  const float* ent;
  const float* rel;
  const float* weights;
  const float* q;
  const float* q_sq;
  const float* n_sq;
  const float* dot;
  const float* row_sum;
  const float* col_sum;
  float* s;
  float* cpos;
  double* partials;
  int64_t slots;
  float* ent_grad;
  float* rel_grad;
  float* out;
  int64_t b, chunks, bc, k, dim;
  int neg_head, adv, reg_pow;
  float gamma, temp, scale, share, coef;
};

static int params(const DglkeTranseL2* a, Params* p) {
  const int64_t blocks = row_blocks(a->b, a->chunks, a->k, a->reg_pow);
  if (a->b <= 0 || a->chunks <= 0 || a->bc <= 0 || a->k <= 0 ||
      a->dim <= 0 || a->b != a->chunks * a->bc ||
      a->slots < blocks * kLogs || a->reg_pow < 0 || blocks > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  *p = Params{a->ent,      a->rel,      a->weights,  a->q,        a->q_sq,
              a->n_sq,     a->dot,      a->row_sum,  a->col_sum,  a->s,
              a->cpos,     a->partials, a->ent_grad, a->rel_grad, a->out,
              a->b,        a->chunks,   a->bc,       a->k,        a->dim,
              a->neg_head, a->adv,      a->reg_pow,  static_cast<int>(blocks),
              a->gamma,    a->temp,     a->scale,    a->share,    a->coef};
  return 0;
}

int dglke_transe_l2_rows(const DglkeTranseL2* a, void* stream) {
  Params p;
  const int err = params(a, &p);
  if (err) return err;
  void (*kernel)(Params) =
      vector_loads(p) ? transe_l2_rows<true> : transe_l2_rows<false>;
  kernel<<<static_cast<unsigned>(p.row_blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dglke_transe_l2_grads(const DglkeTranseL2* a, void* stream) {
  Params p;
  const int err = params(a, &p);
  if (err) return err;
  const int64_t td = (p.dim + kTile - 1) / kTile;
  const int64_t blocks =
      p.chunks * ((p.bc + kTile - 1) / kTile + (p.k + kTile - 1) / kTile) *
          td + 1;
  if (blocks > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(Params) =
      vector_loads(p) ? transe_l2_grads<true> : transe_l2_grads<false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
