// Native LDG streaming graph partitioner for dglke_tpu_torch.
//
// A copy of the JAX package's native/ldg_partition.cpp, code unchanged, so
// that both packages write the same partitions from the same graph and
// seed: one-pass Linear Deterministic Greedy node streaming over the
// undirected train graph, in place of the reference's METIS k-way call.
// The numpy form in dglke_tpu_torch/data/partition_graph.py is a Python
// loop over the nodes, unusable at Freebase scale (86M nodes / 338M
// edges); this one builds the CSR with two counting passes and streams all
// nodes in C++.  Its stream order is a xoshiro256 Fisher-Yates shuffle,
// not numpy's permutation, so the two forms assign differently.
//
// Plain C ABI for ctypes (dglke_tpu_torch/data/native.py builds and loads
// it).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

static inline uint64_t splitmix64_p(uint64_t& x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

struct Rng64 {
  uint64_t s[4];
  explicit Rng64(uint64_t seed) {
    for (int i = 0; i < 4; ++i) s[i] = splitmix64_p(seed);
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw (Lemire)
  inline uint64_t bounded(uint64_t n) {
    uint64_t x = next();
    __uint128_t m = (__uint128_t)x * (__uint128_t)n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t floor = (~n + 1) % n;
      while (l < floor) {
        x = next();
        m = (__uint128_t)x * (__uint128_t)n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

}  // namespace

extern "C" {

// Streams all nodes once in a seeded random order; assign_out[n_nodes]
// receives the partition id per node.  Returns the resulting edge cut
// (edges whose endpoints land in different partitions).
int64_t kge_ldg_partition(const int64_t* h, const int64_t* t,
                          int64_t n_edges, int64_t n_nodes, int32_t k,
                          uint64_t seed, int32_t* assign_out) {
  // Validate before any heap write: bad ids or k would otherwise corrupt
  // the heap silently (the numpy fallback fails loudly).  Returns -1 so
  // the Python wrapper can raise.
  if (k <= 0 || n_nodes <= 0 || n_edges < 0) return -1;
  for (int64_t e = 0; e < n_edges; ++e) {
    if (h[e] < 0 || h[e] >= n_nodes || t[e] < 0 || t[e] >= n_nodes)
      return -1;
  }
  // --- undirected CSR (both directions) via counting sort ---------------
  std::vector<int64_t> indptr(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    ++indptr[h[e] + 1];
    ++indptr[t[e] + 1];
  }
  for (int64_t v = 0; v < n_nodes; ++v) indptr[v + 1] += indptr[v];
  std::vector<int32_t> adj(2 * n_edges);
  {
    std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      adj[fill[h[e]]++] = (int32_t)t[e];
      adj[fill[t[e]]++] = (int32_t)h[e];
    }
  }

  // --- seeded stream order (Fisher-Yates) -------------------------------
  std::vector<int64_t> order(n_nodes);
  for (int64_t v = 0; v < n_nodes; ++v) order[v] = v;
  Rng64 rng(seed);
  for (int64_t i = n_nodes - 1; i > 0; --i) {
    int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
    std::swap(order[i], order[j]);
  }

  // --- LDG stream: argmax_p |placed nbrs in p| * (1 - size_p/capacity),
  //     ties toward the emptiest partition ------------------------------
  std::fill(assign_out, assign_out + n_nodes, (int32_t)-1);
  std::vector<int64_t> sizes(k, 0);
  std::vector<int64_t> cnt(k, 0);
  const double capacity =
      std::max(1.0, (double)n_nodes / (double)k);
  for (int64_t oi = 0; oi < n_nodes; ++oi) {
    const int64_t node = order[oi];
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int64_t a = indptr[node]; a < indptr[node + 1]; ++a) {
      const int32_t p = assign_out[adj[a]];
      if (p >= 0) ++cnt[p];
    }
    int32_t best = 0;
    double best_score = -1e300;
    for (int32_t p = 0; p < k; ++p) {
      const double score =
          (double)cnt[p] * (1.0 - (double)sizes[p] / capacity) -
          1e-9 * (double)sizes[p];
      if (score > best_score) {
        best_score = score;
        best = p;
      }
    }
    assign_out[node] = best;
    ++sizes[best];
  }

  int64_t cut = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    if (assign_out[h[e]] != assign_out[t[e]]) ++cut;
  }
  return cut;
}

}  // extern "C"
