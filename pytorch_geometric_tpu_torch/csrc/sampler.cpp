// Native host neighbour sampling, for the loaders of the port.
//
// A copy of pytorch_geometric_tpu/csrc/sampler.cpp's samplers
// (neighbor_sample, hetero_neighbor_sample, neighbor_sample_tw and
// random_walk, unchanged, so the two packages draw the same neighbours and
// walks from the same seed), the equivalent of pyg-lib's
// torch.ops.pyg.neighbor_sample, hetero_neighbor_sample and random_walk
// (reference torch_geometric/sampler/neighbor_sampler.py:471, :576,
// nn/models/node2vec.py). Exposed through a C ABI
// and loaded with ctypes, which releases the GIL around each call, so the
// loader's worker threads sample in parallel. Outputs are written into
// caller-allocated fixed-capacity (padded) buffers, so every batch of a
// loader has one shape, matching the Python sampler's layout.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

namespace {

// Open-addressing hash map (int64 -> int64), linear probing — the
// reference keeps an equivalent in pyg-lib (CPUHashMap,
// hash_tensor.py:67). ~3x faster than std::unordered_map on this
// workload.
struct FlatMap {
  std::vector<int64_t> keys;
  std::vector<int64_t> vals;
  size_t mask;

  explicit FlatMap(size_t capacity) {
    size_t size = 16;
    while (size < capacity * 2) size <<= 1;
    keys.assign(size, -1);
    vals.assign(size, 0);
    mask = size - 1;
  }

  static inline size_t hash(int64_t k) {
    uint64_t x = (uint64_t)k;
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
    return (size_t)x;
  }

  // returns value; inserts with `next` if absent (sets *inserted)
  inline int64_t get_or_insert(int64_t k, int64_t next, bool* inserted) {
    size_t i = hash(k) & mask;
    while (true) {
      if (keys[i] == k) { *inserted = false; return vals[i]; }
      if (keys[i] < 0) {
        keys[i] = k; vals[i] = next; *inserted = true; return next;
      }
      i = (i + 1) & mask;
    }
  }

  inline bool contains(int64_t k) const {
    size_t i = hash(k) & mask;
    while (true) {
      if (keys[i] == k) return true;
      if (keys[i] < 0) return false;
      i = (i + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Multi-hop uniform neighbor sampling over CSC (in-edges, dst-sorted).
//
// colptr [n+1], row [E] (source of each in-edge), eid [E] (original edge
// position). seeds [num_seeds]. fanouts [num_hops].
// Outputs (capacities computed by the caller from the fanout budget):
//   node_out [n_cap], node_mask [n_cap]
//   row_out/col_out [e_cap] (LOCAL ids; dump = n_cap), eid_out [e_cap],
//   edge_mask [e_cap]
//   num_sampled_nodes [num_hops+1], num_sampled_edges [num_hops]
// Returns the number of sampled nodes.
int64_t neighbor_sample(
    const int64_t* colptr, const int64_t* row, const int64_t* eid,
    int64_t num_nodes,
    const int64_t* seeds, int64_t num_seeds,
    const int64_t* fanouts, int64_t num_hops,
    const int64_t* edge_caps,   // per-hop edge capacity
    int64_t n_cap, int64_t e_cap,
    int replace, uint64_t seed,
    int64_t* node_out, uint8_t* node_mask,
    int64_t* row_out, int64_t* col_out, int64_t* eid_out,
    uint8_t* edge_mask,
    int64_t* num_sampled_nodes, int64_t* num_sampled_edges) {
  std::mt19937_64 rng(seed);
  FlatMap local((size_t)n_cap);
  std::vector<int64_t> nodes;
  nodes.reserve(n_cap);

  for (int64_t i = 0; i < num_seeds; ++i) {
    bool ins;
    local.get_or_insert(seeds[i], (int64_t)nodes.size(), &ins);
    if (ins) nodes.push_back(seeds[i]);
  }
  num_sampled_nodes[0] = (int64_t)nodes.size();

  for (int64_t k = 0; k < e_cap; ++k) {
    row_out[k] = n_cap;
    col_out[k] = n_cap;
    eid_out[k] = 0;
    edge_mask[k] = 0;
  }

  std::vector<int64_t> frontier(nodes);
  std::vector<int64_t> scratch;
  int64_t e_cursor = 0;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    const int64_t fanout = fanouts[hop];
    std::vector<int64_t> next_frontier;
    int64_t new_nodes = 0, hop_edges = 0;
    const int64_t base = e_cursor;
    for (int64_t fi = 0; fi < (int64_t)frontier.size(); ++fi) {
      const int64_t v = frontier[fi];
      bool dummy;
      const int64_t dst_local = local.get_or_insert(v, -1, &dummy);
      const int64_t lo = colptr[v], hi = colptr[v + 1];
      const int64_t deg = hi - lo;
      if (deg == 0) continue;
      auto emit = [&](int64_t pos) {
        const int64_t g = row[pos];
        if ((int64_t)nodes.size() >= n_cap && !local.contains(g)) {
          return;  // node budget exhausted
        }
        bool ins;
        const int64_t gl = local.get_or_insert(
            g, (int64_t)nodes.size(), &ins);
        if (ins) {
          nodes.push_back(g);
          next_frontier.push_back(g);
          ++new_nodes;
        }
        const int64_t slot = base + hop_edges;
        if (slot >= e_cap) return;
        row_out[slot] = gl;
        col_out[slot] = dst_local;
        eid_out[slot] = eid[pos];
        edge_mask[slot] = 1;
        ++hop_edges;
      };
      if (deg <= fanout && !replace) {
        for (int64_t p = lo; p < hi; ++p) emit(p);
      } else if (replace) {
        std::uniform_int_distribution<int64_t> d(0, deg - 1);
        for (int64_t s = 0; s < fanout; ++s) emit(lo + d(rng));
      } else {
        // exact without replacement: partial Fisher-Yates on offsets
        scratch.resize(deg);
        for (int64_t j = 0; j < deg; ++j) scratch[j] = j;
        for (int64_t s = 0; s < fanout; ++s) {
          std::uniform_int_distribution<int64_t> d(s, deg - 1);
          std::swap(scratch[s], scratch[d(rng)]);
          emit(lo + scratch[s]);
        }
      }
    }
    num_sampled_nodes[hop + 1] = new_nodes;
    num_sampled_edges[hop] = hop_edges;
    e_cursor += edge_caps[hop];
    frontier.swap(next_frontier);
  }

  for (int64_t i = 0; i < n_cap; ++i) {
    if (i < (int64_t)nodes.size()) {
      node_out[i] = nodes[i];
      node_mask[i] = 1;
    } else {
      node_out[i] = 0;
      node_mask[i] = 0;
    }
  }
  return (int64_t)nodes.size();
}

// Heterogeneous multi-hop neighbor sampling (reference
// torch.ops.pyg.hetero_neighbor_sample, neighbor_sampler.py:471).
//
// T node types, R edge types. Per edge type r: CSC arrays
// colptrs[r] [n_dst+1], rows[r], eids[r], endpoints src_type[r] /
// dst_type[r]. Every hop, each edge type samples `fanouts[hop]`
// in-neighbors of its dst-type frontier. Outputs are per-type padded
// buffers (same layout as the Python sampler): node_out[t] [n_caps[t]],
// row/col are LOCAL ids (-1 padding), nsn [T*(H+1)], nse [R*H].
int64_t hetero_neighbor_sample(
    int64_t num_types, int64_t num_etypes,
    const int64_t** colptrs, const int64_t** rows, const int64_t** eids,
    const int64_t* src_type, const int64_t* dst_type,
    int64_t input_type, const int64_t* seeds, int64_t num_seeds,
    const int64_t* fanouts, int64_t num_hops,
    const int64_t* n_caps,      // [T]
    const int64_t* ecap_hop,    // [R * H] per-hop edge capacities
    int replace, uint64_t seed,
    int64_t** node_out, uint8_t** node_mask,
    int64_t** row_out, int64_t** col_out, int64_t** eid_out,
    uint8_t** edge_mask,
    int64_t* nsn, int64_t* nse) {
  std::mt19937_64 rng(seed);
  std::vector<FlatMap> local;
  local.reserve(num_types);
  std::vector<std::vector<int64_t>> nodes(num_types);
  for (int64_t t = 0; t < num_types; ++t) {
    local.emplace_back((size_t)n_caps[t]);
    nodes[t].reserve(n_caps[t]);
  }

  for (int64_t i = 0; i < num_seeds; ++i) {
    bool ins;
    local[input_type].get_or_insert(
        seeds[i], (int64_t)nodes[input_type].size(), &ins);
    if (ins) nodes[input_type].push_back(seeds[i]);
  }
  for (int64_t t = 0; t < num_types; ++t)
    nsn[t * (num_hops + 1)] = (int64_t)nodes[t].size();

  std::vector<int64_t> e_caps(num_etypes, 0);
  for (int64_t r = 0; r < num_etypes; ++r) {
    for (int64_t h = 0; h < num_hops; ++h)
      e_caps[r] += ecap_hop[r * num_hops + h];
    for (int64_t k = 0; k < e_caps[r]; ++k) {
      row_out[r][k] = -1;
      col_out[r][k] = -1;
      eid_out[r][k] = 0;
      edge_mask[r][k] = 0;
    }
  }

  std::vector<std::vector<int64_t>> frontier(num_types);
  frontier[input_type] = nodes[input_type];
  std::vector<int64_t> cursor(num_etypes, 0);
  std::vector<int64_t> scratch;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    const int64_t fanout = fanouts[hop];
    std::vector<std::vector<int64_t>> next_frontier(num_types);
    std::vector<int64_t> new_counts(num_types, 0);
    for (int64_t r = 0; r < num_etypes; ++r) {
      const int64_t st = src_type[r], dt = dst_type[r];
      const int64_t* colptr = colptrs[r];
      const int64_t* rowv = rows[r];
      const int64_t* eidv = eids[r];
      const int64_t base = cursor[r];
      int64_t hop_edges = 0;
      for (int64_t fi = 0; fi < (int64_t)frontier[dt].size(); ++fi) {
        const int64_t v = frontier[dt][fi];
        bool dummy;
        const int64_t dst_local = local[dt].get_or_insert(v, -1, &dummy);
        const int64_t lo = colptr[v], hi = colptr[v + 1];
        const int64_t deg = hi - lo;
        if (deg == 0) continue;
        auto emit = [&](int64_t pos) {
          const int64_t g = rowv[pos];
          if ((int64_t)nodes[st].size() >= n_caps[st] &&
              !local[st].contains(g)) {
            return;
          }
          bool ins;
          const int64_t gl = local[st].get_or_insert(
              g, (int64_t)nodes[st].size(), &ins);
          if (ins) {
            nodes[st].push_back(g);
            next_frontier[st].push_back(g);
            ++new_counts[st];
          }
          const int64_t slot = base + hop_edges;
          if (slot >= base + ecap_hop[r * num_hops + hop]) return;
          row_out[r][slot] = gl;
          col_out[r][slot] = dst_local;
          eid_out[r][slot] = eidv[pos];
          edge_mask[r][slot] = 1;
          ++hop_edges;
        };
        if (deg <= fanout && !replace) {
          for (int64_t p = lo; p < hi; ++p) emit(p);
        } else if (replace) {
          std::uniform_int_distribution<int64_t> d(0, deg - 1);
          for (int64_t s = 0; s < fanout; ++s) emit(lo + d(rng));
        } else {
          scratch.resize(deg);
          for (int64_t j = 0; j < deg; ++j) scratch[j] = j;
          for (int64_t s = 0; s < fanout; ++s) {
            std::uniform_int_distribution<int64_t> d(s, deg - 1);
            std::swap(scratch[s], scratch[d(rng)]);
            emit(lo + scratch[s]);
          }
        }
      }
      nse[r * num_hops + hop] = hop_edges;
      cursor[r] += ecap_hop[r * num_hops + hop];
    }
    for (int64_t t = 0; t < num_types; ++t)
      nsn[t * (num_hops + 1) + hop + 1] = new_counts[t];
    frontier.swap(next_frontier);
  }

  int64_t total = 0;
  for (int64_t t = 0; t < num_types; ++t) {
    for (int64_t i = 0; i < n_caps[t]; ++i) {
      if (i < (int64_t)nodes[t].size()) {
        node_out[t][i] = nodes[t][i];
        node_mask[t][i] = 1;
      } else {
        node_out[t][i] = 0;
        node_mask[t][i] = 0;
      }
    }
    total += (int64_t)nodes[t].size();
  }
  return total;
}

// Temporal / weighted / disjoint multi-hop neighbor sampling.
//
// The reference's pyg-lib sampler grows these options in one kernel
// (torch_geometric/sampler/neighbor_sampler.py:428: node/edge `time`
// with 'uniform'|'last' strategies, per-edge `weight` biasing, and
// `disjoint` per-seed subtrees). Semantics matched:
//   * a candidate in-edge (u -> v, id e) expanding a node in seed b's
//     subtree is admissible iff node_time[u] <= seed_time[b] (node
//     level) or edge_time[e] <= seed_time[b] (edge level);
//   * 'last' (temporal_strategy=1) keeps the `fanout` most recent
//     admissible edges (deterministic); 'uniform' draws uniformly;
//   * edge_weight biases draws (Efraimidis–Spirakis keys without
//     replacement, CDF inversion with);
//   * disjoint relabels per (seed, node): batch_out gives each local
//     node's seed index (always written; zeros when not disjoint).
int64_t neighbor_sample_tw(
    const int64_t* colptr, const int64_t* row, const int64_t* eid,
    int64_t num_nodes,
    const int64_t* seeds, int64_t num_seeds,
    const double* seed_time,                   // nullable
    const int64_t* fanouts, int64_t num_hops,
    const int64_t* edge_caps, int64_t n_cap, int64_t e_cap,
    int replace, int disjoint, int temporal_strategy,
    const double* node_time,                   // nullable
    const double* edge_time,                   // nullable
    const double* edge_weight,                 // nullable
    uint64_t seed,
    int64_t* node_out, int64_t* batch_out, uint8_t* node_mask,
    int64_t* row_out, int64_t* col_out, int64_t* eid_out,
    uint8_t* edge_mask,
    int64_t* num_sampled_nodes, int64_t* num_sampled_edges) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  const bool temporal = (node_time != nullptr) || (edge_time != nullptr);
  FlatMap local((size_t)n_cap);
  std::vector<int64_t> nodes, batches;
  nodes.reserve(n_cap);
  batches.reserve(n_cap);

  auto key_of = [&](int64_t g, int64_t b) {
    return disjoint ? b * num_nodes + g : g;
  };

  for (int64_t i = 0; i < num_seeds; ++i) {
    bool ins;
    local.get_or_insert(key_of(seeds[i], i), (int64_t)nodes.size(), &ins);
    if (ins) {
      nodes.push_back(seeds[i]);
      batches.push_back(disjoint ? i : 0);
    }
  }
  num_sampled_nodes[0] = (int64_t)nodes.size();

  for (int64_t k = 0; k < e_cap; ++k) {
    row_out[k] = n_cap;
    col_out[k] = n_cap;
    eid_out[k] = 0;
    edge_mask[k] = 0;
  }

  struct Ent { int64_t g; int64_t b; };
  std::vector<Ent> frontier;
  for (size_t i = 0; i < nodes.size(); ++i)
    frontier.push_back({nodes[i], batches[i]});

  std::vector<int64_t> cand;
  std::vector<std::pair<double, int64_t>> keyed;
  int64_t e_cursor = 0;
  for (int64_t hop = 0; hop < num_hops; ++hop) {
    const int64_t fanout = fanouts[hop];
    std::vector<Ent> next_frontier;
    int64_t new_nodes = 0, hop_edges = 0;
    const int64_t base = e_cursor;
    for (const Ent& ent : frontier) {
      const int64_t v = ent.g, b = ent.b;
      bool dummy;
      const int64_t dst_local = local.get_or_insert(
          key_of(v, b), -1, &dummy);
      const int64_t lo = colptr[v], hi = colptr[v + 1];
      if (hi == lo) continue;
      const double t_max = temporal
          ? (seed_time ? seed_time[b]
                       : (node_time ? node_time[v] : 0.0))
          : 0.0;
      cand.clear();
      for (int64_t p = lo; p < hi; ++p) {
        if (temporal) {
          const double t = node_time ? node_time[row[p]]
                                     : edge_time[eid[p]];
          if (t > t_max) continue;
        }
        cand.push_back(p);
      }
      const int64_t deg = (int64_t)cand.size();
      if (deg == 0) continue;
      auto emit = [&](int64_t pos) {
        const int64_t g = row[pos];
        const int64_t key = key_of(g, b);
        if ((int64_t)nodes.size() >= n_cap && !local.contains(key)) {
          return;
        }
        bool ins;
        const int64_t gl = local.get_or_insert(
            key, (int64_t)nodes.size(), &ins);
        if (ins) {
          nodes.push_back(g);
          batches.push_back(disjoint ? b : 0);
          next_frontier.push_back({g, b});
          ++new_nodes;
        }
        const int64_t slot = base + hop_edges;
        if (slot >= e_cap) return;
        row_out[slot] = gl;
        col_out[slot] = dst_local;
        eid_out[slot] = eid[pos];
        edge_mask[slot] = 1;
        ++hop_edges;
      };
      if (temporal && temporal_strategy == 1) {
        // 'last': fanout most recent admissible edges
        keyed.clear();
        for (int64_t p : cand) {
          const double t = node_time ? node_time[row[p]]
                                     : edge_time[eid[p]];
          keyed.push_back({t, p});
        }
        const int64_t take = deg < fanout ? deg : fanout;
        std::partial_sort(keyed.begin(), keyed.begin() + take,
                          keyed.end(),
                          [](const auto& a, const auto& c) {
                            return a.first > c.first;
                          });
        for (int64_t s = 0; s < take; ++s) emit(keyed[s].second);
      } else if (edge_weight != nullptr) {
        if (replace) {
          double total = 0.0;
          for (int64_t p : cand) total += edge_weight[eid[p]];
          if (total <= 0.0) continue;
          for (int64_t s = 0; s < fanout; ++s) {
            double u = unif(rng) * total, acc = 0.0;
            int64_t pick = cand.back();
            for (int64_t p : cand) {
              acc += edge_weight[eid[p]];
              if (acc >= u) { pick = p; break; }
            }
            emit(pick);
          }
        } else if (deg <= fanout) {
          for (int64_t p : cand) emit(p);
        } else {
          // Efraimidis–Spirakis: top-fanout by log(u)/w
          keyed.clear();
          for (int64_t p : cand) {
            const double w = edge_weight[eid[p]];
            if (w <= 0.0) continue;
            keyed.push_back({std::log(unif(rng)) / w, p});
          }
          const int64_t take =
              (int64_t)keyed.size() < fanout ? (int64_t)keyed.size()
                                             : fanout;
          std::partial_sort(keyed.begin(), keyed.begin() + take,
                            keyed.end(),
                            [](const auto& a, const auto& c) {
                              return a.first > c.first;
                            });
          for (int64_t s = 0; s < take; ++s) emit(keyed[s].second);
        }
      } else if (deg <= fanout && !replace) {
        for (int64_t p : cand) emit(p);
      } else if (replace) {
        std::uniform_int_distribution<int64_t> d(0, deg - 1);
        for (int64_t s = 0; s < fanout; ++s) emit(cand[d(rng)]);
      } else {
        for (int64_t s = 0; s < fanout; ++s) {
          std::uniform_int_distribution<int64_t> d(s, deg - 1);
          std::swap(cand[s], cand[d(rng)]);
          emit(cand[s]);
        }
      }
    }
    num_sampled_nodes[hop + 1] = new_nodes;
    num_sampled_edges[hop] = hop_edges;
    e_cursor += edge_caps[hop];
    frontier.swap(next_frontier);
  }

  for (int64_t i = 0; i < n_cap; ++i) {
    if (i < (int64_t)nodes.size()) {
      node_out[i] = nodes[i];
      batch_out[i] = batches[i];
      node_mask[i] = 1;
    } else {
      node_out[i] = 0;
      batch_out[i] = 0;
      node_mask[i] = 0;
    }
  }
  return (int64_t)nodes.size();
}

// node2vec-style random walks over CSR (out-edges).
// rowptr [n+1], col [E]. start [s]. out [s * (walk_length+1)].
void random_walk(const int64_t* rowptr, const int64_t* col,
                 int64_t num_nodes, const int64_t* start, int64_t s,
                 int64_t walk_length, double p, double q, uint64_t seed,
                 int64_t* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  for (int64_t i = 0; i < s; ++i) {
    int64_t cur = start[i], prev = start[i];
    out[i * (walk_length + 1)] = cur;
    for (int64_t t = 1; t <= walk_length; ++t) {
      const int64_t lo = rowptr[cur], deg = rowptr[cur + 1] - lo;
      int64_t nxt = cur;
      if (deg > 0) {
        std::uniform_int_distribution<int64_t> d(0, deg - 1);
        nxt = col[lo + d(rng)];
        if (p != 1.0 || q != 1.0) {
          for (int attempt = 0; attempt < 3; ++attempt) {
            const double accept = (nxt == prev) ? 1.0 / p : 1.0 / q;
            if (unif(rng) <= accept) break;
            nxt = col[lo + d(rng)];
          }
        }
      }
      prev = cur;
      cur = nxt;
      out[i * (walk_length + 1) + t] = cur;
    }
  }
}

}  // extern "C"
