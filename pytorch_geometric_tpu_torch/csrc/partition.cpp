// Multilevel balanced edge-cut graph partitioner (C ABI, no deps), for
// the port's loader/cluster.py.
//
// A copy of pytorch_geometric_tpu/csrc/partition.cpp, unchanged below this
// comment and built with the same flags (-O3 -march=native), so the two
// packages' partitions of a graph agree bit for bit: the LDG scores are
// double-precision products whose rounding depends on the code generated.
// The native equivalent of the reference's METIS boundary
// (pyg_lib.partition.metis, reference loader/cluster.py:113): greedy
// heavy-edge-matching coarsening, LDG streaming partition of the
// coarsest graph, projected greedy boundary refinement per level.
// Tracks fine-node weights through coarsening so balance is measured in
// original nodes, not coarse clusters. The numpy fallback with the same
// pipeline lives in loader/cluster.py; this version exists because the
// matching/refinement loops are per-node and Python pays ~100x on
// million-node graphs.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <tuple>
#include <vector>

namespace {

struct Graph {
  int64_t n = 0;
  std::vector<int64_t> ptr, col;
  std::vector<double> w;    // edge weights
  std::vector<double> nw;   // node weights (fine-node mass)
};

// Greedy heavy-edge matching; returns coarse id per node and count.
int64_t match(const Graph& g, std::mt19937_64& rng,
              std::vector<int64_t>& cmap) {
  std::vector<int64_t> order(g.n), matched(g.n, -1);
  std::iota(order.begin(), order.end(), 0);
  std::shuffle(order.begin(), order.end(), rng);
  for (int64_t v : order) {
    if (matched[v] >= 0) continue;
    int64_t best = -1;
    double bw = -1.0;
    for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
      int64_t u = g.col[e];
      if (u == v || matched[u] >= 0) continue;
      if (g.w[e] > bw) { bw = g.w[e]; best = u; }
    }
    matched[v] = v;
    if (best >= 0) matched[best] = v;
  }
  std::vector<int64_t> newid(g.n, -1);
  int64_t nc = 0;
  cmap.resize(g.n);
  for (int64_t v = 0; v < g.n; ++v) {
    int64_t r = matched[v];
    if (newid[r] < 0) newid[r] = nc++;
    cmap[v] = newid[r];
  }
  return nc;
}

Graph coarsen(const Graph& g, const std::vector<int64_t>& cmap,
              int64_t nc) {
  // Counting-sort edges by coarse row (O(E)), then sort each row's
  // short column run — replaces the global O(E log E) tuple sort that
  // dominated partition time on multi-million-edge graphs.
  const size_t m = g.col.size();
  std::vector<int64_t> row_cnt(nc + 1, 0);
  std::vector<int64_t> crow(m), ccol(m);
  std::vector<double> cw(m);
  size_t kept = 0;
  for (int64_t v = 0; v < g.n; ++v) {
    int64_t a = cmap[v];
    for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e) {
      int64_t b = cmap[g.col[e]];
      if (a == b) continue;
      crow[kept] = a;
      ccol[kept] = b;
      cw[kept] = g.w[e];
      ++kept;
    }
  }
  for (size_t i = 0; i < kept; ++i) row_cnt[crow[i] + 1]++;
  for (int64_t v = 0; v < nc; ++v) row_cnt[v + 1] += row_cnt[v];
  std::vector<int64_t> order(kept);
  {
    std::vector<int64_t> cursor(row_cnt.begin(), row_cnt.end() - 1);
    for (size_t i = 0; i < kept; ++i) order[cursor[crow[i]]++] = i;
  }
  Graph c;
  c.n = nc;
  c.ptr.assign(nc + 1, 0);
  c.nw.assign(nc, 0.0);
  for (int64_t v = 0; v < g.n; ++v) c.nw[cmap[v]] += g.nw[v];
  c.col.reserve(kept);
  c.w.reserve(kept);
  std::vector<std::pair<int64_t, double>> runbuf;
  for (int64_t r = 0; r < nc; ++r) {
    int64_t lo = row_cnt[r], hi = row_cnt[r + 1];
    runbuf.clear();
    for (int64_t i = lo; i < hi; ++i) {
      size_t e = order[i];
      runbuf.emplace_back(ccol[e], cw[e]);
    }
    std::sort(runbuf.begin(), runbuf.end(),
              [](const auto& x, const auto& y) {
                return x.first < y.first;
              });
    for (size_t i = 0; i < runbuf.size();) {
      size_t j = i;
      double s = 0;
      while (j < runbuf.size() && runbuf[j].first == runbuf[i].first) {
        s += runbuf[j].second;
        ++j;
      }
      c.col.push_back(runbuf[i].first);
      c.w.push_back(s);
      c.ptr[r + 1]++;
      i = j;
    }
  }
  for (int64_t v = 0; v < nc; ++v) c.ptr[v + 1] += c.ptr[v];
  return c;
}

// LDG streaming pass(es): assign each node to the part maximising
// (connectivity to part) * (1 - load/cap), node-weight aware.
void ldg(const Graph& g, int64_t k, double cap, int passes,
         std::mt19937_64& rng, std::vector<int32_t>& parts) {
  std::vector<double> load(k, 0.0);
  for (int64_t v = 0; v < g.n; ++v) load[parts[v]] += g.nw[v];
  std::vector<int64_t> order(g.n);
  std::iota(order.begin(), order.end(), 0);
  std::vector<double> conn(k);
  for (int pass = 0; pass < passes; ++pass) {
    std::shuffle(order.begin(), order.end(), rng);
    for (int64_t v : order) {
      std::fill(conn.begin(), conn.end(), 0.0);
      for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e)
        conn[parts[g.col[e]]] += g.w[e];
      int32_t cur = parts[v];
      load[cur] -= g.nw[v];
      int32_t best = cur;
      double bs = -1e300;
      for (int32_t p = 0; p < k; ++p) {
        double penal = 1.0 - load[p] / cap;
        if (load[p] + g.nw[v] > cap) penal = -1.0;
        double s = (conn[p] + 1e-9) * penal;
        if (s > bs) { bs = s; best = p; }
      }
      parts[v] = best;
      load[best] += g.nw[v];
    }
  }
}

// Greedy boundary refinement: move positive-gain nodes to their
// best-connected part under the balance cap.
void refine(const Graph& g, int64_t k, double cap, int rounds,
            std::vector<int32_t>& parts) {
  std::vector<double> load(k, 0.0);
  for (int64_t v = 0; v < g.n; ++v) load[parts[v]] += g.nw[v];
  std::vector<double> conn(k);
  std::vector<std::pair<double, int64_t>> cand;
  std::vector<int32_t> target(g.n);
  for (int r = 0; r < rounds; ++r) {
    cand.clear();
    for (int64_t v = 0; v < g.n; ++v) {
      std::fill(conn.begin(), conn.end(), 0.0);
      for (int64_t e = g.ptr[v]; e < g.ptr[v + 1]; ++e)
        conn[parts[g.col[e]]] += g.w[e];
      int32_t cur = parts[v], best = cur;
      double bs = conn[cur];
      for (int32_t p = 0; p < k; ++p)
        if (conn[p] > bs) { bs = conn[p]; best = p; }
      if (best != cur && bs > conn[cur]) {
        cand.emplace_back(-(bs - conn[cur]), v);
        target[v] = best;
      }
    }
    if (cand.empty()) break;
    std::sort(cand.begin(), cand.end());
    int64_t moved = 0;
    for (auto& [negGain, v] : cand) {
      int32_t b = target[v], o = parts[v];
      if (load[b] + g.nw[v] <= cap && load[o] - g.nw[v] > 0) {
        load[o] -= g.nw[v];
        load[b] += g.nw[v];
        parts[v] = b;
        ++moved;
      }
    }
    if (!moved) break;
  }
}

}  // namespace

extern "C" void multilevel_partition(
    const int64_t* ptr, const int64_t* col, const double* w, int64_t n,
    int64_t num_parts, uint64_t seed, double imbalance,
    int32_t* parts_out) {
  std::mt19937_64 rng(seed);
  Graph g;
  g.n = n;
  g.ptr.assign(ptr, ptr + n + 1);
  g.col.assign(col, col + ptr[n]);
  g.w.assign(w, w + ptr[n]);
  g.nw.assign(n, 1.0);

  // coarsen
  std::vector<Graph> levels;
  std::vector<std::vector<int64_t>> cmaps;
  int64_t coarsest = std::max<int64_t>(64 * num_parts, 256);
  Graph* cur = &g;
  while (cur->n > coarsest && (int64_t)levels.size() < 30) {
    std::vector<int64_t> cmap;
    int64_t nc = match(*cur, rng, cmap);
    if (nc >= cur->n * 0.95) break;  // matching stalled
    Graph c = coarsen(*cur, cmap, nc);
    cmaps.push_back(std::move(cmap));
    levels.push_back(std::move(c));
    cur = &levels.back();
  }

  double total = (double)n;
  double cap = imbalance * total / (double)num_parts;

  // initial partition at the coarsest level
  std::vector<int32_t> parts(cur->n);
  std::uniform_int_distribution<int32_t> uni(0, (int32_t)num_parts - 1);
  for (auto& p : parts) p = uni(rng);
  ldg(*cur, num_parts, cap, 4, rng, parts);
  refine(*cur, num_parts, cap, 4, parts);

  // project back up
  for (int64_t li = (int64_t)levels.size() - 1; li >= 0; --li) {
    const Graph& fine = (li == 0) ? g : levels[li - 1];
    std::vector<int32_t> fparts(fine.n);
    for (int64_t v = 0; v < fine.n; ++v) fparts[v] = parts[cmaps[li][v]];
    parts = std::move(fparts);
    refine(fine, num_parts, cap, 4, parts);
  }
  // fine-level LDG polish (mirrors loader/cluster.py:_multilevel):
  // heavy-edge coarsening can obscure fine structure on small graphs —
  // one streaming pass + short refinement recovers it.
  if (!levels.empty() && n <= 200000) {
    ldg(g, num_parts, cap, 1, rng, parts);
    refine(g, num_parts, cap, 2, parts);
  }
  std::memcpy(parts_out, parts.data(), n * sizeof(int32_t));
}
