// String-graph construction + classification passes in C++.
//
// Semantics mirror graph/string_graph.py exactly (which remains the
// Python oracle; byte-equality of the emitted sg_edges_list is asserted
// in tests/test_graph.py) — itself a faithful re-expression of the
// reference ovlp_to_graph.py:63-908.  The Python passes walk dict-of-list
// adjacency with string node names ("%09d:B") and cost ~50 s at 250 Mb
// scale; here nodes are integer codes (rid*2 + end) over vector
// adjacency, and every iteration order the output depends on is
// reproduced:
//   * node order = first-touch order during edge insertion (Python dict
//     insertion order of out_edges, v before w per edge)
//   * edge order = insertion order (dict order of sg.edges)
//   * out-adjacency lists are stable-sorted by edge length once before
//     transitive reduction (the Python one-time sort), in-adjacency keeps
//     insertion order
//   * mark_chimer_edges' BFS pops the most recently inserted candidate
//     (Python dict popitem), one pop per depth step
//   * classification precedence G > C > R > S > TR via set membership,
//     including reverse edges added to the cause sets unconditionally
//     when their partner is newly reduced
//
// Entry point sg_build_c consumes parse_ovl rows directly (the contained
// filter, first-occurrence rid-pair dedup, and 4-geometry edge emission
// of _edges_from_rows) and returns edge arrays + per-edge class codes +
// the fully formatted sg_edges_list bytes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

#pragma pack(push, 1)
struct OvlRow {
  int32_t f_id, g_id, score;
  float idt;
  int32_t f_b, f_e, f_l;
  int32_t g_s, g_b, g_e, g_l;
};
#pragma pack(pop)

struct Graph {
  // edges in insertion order
  std::vector<int64_t> ev, ew;            // node codes rid*2+end
  std::vector<int64_t> lrid, ls, lt;      // label (rid, begin, end)
  std::vector<int64_t> elen, escore;
  std::vector<float> eidt;
  // nodes in first-touch order
  std::vector<int64_t> nodes;             // code per dense id
  std::unordered_map<int64_t, int32_t> node_id;
  std::vector<std::vector<int32_t>> out_adj, in_adj;  // edge indices
  std::unordered_map<uint64_t, int32_t> edge_map;     // (v<<32|w) -> idx
  std::vector<uint8_t> reduced;
  std::vector<uint8_t> in_chimer, in_removed, in_spur;

  static uint64_t ekey(int64_t v, int64_t w) {
    return ((uint64_t)v << 32) | (uint64_t)w;
  }

  int32_t touch(int64_t code) {
    auto it = node_id.find(code);
    if (it != node_id.end()) return it->second;
    int32_t id = (int32_t)nodes.size();
    node_id.emplace(code, id);
    nodes.push_back(code);
    out_adj.emplace_back();
    in_adj.emplace_back();
    return id;
  }

  void add_edge(int64_t v, int64_t w, int64_t lr, int64_t s, int64_t t,
                int64_t score, float idt) {
    const uint64_t k = ekey(v, w);
    auto it = edge_map.find(k);
    if (it == edge_map.end()) {
      const int32_t idx = (int32_t)ev.size();
      edge_map.emplace(k, idx);
      const int32_t vi = touch(v), wi = touch(w);
      out_adj[vi].push_back(idx);
      in_adj[wi].push_back(idx);
      ev.push_back(v);
      ew.push_back(w);
      lrid.push_back(lr);
      ls.push_back(s);
      lt.push_back(t);
      elen.push_back(s > t ? s - t : t - s);
      escore.push_back(score);
      eidt.push_back(idt);
    } else {
      // overwrite value, keep position (Python dict semantics)
      const int32_t idx = it->second;
      lrid[idx] = lr;
      ls[idx] = s;
      lt[idx] = t;
      elen[idx] = s > t ? s - t : t - s;
      escore[idx] = score;
      eidt[idx] = idt;
    }
  }

  int32_t find_edge(int64_t v, int64_t w) const {
    auto it = edge_map.find(ekey(v, w));
    return it == edge_map.end() ? -1 : it->second;
  }

  // set e_reduce for the reverse edge if it exists (marks for
  // non-existent edges are never read back)
  void reduce_reverse(int32_t e, std::vector<uint8_t> *cause) {
    const int32_t r = find_edge(ew[e] ^ 1, ev[e] ^ 1);
    if (r >= 0) {
      reduced[r] = 1;
      if (cause) (*cause)[r] = 1;
    }
  }

  int live_out_count(int32_t vi) const {
    int c = 0;
    for (int32_t e : out_adj[vi])
      if (!reduced[e]) c++;
    return c;
  }
  int live_in_count(int32_t vi) const {
    int c = 0;
    for (int32_t e : in_adj[vi])
      if (!reduced[e]) c++;
    return c;
  }
};

// --- transitive reduction (string_graph.py mark_tr_edges) --------------
void mark_tr_edges(Graph &g, int64_t fuzz) {
  const size_t nn = g.nodes.size();
  // one-time stable sort of every out list by edge length
  for (auto &oes : g.out_adj)
    if (oes.size() > 1)
      std::stable_sort(oes.begin(), oes.end(), [&](int32_t a, int32_t b) {
        return g.elen[a] < g.elen[b];
      });

  std::vector<uint8_t> mark(nn, 0);  // 0 vacant / 1 inplay / 2 eliminated
  for (size_t vi = 0; vi < nn; vi++) {
    const auto &oes = g.out_adj[vi];
    if (oes.empty()) continue;
    for (int32_t e : oes) mark[g.node_id.at(g.ew[e])] = 1;
    const int64_t max_len = g.elen[oes.back()] + fuzz;

    for (int32_t e : oes) {
      const int64_t e_len = g.elen[e];
      const int32_t wi = g.node_id.at(g.ew[e]);
      if (mark[wi] == 1) {
        for (int32_t e2 : g.out_adj[wi]) {
          if (g.elen[e2] + e_len < max_len) {
            const int32_t xi = g.node_id.at(g.ew[e2]);
            if (mark[xi] == 1) mark[xi] = 2;
          }
        }
      }
    }
    for (int32_t e : oes) {
      const int32_t wi = g.node_id.at(g.ew[e]);
      const auto &w_oes = g.out_adj[wi];
      if (!w_oes.empty()) {
        const int32_t xi = g.node_id.at(g.ew[w_oes[0]]);
        if (mark[xi] == 1) mark[xi] = 2;
      }
      for (int32_t e2 : w_oes) {
        if (g.elen[e2] < fuzz) {
          const int32_t xi = g.node_id.at(g.ew[e2]);
          if (mark[xi] == 1) mark[xi] = 2;
        }
      }
    }
    for (int32_t e : oes) {
      const int32_t wi = g.node_id.at(g.ew[e]);
      if (mark[wi] == 2) {
        g.reduced[e] = 1;
        g.reduce_reverse(e, nullptr);
      }
      mark[wi] = 0;
    }
  }
}

// --- chimer removal (string_graph.py mark_chimer_edges) ----------------
void bfs_nodes(const Graph &g, int64_t n, int64_t exclude, int depth,
               std::unordered_set<int64_t> &out) {
  out.clear();
  out.insert(n);
  std::vector<int64_t> stack{n};  // ordered-dict popitem == LIFO
  int dp = 1;
  while (dp < depth && !stack.empty()) {
    const int64_t v = stack.back();
    stack.pop_back();
    auto it = g.node_id.find(v);
    if (it != g.node_id.end()) {
      for (int32_t e : g.out_adj[it->second]) {
        const int64_t w = g.ew[e];
        if (w == exclude || out.count(w)) continue;
        out.insert(w);
        auto wi = g.node_id.find(w);
        if (wi != g.node_id.end() && !g.out_adj[wi->second].empty())
          stack.push_back(w);
      }
    }
    dp++;
  }
}

void mark_chimer_edges(Graph &g, std::vector<int64_t> &chimer_nodes) {
  const size_t nn = g.nodes.size();
  // multi-out/in membership (live degree >= 2), node order
  std::vector<int64_t> out_set;  // insertion-ordered
  std::unordered_set<int64_t> out_seen, in_set;
  for (size_t vi = 0; vi < nn; vi++) {
    if (g.live_out_count((int32_t)vi) >= 2)
      for (int32_t e : g.out_adj[vi]) {
        if (g.reduced[e]) continue;
        if (out_seen.insert(g.ew[e]).second) out_set.push_back(g.ew[e]);
      }
    if (g.live_in_count((int32_t)vi) >= 2)
      for (int32_t e : g.in_adj[vi])
        if (!g.reduced[e]) in_set.insert(g.ev[e]);
  }

  std::unordered_set<int64_t> out_nodes, test_set, flow1, flow2, bfs;
  for (int64_t n : out_set) {
    if (!in_set.count(n)) continue;
    auto nit = g.node_id.find(n);
    if (nit == g.node_id.end()) continue;
    const int32_t ni = nit->second;

    out_nodes.clear();
    for (int32_t e : g.out_adj[ni]) out_nodes.insert(g.ew[e]);
    test_set.clear();
    for (int32_t e : g.in_adj[ni]) {
      const int64_t in_node = g.ev[e];
      auto iit = g.node_id.find(in_node);
      if (iit == g.node_id.end()) continue;
      for (int32_t e2 : g.out_adj[iit->second]) test_set.insert(g.ew[e2]);
    }
    test_set.erase(n);
    bool inter = false;
    for (int64_t v : out_nodes)
      if (test_set.count(v)) {
        inter = true;
        break;
      }
    if (inter) continue;

    flow1.clear();
    for (int64_t v : out_nodes) {
      bfs_nodes(g, v, n, 5, bfs);
      flow1.insert(bfs.begin(), bfs.end());
    }
    flow2.clear();
    for (int64_t v : test_set) {
      bfs_nodes(g, v, n, 5, bfs);
      flow2.insert(bfs.begin(), bfs.end());
    }
    inter = false;
    for (int64_t v : flow1)
      if (flow2.count(v)) {
        inter = true;
        break;
      }
    if (inter) continue;

    // reduce all edges touching n; record cause
    auto handle = [&](int32_t e) {
      if (!g.reduced[e]) {
        g.reduced[e] = 1;
        g.in_chimer[e] = 1;
        g.reduce_reverse(e, &g.in_chimer);
      }
    };
    for (int32_t e : g.out_adj[ni]) handle(e);
    for (int32_t e : g.in_adj[ni]) handle(e);
    chimer_nodes.push_back(n);
    chimer_nodes.push_back(n ^ 1);
  }
}

// --- spur removal (string_graph.py mark_spur_edge) ---------------------
void mark_spur_edge(Graph &g) {
  const size_t nn = g.nodes.size();
  for (size_t vi = 0; vi < nn; vi++) {
    if (g.live_out_count((int32_t)vi) > 1) {
      for (int32_t e : g.out_adj[vi]) {
        const int64_t w = g.ew[e];
        auto wi = g.node_id.find(w);
        const bool w_no_out =
            (wi == g.node_id.end()) || g.out_adj[wi->second].empty();
        if (w_no_out && !g.reduced[e]) {
          g.reduced[e] = 1;
          g.in_spur[e] = 1;
          g.reduce_reverse(e, &g.in_spur);
        }
      }
    }
    if (g.live_in_count((int32_t)vi) > 1) {
      for (int32_t e : g.in_adj[vi]) {
        const int64_t w = g.ev[e];
        auto wi = g.node_id.find(w);
        const bool w_no_in =
            (wi == g.node_id.end()) || g.in_adj[wi->second].empty();
        if (w_no_in && !g.reduced[e]) {
          g.reduced[e] = 1;
          g.in_spur[e] = 1;
          g.reduce_reverse(e, &g.in_spur);
        }
      }
    }
  }
}

// --- best-overlap knot resolution (string_graph.py mark_best_overlap) --
void mark_best_overlap(Graph &g, std::vector<int64_t> &best_in_nodes) {
  const size_t nn = g.nodes.size();
  std::vector<uint8_t> best(g.ev.size(), 0);
  std::vector<uint8_t> has_best_in(nn, 0);
  std::vector<int32_t> tmp;
  for (size_t vi = 0; vi < nn; vi++) {
    tmp = g.out_adj[vi];
    std::stable_sort(tmp.begin(), tmp.end(), [&](int32_t a, int32_t b) {
      return g.escore[a] > g.escore[b];
    });
    for (int32_t e : tmp)
      if (!g.reduced[e]) {
        best[e] = 1;
        break;
      }
    tmp = g.in_adj[vi];
    std::stable_sort(tmp.begin(), tmp.end(), [&](int32_t a, int32_t b) {
      return g.escore[a] > g.escore[b];
    });
    for (int32_t e : tmp)
      if (!g.reduced[e]) {
        best[e] = 1;
        has_best_in[vi] = 1;
        break;
      }
  }
  for (size_t vi = 0; vi < nn; vi++)
    if (has_best_in[vi]) best_in_nodes.push_back(g.nodes[vi]);
  const size_t ne = g.ev.size();
  for (size_t e = 0; e < ne; e++) {
    if (!g.reduced[e] && !best[e]) {
      g.reduced[e] = 1;
      g.in_removed[e] = 1;
      g.reduce_reverse((int32_t)e, &g.in_removed);
    }
  }
}

// --- local-flow-consistency (string_graph.py resolve_repeat_edges) -----
void resolve_repeat_edges(Graph &g) {
  const size_t nn = g.nodes.size();
  std::unordered_set<int64_t> test_nodes;
  std::vector<int64_t> test_order;
  for (size_t vi = 0; vi < nn; vi++)
    if (g.live_out_count((int32_t)vi) == 1 && g.live_in_count((int32_t)vi) == 1) {
      test_nodes.insert(g.nodes[vi]);
      test_order.push_back(g.nodes[vi]);
    }

  std::vector<int32_t> to_reduce;
  std::unordered_set<int64_t> set_a, set_b;
  for (int64_t v_n : test_order) {
    const int32_t vni = g.node_id.at(v_n);
    int64_t out_node = 0, in_node = 0;
    for (int32_t e : g.out_adj[vni])
      if (!g.reduced[e]) {
        out_node = g.ew[e];
        break;
      }
    for (int32_t e : g.in_adj[vni])
      if (!g.reduced[e]) {
        in_node = g.ev[e];
        break;
      }

    auto iit = g.node_id.find(in_node);
    if (iit != g.node_id.end()) {
      for (int32_t e : g.out_adj[iit->second]) {
        const int64_t ww = g.ew[e];
        if (ww == v_n || g.reduced[e]) continue;
        auto wit = g.node_id.find(ww);
        const int32_t wwi = wit->second;
        if (g.live_in_count(wwi) <= 1 || test_nodes.count(ww)) continue;
        set_a.clear();
        for (int32_t e2 : g.out_adj[wwi]) set_a.insert(g.ew[e2]);
        bool inter = false;
        for (int32_t e2 : g.out_adj[vni])
          if (set_a.count(g.ew[e2])) {
            inter = true;
            break;
          }
        if (!inter) to_reduce.push_back(e);
      }
    }
    auto oit = g.node_id.find(out_node);
    if (oit != g.node_id.end()) {
      for (int32_t e : g.in_adj[oit->second]) {
        const int64_t vv = g.ev[e];
        if (vv == v_n || g.reduced[e]) continue;
        auto vit = g.node_id.find(vv);
        const int32_t vvi = vit->second;
        if (g.live_out_count(vvi) <= 1 || test_nodes.count(vv)) continue;
        set_b.clear();
        for (int32_t e2 : g.in_adj[vvi]) set_b.insert(g.ev[e2]);
        bool inter = false;
        for (int32_t e2 : g.in_adj[vni])
          if (set_b.count(g.ev[e2])) {
            inter = true;
            break;
          }
        if (!inter) to_reduce.push_back(e);
      }
    }
  }
  for (int32_t e : to_reduce) {
    g.reduced[e] = 1;
    g.in_removed[e] = 1;
  }
}

template <class T>
T *vec_out(const std::vector<T> &v) {
  T *p = (T *)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(T));
  std::memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

}  // namespace

extern "C" {

// Returns 0 on success.  All output arrays are malloc'd; release with
// sg_free_c.  cls codes: 0=G 1=C 2=R 3=S 4=TR.
int sg_build_c(const void *rows_raw, int64_t n_rows, const int32_t *cont,
               int64_t n_cont, int32_t lfc, int32_t disable_chimer,
               int64_t fuzz,
               int64_t **ev_o, int64_t **ew_o, int64_t **lrid_o,
               int64_t **ls_o, int64_t **lt_o, int64_t **escore_o,
               float **eidt_o, uint8_t **cls_o, int64_t *n_edges_o,
               int64_t **chimer_o, int64_t *n_chimer_o,
               int64_t **best_in_o, int64_t *n_best_in_o,
               char **lines_o, int64_t *lines_len_o) {
  const OvlRow *rows = (const OvlRow *)rows_raw;
  Graph g;
  g.ev.reserve((size_t)n_rows);

  std::unordered_set<int32_t> cs(cont, cont + n_cont);
  std::unordered_set<uint64_t> seen_pairs;
  seen_pairs.reserve((size_t)n_rows);

  for (int64_t i = 0; i < n_rows; i++) {
    const OvlRow &r = rows[i];
    if (cs.count(r.f_id) || cs.count(r.g_id)) continue;
    const uint64_t key = r.f_id < r.g_id
                             ? (((uint64_t)r.f_id << 32) | (uint32_t)r.g_id)
                             : (((uint64_t)r.g_id << 32) | (uint32_t)r.f_id);
    if (!seen_pairs.insert(key).second) continue;

    const int64_t f_id = r.f_id, g_id = r.g_id;
    const int64_t f_b = r.f_b, f_e = r.f_e, f_l = r.f_l, g_l = r.g_l;
    const int64_t g_b = r.g_s == 1 ? r.g_e : r.g_b;
    const int64_t g_e = r.g_s == 1 ? r.g_b : r.g_e;
    const int64_t score = -(int64_t)r.score;
    const float idt = r.idt;

    // node codes: rid*2 + end (B=0, E=1)
    if (f_b > 0) {
      if (g_b < g_e) {
        if (f_b == 0 || g_e - g_l == 0) continue;
        g.add_edge(g_id * 2, f_id * 2, f_id, f_b, 0, score, idt);
        g.add_edge(f_id * 2 + 1, g_id * 2 + 1, g_id, g_e, g_l, score, idt);
      } else {
        if (f_b == 0 || g_e == 0) continue;
        g.add_edge(g_id * 2 + 1, f_id * 2, f_id, f_b, 0, score, idt);
        g.add_edge(f_id * 2 + 1, g_id * 2, g_id, g_e, 0, score, idt);
      }
    } else {
      if (g_b < g_e) {
        if (g_b == 0 || f_e - f_l == 0) continue;
        g.add_edge(f_id * 2, g_id * 2, g_id, g_b, 0, score, idt);
        g.add_edge(g_id * 2 + 1, f_id * 2 + 1, f_id, f_e, f_l, score, idt);
      } else {
        if (g_b - g_l == 0 || f_e - f_l == 0) continue;
        g.add_edge(f_id * 2, g_id * 2 + 1, g_id, g_b, g_l, score, idt);
        g.add_edge(g_id * 2, f_id * 2 + 1, f_id, f_e, f_l, score, idt);
      }
    }
  }

  const size_t ne = g.ev.size();
  g.reduced.assign(ne, 0);
  g.in_chimer.assign(ne, 0);
  g.in_removed.assign(ne, 0);
  g.in_spur.assign(ne, 0);

  mark_tr_edges(g, fuzz);
  std::vector<int64_t> chimer_nodes;
  if (!disable_chimer) mark_chimer_edges(g, chimer_nodes);
  mark_spur_edge(g);
  std::vector<int64_t> best_in_nodes;
  if (lfc)
    resolve_repeat_edges(g);
  else
    mark_best_overlap(g, best_in_nodes);
  mark_spur_edge(g);

  // classification (precedence G > C > R > S > TR) + line emission
  std::vector<uint8_t> cls(ne, 4);
  std::vector<char> lines;
  lines.reserve(ne * 48);
  char buf[160];
  for (size_t e = 0; e < ne; e++) {
    const char *type_;
    if (!g.reduced[e]) {
      cls[e] = 0;
      type_ = "G";
    } else if (g.in_chimer[e]) {
      cls[e] = 1;
      type_ = "C";
    } else if (g.in_removed[e]) {
      cls[e] = 2;
      type_ = "R";
    } else if (g.in_spur[e]) {
      cls[e] = 3;
      type_ = "S";
    } else {
      cls[e] = 4;
      type_ = "TR";
    }
    const int64_t v = g.ev[e], w = g.ew[e];
    const int n = snprintf(
        buf, sizeof buf, "%09lld:%c %09lld:%c %09lld %5lld %5lld %5lld %5.2f %s\n",
        (long long)(v >> 1), (v & 1) ? 'E' : 'B', (long long)(w >> 1),
        (w & 1) ? 'E' : 'B', (long long)g.lrid[e], (long long)g.ls[e],
        (long long)g.lt[e], (long long)g.escore[e], (double)g.eidt[e], type_);
    lines.insert(lines.end(), buf, buf + n);
  }

  *ev_o = vec_out(g.ev);
  *ew_o = vec_out(g.ew);
  *lrid_o = vec_out(g.lrid);
  *ls_o = vec_out(g.ls);
  *lt_o = vec_out(g.lt);
  *escore_o = vec_out(g.escore);
  *eidt_o = vec_out(g.eidt);
  *cls_o = vec_out(cls);
  *n_edges_o = (int64_t)ne;
  *chimer_o = vec_out(chimer_nodes);
  *n_chimer_o = (int64_t)chimer_nodes.size();
  *best_in_o = vec_out(best_in_nodes);
  *n_best_in_o = (int64_t)best_in_nodes.size();
  *lines_o = vec_out(lines);
  *lines_len_o = (int64_t)lines.size();
  return 0;
}

void sg_free_c(int64_t *ev, int64_t *ew, int64_t *lrid, int64_t *ls,
               int64_t *lt, int64_t *escore, float *eidt, uint8_t *cls,
               int64_t *chimer, int64_t *best_in, char *lines) {
  std::free(ev);
  std::free(ew);
  std::free(lrid);
  std::free(ls);
  std::free(lt);
  std::free(escore);
  std::free(eidt);
  std::free(cls);
  std::free(chimer);
  std::free(best_in);
  std::free(lines);
}

}  // extern "C"
