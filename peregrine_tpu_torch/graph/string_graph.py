"""String graph construction and edge classification (host phase).

Faithful re-implementation of the reference layout engine's first stage
(py/scripts/ovlp_to_graph.py:63-908): overlaps -> dual string-graph edges
(4 geometry cases) -> transitive reduction -> chimer / spur marking ->
best-overlap (or local-flow-consistency) knot resolution.

Where the reference iterates CPython sets (whose order depends on
PYTHONHASHSEED), this implementation uses insertion-ordered containers, so
results are deterministic run-to-run; the reference's own output is
hash-order dependent, and parity is judged at the contig/dnadiff level
(SURVEY.md §7.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .digraph import DiGraph


def reverse_end(name: str) -> str:
    """Flip a node between read ends: '000000012:B' <-> '000000012:E'."""
    if name == "NA":
        return name
    rid, end = name.split(":")
    return f"{rid}:{'B' if end == 'E' else 'E'}"


def reverse_edge(e: tuple[str, str]) -> tuple[str, str]:
    return reverse_end(e[1]), reverse_end(e[0])


@dataclass
class SgEdge:
    label: tuple        # (rid, begin, end) — the read segment this edge spells
    length: int
    score: int
    identity: float


class StringGraph:
    """Dual string graph over read-end nodes with reduction marks."""

    def __init__(self):
        self.out_edges: dict[str, list[tuple[str, str]]] = {}
        self.in_edges: dict[str, list[tuple[str, str]]] = {}
        self.edges: dict[tuple[str, str], SgEdge] = {}
        self.e_reduce: dict[tuple[str, str], bool] = {}
        self.best_out: dict[str, str] = {}
        self.best_in: dict[str, str] = {}

    # --- construction ---------------------------------------------------
    def add_edge(self, v: str, w: str, label, length: int, score: int,
                 identity: float) -> None:
        key = (v, w)
        if key not in self.edges:
            oe, ie = self.out_edges, self.in_edges
            if v in oe:
                oe[v].append(key)
            else:
                oe[v] = [key]
                ie[v] = []
            if w in ie:
                ie[w].append(key)
            else:
                ie[w] = [key]
                oe[w] = []
        self.edges[key] = SgEdge(label, length, score, identity)

    def init_reduce(self) -> None:
        for e in self.edges:
            self.e_reduce[e] = False

    def _live_out(self, v: str) -> list[tuple[str, str]]:
        return [e for e in self.out_edges.get(v, []) if not self.e_reduce[e]]

    def _live_in(self, v: str) -> list[tuple[str, str]]:
        return [e for e in self.in_edges.get(v, []) if not self.e_reduce[e]]

    # --- transitive reduction (Myers; reference ovlp_to_graph.py:223-281)
    def mark_tr_edges(self, fuzz: int = 500) -> None:
        mark = {n: 0 for n in self.out_edges}  # 0 vacant / 1 inplay / 2 eliminated

        # every adjacency list is sorted by edge length ONCE up front: the
        # reference re-sorts neighbour lists inside the nested loops
        # (ovlp_to_graph.py:231-263), but nothing mutates them during the
        # pass and timsort is stable, so repeated sorts are idempotent —
        # the one-time sort sees the identical order (and drops ~1.5M
        # redundant sorts: ~10 s of the Drosophila-scale layout wall)
        edges = self.edges
        for oes in self.out_edges.values():
            if len(oes) > 1:
                oes.sort(key=lambda e: edges[e].length)

        for v in self.out_edges:
            oes = self.out_edges[v]
            if not oes:
                continue
            for e in oes:
                mark[e[1]] = 1
            max_len = edges[oes[-1]].length + fuzz

            for e in oes:
                e_len = edges[e].length
                w = e[1]
                if mark[w] == 1:
                    for e2 in self.out_edges[w]:
                        if edges[e2].length + e_len < max_len and mark[e2[1]] == 1:
                            mark[e2[1]] = 2

            for e in oes:
                w = e[1]
                w_oes = self.out_edges[w]
                if w_oes:
                    x = w_oes[0][1]
                    if mark[x] == 1:
                        mark[x] = 2
                for e2 in w_oes:
                    if edges[e2].length < fuzz and mark[e2[1]] == 1:
                        mark[e2[1]] = 2

            for e in oes:
                w = e[1]
                if mark[w] == 2:
                    self.e_reduce[e] = True
                    self.e_reduce[reverse_edge(e)] = True
                mark[w] = 0

    # --- chimer removal (reference ovlp_to_graph.py:107-195) -------------
    def _bfs_nodes(self, n: str, exclude: str | None, depth: int = 5) -> set[str]:
        # NOTE: mirrors the reference's quirk of expanding ONE candidate per
        # depth step (ovlp_to_graph.py:113-123), so exploration is shallow.
        all_nodes = {n}
        candidates = {n: None}  # ordered set
        dp = 1
        while dp < depth and candidates:
            v, _ = candidates.popitem()
            for e in self.out_edges.get(v, []):
                w = e[1]
                if w == exclude or w in all_nodes:
                    continue
                all_nodes.add(w)
                if self.out_edges.get(w):
                    candidates[w] = None
            dp += 1
        return all_nodes

    def mark_chimer_edges(self) -> tuple[list[str], set]:
        multi_out: dict[str, list[str]] = {}
        multi_in: dict[str, list[str]] = {}
        for n in self.out_edges:
            outs = [e[1] for e in self._live_out(n)]
            ins = [e[0] for e in self._live_in(n)]
            if len(outs) >= 2:
                multi_out[n] = outs
            if len(ins) >= 2:
                multi_in[n] = ins

        out_set: dict[str, None] = {}
        in_set: dict[str, None] = {}
        for outs in multi_out.values():
            for w in outs:
                out_set[w] = None
        for ins in multi_in.values():
            for w in ins:
                in_set[w] = None
        candidates = [n for n in out_set if n in in_set]

        chimer_nodes: list[str] = []
        chimer_edges: set = set()
        for n in candidates:
            out_nodes = {e[1] for e in self.out_edges.get(n, [])}
            test_set: set[str] = set()
            for in_node in (e[0] for e in self.in_edges.get(n, [])):
                test_set |= {e[1] for e in self.out_edges.get(in_node, [])}
            test_set -= {n}
            if out_nodes & test_set:
                continue
            flow1: set[str] = set()
            flow2: set[str] = set()
            for v in out_nodes:
                flow1 |= self._bfs_nodes(v, exclude=n)
            for v in test_set:
                flow2 |= self._bfs_nodes(v, exclude=n)
            if flow1 & flow2:
                continue
            for e in self.out_edges.get(n, []) + self.in_edges.get(n, []):
                if not self.e_reduce[e]:
                    self.e_reduce[e] = True
                    chimer_edges.add(e)
                    re = reverse_edge(e)
                    self.e_reduce[re] = True
                    chimer_edges.add(re)
            chimer_nodes.append(n)
            chimer_nodes.append(reverse_end(n))
        return chimer_nodes, chimer_edges

    # --- spur removal (reference ovlp_to_graph.py:197-221) ---------------
    def mark_spur_edge(self) -> set:
        removed: set = set()
        for v in self.out_edges:
            if len(self._live_out(v)) > 1:
                for e in self.out_edges[v]:
                    w = e[1]
                    if not self.out_edges.get(w) and not self.e_reduce[e]:
                        self.e_reduce[e] = True
                        removed.add(e)
                        re = reverse_edge(e)
                        self.e_reduce[re] = True
                        removed.add(re)
            if len(self._live_in(v)) > 1:
                for e in self.in_edges[v]:
                    w = e[0]
                    if not self.in_edges.get(w) and not self.e_reduce[e]:
                        self.e_reduce[e] = True
                        removed.add(e)
                        re = reverse_edge(e)
                        self.e_reduce[re] = True
                        removed.add(re)
        return removed

    # --- best-overlap knot resolution (reference ovlp_to_graph.py:283-325)
    def mark_best_overlap(self) -> set:
        best_edges: set = set()
        removed: set = set()
        for v in self.out_edges:
            oes = sorted(self.out_edges[v], key=lambda e: -self.edges[e].score)
            for e in oes:
                if not self.e_reduce[e]:
                    best_edges.add(e)
                    self.best_out[v] = e[1]
                    break
            ies = sorted(self.in_edges.get(v, []),
                         key=lambda e: -self.edges[e].score)
            for e in ies:
                if not self.e_reduce[e]:
                    best_edges.add(e)
                    self.best_in[v] = e[0]
                    break
        for e in self.edges:
            if not self.e_reduce[e] and e not in best_edges:
                self.e_reduce[e] = True
                removed.add(e)
                re = reverse_edge(e)
                self.e_reduce[re] = True
                removed.add(re)
        return removed

    # --- local-flow-consistency alternative (reference :327-413) ---------
    def resolve_repeat_edges(self) -> set:
        to_reduce = []
        test_nodes: dict[str, None] = {}
        for v in self.out_edges:
            if len(self._live_out(v)) == 1 and len(self._live_in(v)) == 1:
                test_nodes[v] = None

        for v_n in list(test_nodes):
            out_nodes = [e[1] for e in self._live_out(v_n)]
            in_nodes = [e[0] for e in self._live_in(v_n)]

            in_node = in_nodes[0]
            for e in self.out_edges.get(in_node, []):
                vv, ww = e
                ww_out_nodes = {x[1] for x in self.out_edges.get(ww, [])}
                v_out_nodes = {x[1] for x in self.out_edges.get(v_n, [])}
                ww_in_live = len(self._live_in(ww))
                if (ww != v_n and not self.e_reduce[(vv, ww)]
                        and ww_in_live > 1 and ww not in test_nodes
                        and not (ww_out_nodes & v_out_nodes)):
                    to_reduce.append((vv, ww))

            out_node = out_nodes[0]
            for e in self.in_edges.get(out_node, []):
                vv, ww = e
                vv_in_nodes = {x[0] for x in self.in_edges.get(vv, [])}
                v_in_nodes = {x[0] for x in self.in_edges.get(v_n, [])}
                vv_out_live = len(self._live_out(vv))
                if (vv != v_n and not self.e_reduce[(vv, ww)]
                        and vv_out_live > 1 and vv not in test_nodes
                        and not (vv_in_nodes & v_in_nodes)):
                    to_reduce.append((vv, ww))

        removed: set = set()
        for e in to_reduce:
            self.e_reduce[e] = True
            removed.add(e)
        return removed


@dataclass
class GraphResult:
    sg: StringGraph | None
    live: DiGraph                       # the surviving ("G") string graph
    edge_data: dict[tuple[str, str], tuple]
    chimer_nodes: list[str] = field(default_factory=list)
    sg_edge_lines: list[str] = field(default_factory=list)
    # native path: the formatted sg_edges_list file bytes (sg_edge_lines
    # then stays empty — materializing 1.9M Python strings cost ~8 s at
    # 250 Mb scale); writers prefer this when set
    sg_edge_bytes: bytes | None = None

    def tiling_edge_data(self) -> dict:
        """The G-edge dict tiling_paths needs, with identities
        round-tripped through the %5.2f line format exactly as
        _parse_sg_edge_lines would produce."""
        return {k: (rid, sp, tp, score, float(f"{idt:5.2f}"))
                for k, (rid, sp, tp, _len, score, idt, _t)
                in self.edge_data.items()}


def _node_name(code: int) -> str:
    return "%09d:%s" % (code >> 1, "E" if code & 1 else "B")


def _graph_result_from_native(res: dict) -> GraphResult:
    """Assemble a GraphResult from the sg_passes.cpp output (G edges only
    enter the live graph; classification and line formatting already
    happened natively)."""
    import numpy as np

    live = DiGraph()
    edge_data: dict[tuple[str, str], tuple] = {}
    cls = res["cls"]
    gsel = np.flatnonzero(cls == 0)
    ev, ew = res["ev"], res["ew"]
    lrid, ls, lt = res["lrid"], res["ls"], res["lt"]
    score, idt = res["score"], res["idt"]
    best_in = set(res["best_in"].tolist())
    names: dict[int, str] = {}

    def name(code: int) -> str:
        s = names.get(code)
        if s is None:
            s = names[code] = _node_name(code)
        return s

    for i in gsel.tolist():
        v, w = name(int(ev[i])), name(int(ew[i]))
        sp, tp = int(ls[i]), int(lt[i])
        length = abs(sp - tp)
        sc = int(score[i])
        live.add_edge(v, w, length=length, score=sc)
        edge_data[(v, w)] = ("%09d" % int(lrid[i]), sp, tp, length, sc,
                             float(idt[i]), "G")
        if int(ew[i]) in best_in:
            live.node_attr[w]["best_in"] = v
    chimer_nodes = [_node_name(int(c)) for c in res["chimer"]]
    return GraphResult(None, live, edge_data, chimer_nodes, [],
                       res["lines"])


def _edges_from_rows(rows, cont) -> StringGraph:
    """Vectorized edge construction from parse_ovl's structured rows.

    Semantics mirror the per-row Python loop in generate_string_graph
    (the reference's ovlp_to_graph.py:772-841) exactly — including the
    ordering quirks the graph passes depend on: contained filtering
    happens before the first-occurrence rid-pair dedup, a geometry-
    degenerate first occurrence still blocks later duplicates, and edge
    insertion order is row order with the (e1, e2) dual pair per row.
    The row loop self-time (~13 s at Drosophila scale) becomes numpy
    selects plus a minimal insert loop.  Byte-equality of the resulting
    sg_edges_list is asserted in tests/test_graph.py.
    """
    import numpy as np

    sg = StringGraph()
    if not len(rows):
        return sg
    f_id = rows["f_id"].astype(np.int64)
    g_id = rows["g_id"].astype(np.int64)
    cs = np.unique(cont).astype(np.int64)
    ok = ~(np.isin(f_id, cs) | np.isin(g_id, cs))
    key = np.where(f_id < g_id, (f_id << 32) | g_id, (g_id << 32) | f_id)
    kidx = np.flatnonzero(ok)
    _, first = np.unique(key[kidx], return_index=True)
    keep = np.zeros(len(rows), bool)
    keep[kidx[first]] = True

    r = rows[keep]
    f_id, g_id = f_id[keep], g_id[keep]
    f_b = r["f_b"].astype(np.int64)
    f_e = r["f_e"].astype(np.int64)
    f_l = r["f_l"].astype(np.int64)
    g_l = r["g_l"].astype(np.int64)
    g_b = np.where(r["g_s"] == 1, r["g_e"], r["g_b"]).astype(np.int64)
    g_e = np.where(r["g_s"] == 1, r["g_b"], r["g_e"]).astype(np.int64)
    score = -r["score"].astype(np.int64)

    fwd = f_b > 0
    co = g_b < g_e
    cases = [fwd & co, fwd & ~co, ~fwd & co, ~fwd & ~co]
    skip = np.select(cases, [(f_b == 0) | (g_e == g_l),
                             (f_b == 0) | (g_e == 0),
                             (g_b == 0) | (f_e == f_l),
                             (g_b == g_l) | (f_e == f_l)])

    def sel(opts):
        return np.select(cases, opts)

    # per-case (v, w, label) of the dual edge pair; the edge LENGTH is
    # |label_begin - label_end| in every case
    cols = dict(
        v1r=sel([g_id, g_id, f_id, f_id]), v1e=sel([0, 1, 0, 0]),
        w1r=sel([f_id, f_id, g_id, g_id]), w1e=sel([0, 0, 0, 1]),
        l1r=sel([f_id, f_id, g_id, g_id]),
        l1s=sel([f_b, f_b, g_b, g_b]), l1t=sel([0, 0, 0, g_l]),
        v2r=sel([f_id, f_id, g_id, g_id]), v2e=sel([1, 1, 1, 0]),
        w2r=sel([g_id, g_id, f_id, f_id]), w2e=sel([1, 0, 1, 1]),
        l2r=sel([g_id, g_id, f_id, f_id]),
        l2s=sel([g_e, g_e, f_e, f_e]), l2t=sel([g_l, 0, f_l, f_l]),
    )
    uniq = np.unique(np.concatenate([f_id, g_id]))
    nm = {int(x): "%09d" % x for x in uniq.tolist()}
    ends = ({rid: s + ":B" for rid, s in nm.items()},
            {rid: s + ":E" for rid, s in nm.items()})
    c = {k: v.tolist() for k, v in cols.items()}
    idt = r["idt"].tolist()
    sc = score.tolist()
    add = sg.add_edge
    for i in np.flatnonzero(~skip).tolist():
        lr1 = c["l1r"][i]
        s1, t1 = c["l1s"][i], c["l1t"][i]
        add(ends[c["v1e"][i]][c["v1r"][i]], ends[c["w1e"][i]][c["w1r"][i]],
            (nm[lr1], s1, t1), abs(s1 - t1), sc[i], idt[i])
        lr2 = c["l2r"][i]
        s2, t2 = c["l2s"][i], c["l2t"][i]
        add(ends[c["v2e"][i]][c["v2r"][i]], ends[c["w2e"][i]][c["w2r"][i]],
            (nm[lr2], s2, t2), abs(s2 - t2), sc[i], idt[i])
    return sg


def generate_string_graph(overlap_lines=None, min_len: int = 4000,
                          min_idt: float = 96.0, lfc: bool = False,
                          disable_chimer_bridge_removal: bool = False,
                          ovl_bytes: bytes | None = None,
                          use_native: bool = True) -> GraphResult:
    """Overlaps -> classified string graph (reference ovlp_to_graph.py:658-908).

    overlap_lines: iterable of preads.ovl rows (13 columns,
    src/shmr_dedup.c:93-99); a leading '-' line terminates input.
    ovl_bytes: alternatively, the raw file bytes — parsed and (with
    use_native, the default) fully classified by the C++ fast path
    (native/parse_ovl.cpp + native/sg_passes.cpp; the Python passes
    below cost ~50 s at 250 Mb scale and remain the semantic oracle —
    byte-equality is asserted in tests/test_graph.py).
    """
    contained: set[str] = set()
    overlap_data = []
    if ovl_bytes is not None and use_native:
        from ..native import parse_ovl, sg_build
        rows, cont = parse_ovl(ovl_bytes, min_len, float(min_idt))
        return _graph_result_from_native(
            sg_build(rows, cont, lfc, disable_chimer_bridge_removal))
    if ovl_bytes is not None:
        from ..native import parse_ovl
        rows, cont = parse_ovl(ovl_bytes, min_len, float(min_idt))
        contained = {"%09d" % r for r in cont.tolist()}
        sg = _edges_from_rows(rows, cont)
    else:
        for line in overlap_lines:
            if line.startswith("-"):
                break
            f = line.split()
            f_id, g_id = f[0], f[1]
            if f_id == g_id:
                continue
            typ = f[12]
            if typ == "contained":
                contained.add(f_id)
                continue
            if typ == "contains":
                contained.add(g_id)
                continue
            if typ == "none":
                continue
            score = int(f[2])
            identity = float(f[3])
            if identity < min_idt:
                continue
            f_strand, f_start, f_end, f_len = (int(c) for c in f[4:8])
            g_strand, g_start, g_end, g_len = (int(c) for c in f[8:12])
            if f_len < min_len or g_len < min_len:
                continue
            overlap_data.append((f_id, g_id, score, identity,
                                 f_strand, f_start, f_end, f_len,
                                 g_strand, g_start, g_end, g_len))

    if ovl_bytes is None:
        sg = StringGraph()
    seen_pairs: set[tuple[str, str]] = set()
    for od in overlap_data:
        f_id, g_id, score, identity = od[:4]
        if f_id in contained or g_id in contained:
            continue
        _, f_b, f_e, f_l = od[4:8]
        g_s, g_b, g_e, g_l = od[8:12]
        pair = (f_id, g_id) if f_id < g_id else (g_id, f_id)
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)

        if g_s == 1:
            g_b, g_e = g_e, g_b

        # four overlap geometries (reference ovlp_to_graph.py:772-841);
        # f is implicitly forward (the overlapper normalizes strand 0 for f)
        if f_b > 0:
            if g_b < g_e:
                #  f  ----------->          g overhangs right
                #  g        ------------->
                if f_b == 0 or g_e - g_l == 0:
                    continue
                sg.add_edge(f"{g_id}:B", f"{f_id}:B", (f_id, f_b, 0),
                            abs(f_b), -score, identity)
                sg.add_edge(f"{f_id}:E", f"{g_id}:E", (g_id, g_e, g_l),
                            abs(g_e - g_l), -score, identity)
            else:
                #  f  ----------->
                #  g        <-------------
                if f_b == 0 or g_e == 0:
                    continue
                sg.add_edge(f"{g_id}:E", f"{f_id}:B", (f_id, f_b, 0),
                            abs(f_b), -score, identity)
                sg.add_edge(f"{f_id}:E", f"{g_id}:B", (g_id, g_e, 0),
                            abs(g_e), -score, identity)
        else:
            if g_b < g_e:
                #  f          ----------->
                #  g   ------------->
                if g_b == 0 or f_e - f_l == 0:
                    continue
                sg.add_edge(f"{f_id}:B", f"{g_id}:B", (g_id, g_b, 0),
                            abs(g_b), -score, identity)
                sg.add_edge(f"{g_id}:E", f"{f_id}:E", (f_id, f_e, f_l),
                            abs(f_e - f_l), -score, identity)
            else:
                #  f          ----------->
                #  g   <-------------
                if g_b - g_l == 0 or f_e - f_l == 0:
                    continue
                sg.add_edge(f"{f_id}:B", f"{g_id}:E", (g_id, g_b, g_l),
                            abs(g_b - g_l), -score, identity)
                sg.add_edge(f"{g_id}:B", f"{f_id}:E", (f_id, f_e, f_l),
                            abs(f_e - f_l), -score, identity)

    sg.init_reduce()
    sg.mark_tr_edges()

    chimer_nodes: list[str] = []
    chimer_edges: set = set()
    if not disable_chimer_bridge_removal:
        chimer_nodes, chimer_edges = sg.mark_chimer_edges()

    spur_edges = sg.mark_spur_edge()
    removed_edges = sg.resolve_repeat_edges() if lfc else sg.mark_best_overlap()
    spur_edges.update(sg.mark_spur_edge())

    live = DiGraph()
    edge_data: dict[tuple[str, str], tuple] = {}
    lines: list[str] = []
    for (v, w), e in sg.edges.items():
        rid, sp, tp = e.label
        length = abs(sp - tp)
        if not sg.e_reduce[(v, w)]:
            type_ = "G"
            live.add_edge(v, w, length=length, score=e.score)
            edge_data[(v, w)] = (rid, sp, tp, length, e.score, e.identity, type_)
            if w in sg.best_in:
                live.node_attr[w]["best_in"] = v
        elif (v, w) in chimer_edges:
            type_ = "C"
        elif (v, w) in removed_edges:
            type_ = "R"
        elif (v, w) in spur_edges:
            type_ = "S"
        else:
            type_ = "TR"
        lines.append("%s %s %s %5d %5d %5d %5.2f %s" % (
            v, w, rid, sp, tp, e.score, e.identity, type_))

    return GraphResult(sg, live, edge_data, chimer_nodes, lines)
