"""Unitig and contig-path layout (host phase).

Re-implementation of the reference layout pipeline's second stage
(py/scripts/ovlp_to_graph.py:911-1555): simple-path unitigs, spur removal,
duplicate-path pruning, compound-path (bundle) construction, repeat-bridge
removal, and contig tiling-path emission.

Set-iteration order in the reference depends on PYTHONHASHSEED; here all
"sets with pop" are insertion-ordered dicts, making layout deterministic.
"""

from __future__ import annotations

from .digraph import MultiDiGraph
from .string_graph import GraphResult, reverse_end


def identify_simple_paths(live, edge_data):
    """Maximal simple paths in the surviving string graph
    (reference ovlp_to_graph.py:1033-1144); returns {(v0, w0, end): (len, score, path)}."""
    simple_paths: dict = {}
    s_nodes: dict = {}
    simple_nodes: set = set()
    for n in live.nodes():
        ind, outd = live.in_degree(n), live.out_degree(n)
        if ind == 1 and outd == 1:
            simple_nodes.add(n)
        elif outd != 0:
            s_nodes[n] = None

    free_edges: dict = {e: None for e in live.edges()}

    while free_edges:
        if s_nodes:
            n, _ = s_nodes.popitem()
        else:
            n = next(iter(free_edges))[0]

        for v, w in live.out_edges(n):
            if (v, w) not in free_edges:
                continue
            rv, rw = reverse_end(v), reverse_end(w)

            path = [v, w]
            path_edges = {(v, w)}
            path_length = edge_data[(v, w)][3]
            path_score = edge_data[(v, w)][4]
            del free_edges[(v, w)]

            r_path = [rv, rw]
            r_path_length = edge_data[(rw, rv)][3]
            r_path_score = edge_data[(rw, rv)][4]
            del free_edges[(rw, rv)]

            v0, w0, rv0, rw0 = v, w, rv, rw
            while w in simple_nodes:
                w, w_ = live.out_edges(w)[0]
                if (w, w_) not in free_edges:
                    break
                rw_, rwc = reverse_end(w_), reverse_end(w)
                if (rw_, rwc) in path_edges:
                    break
                path.append(w_)
                path_edges.add((w, w_))
                path_length += edge_data[(w, w_)][3]
                path_score += edge_data[(w, w_)][4]
                del free_edges[(w, w_)]

                r_path.append(rw_)
                r_path_length += edge_data[(rw_, rwc)][3]
                r_path_score += edge_data[(rw_, rwc)][4]
                del free_edges[(rw_, rwc)]
                w = w_

            simple_paths[(v0, w0, path[-1])] = (path_length, path_score, path)
            r_path.reverse()
            simple_paths[(r_path[0], rw0, rv0)] = (
                r_path_length, r_path_score, r_path)
    return simple_paths


def _bfs_path(g: MultiDiGraph, src, dst):
    """Unweighted shortest node path src -> dst (directed)."""
    if src == dst:
        return [src]
    prev = {src: None}
    frontier = [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in g.succ.get(u, {}):
                if v in prev:
                    continue
                prev[v] = u
                if v == dst:
                    path = [v]
                    while prev[path[-1]] is not None:
                        path.append(prev[path[-1]])
                    return path[::-1]
                nxt.append(v)
        frontier = nxt
    return None


def identify_spurs(ug: MultiDiGraph, u_edge_data: dict, spur_len: int) -> MultiDiGraph:
    """Remove short dead-end branches (reference ovlp_to_graph.py:1147-1220).
    Mutates u_edge_data marks; returns a pruned copy of ug."""
    ug2 = ug.copy()
    s_candidates: dict = {v: None for v in ug2.nodes() if ug2.in_degree(v) == 0}

    while s_candidates:
        n, _ = s_candidates.popitem()
        if ug2.in_degree(n) != 0:
            continue
        ego = ug2.ego_out(n, 10)
        ego_nodes = set(ego.nodes())
        for b_node in ego.nodes():
            if ug2.in_degree(b_node) <= 1:
                continue
            b_in = [e[0] for e in ug2.in_edges(b_node)]
            if len(b_in) == 1:
                continue
            if not any(v not in ego_nodes for v in b_in):
                continue
            s_path = _bfs_path(ug2, n, b_node)
            if s_path is None:
                continue
            total = 0
            v1 = s_path[0]
            for v2 in s_path[1:]:
                for s, t, v in list(ug2.out_edges(v1)):
                    if t != v2:
                        continue
                    total += u_edge_data[(s, t, v)][0]
                v1 = v2
            if total >= spur_len:
                continue
            v1 = s_path[0]
            for v2 in s_path[1:]:
                for s, t, v in list(ug2.out_edges(v1)):
                    if t != v2:
                        continue
                    length, score, edges, _ = u_edge_data[(s, t, v)]
                    rs, rt, rv = reverse_end(t), reverse_end(s), reverse_end(v)
                    if ug2.has_edge(s, t, v) and ug2.has_edge(rs, rt, rv):
                        ug2.remove_edge(s, t, v)
                        ug2.remove_edge(rs, rt, rv)
                        u_edge_data[(s, t, v)] = (length, score, edges, "spur:2")
                        u_edge_data[(rs, rt, rv)] = (length, score, edges, "spur:2")
                if ug2.in_degree(v2) == 0:
                    s_candidates[v2] = None
                v1 = v2
            break
    return ug2


def remove_dup_simple_path(ug: MultiDiGraph, u_edge_data: dict) -> MultiDiGraph:
    """Keep one of several parallel short simple paths s->t
    (reference ovlp_to_graph.py:1223-1247)."""
    ug2 = ug.copy()
    dup_edges: dict = {}
    for (s, t, v), (length, score, edges, type_) in u_edge_data.items():
        if len(edges) > 3 or type_ != "simple":
            continue
        dup_edges.setdefault((s, t), []).append(v)
    for (s, t), vl in dup_edges.items():
        vl.sort()
        for v in vl[1:]:
            ug2.remove_edge(s, t, v)
            length, score, edges, _ = u_edge_data[(s, t, v)]
            u_edge_data[(s, t, v)] = (length, score, edges, "simple_dup")
    return ug2


def find_bundle(ug: MultiDiGraph, u_edge_data: dict, start_node,
                depth_cutoff: int, width_cutoff: float, length_cutoff: int):
    """Grow a 'bundle' (superbubble-like region) from a branch node
    (reference ovlp_to_graph.py:465-655).  Returns (converged, data)."""
    local = ug.ego_out(start_node, depth_cutoff)
    length_to_node = {start_node: 0}
    score_to_node = {start_node: 0}
    bundle_nodes: set = {start_node}
    bundle_edges: dict = {}
    tips: dict = {}
    end_node = start_node

    for vv, ww, kk in local.out_edges(start_node):
        if (vv, ww, kk) not in bundle_edges and reverse_end(ww) not in bundle_nodes:
            bundle_edges[(vv, ww, kk)] = None
            tips[ww] = None
    for v in tips:
        bundle_nodes.add(v)

    depth = 1
    converged = False
    while True:
        if len(tips) > 4:
            break
        if len(tips) == 1:
            end_node = next(iter(tips))
            if end_node not in length_to_node:
                max_score, max_edge = 0, None
                for uu, vv, kk in local.in_edges(end_node):
                    if uu not in length_to_node:
                        continue
                    score = u_edge_data[(uu, vv, kk)][1]
                    if score > max_score:
                        max_score, max_edge = score, (uu, vv, kk)
                length_to_node[end_node] = (length_to_node[max_edge[0]]
                                            + u_edge_data[max_edge][0])
                score_to_node[end_node] = (score_to_node[max_edge[0]]
                                           + u_edge_data[max_edge][1])
            converged = True
            break

        depth += 1
        width = len(bundle_edges) / depth
        if depth > 10 and width > width_cutoff:
            break
        if depth > depth_cutoff:
            break

        tip_updated = False
        loop_detect = False
        length_limit = False
        for v in list(tips):
            if not local.out_edges(v):
                continue  # dead-end route
            max_score, max_edge = 0, None
            extend = True
            for uu, vv, kk in local.in_edges(v):
                if uu not in length_to_node:
                    extend = False
                    break
                score = u_edge_data[(uu, vv, kk)][1]
                if score > max_score:
                    max_score, max_edge = score, (uu, vv, kk)
            if extend:
                length_to_node[v] = (length_to_node[max_edge[0]]
                                     + u_edge_data[max_edge][0])
                score_to_node[v] = (score_to_node[max_edge[0]]
                                    + u_edge_data[max_edge][1])
                if length_to_node[v] > length_cutoff:
                    length_limit = True
                    break
                v_updated = False
                for vv, ww, kk in local.out_edges(v):
                    if ww in length_to_node:
                        loop_detect = True
                        break
                    if ((vv, ww, kk) not in bundle_edges
                            and reverse_end(ww) not in bundle_nodes):
                        tips[ww] = None
                        bundle_edges[(vv, ww, kk)] = None
                        tip_updated = True
                        v_updated = True
                if v_updated:
                    del tips[v]
                    if len(tips) == 1:
                        break
            if loop_detect:
                break
        if length_limit or loop_detect or not tip_updated:
            break
        for v in tips:
            bundle_nodes.add(v)

    data = (start_node, end_node, set(bundle_edges),
            length_to_node.get(end_node, 0), score_to_node.get(end_node, 0),
            depth)
    return converged, data


def construct_compound_paths(ug: MultiDiGraph, u_edge_data: dict) -> dict:
    """Consistent dual-complement bundles (reference ovlp_to_graph.py:911-1030)."""
    branch_nodes = [n for n in ug.nodes()
                    if ug.in_degree(n) > 1 or ug.out_degree(n) > 1]

    paths_0 = []
    for p in branch_nodes:
        if ug.out_degree(p) > 1:
            converged, data = find_bundle(ug, u_edge_data, p, 48, 16, 500000)
            if converged:
                s, t, bundle_edges, length, score, depth = data
                paths_0.append((s, "NA", t, len(bundle_edges) / depth,
                                length, score, bundle_edges))
    paths_0.sort(key=lambda x: -len(x[6]))

    edge_to_cpath: dict = {}
    paths_1: dict = {}
    for s, v, t, width, length, score, bundle_edges in paths_0:
        overlapped = False
        for vv, ww, kk in bundle_edges:
            if (vv, ww, kk) in edge_to_cpath:
                overlapped = True
                break
            if (reverse_end(ww), reverse_end(vv), reverse_end(kk)) in edge_to_cpath:
                overlapped = True
                break
        if overlapped:
            continue
        rs, rt = reverse_end(t), reverse_end(s)
        bundle_edges_r = []
        for vv, ww, kk in bundle_edges:
            edge_to_cpath.setdefault((vv, ww, kk), set()).add((s, t, v))
            redge = (reverse_end(ww), reverse_end(vv), reverse_end(kk))
            edge_to_cpath.setdefault(redge, set()).add((rs, rt, v))
            bundle_edges_r.append(redge)
        paths_1[(s, v, t)] = (width, length, score, bundle_edges)
        paths_1[(rs, v, rt)] = (width, length, score, bundle_edges_r)

    paths_2: dict = {}
    edge_to_cpath = {}
    for (s, v, t), val in paths_1.items():
        if (reverse_end(t), "NA", reverse_end(s)) not in paths_1:
            continue
        paths_2[(s, v, t)] = val
        for vv, ww, kk in val[3]:
            edge_to_cpath.setdefault((vv, ww, kk), set()).add((s, t, v))

    paths_3: dict = {}
    for k, val in paths_2.items():
        s, _, t = k
        contained = False
        for vv, ww, kk in ug.out_edges(s):
            if len(edge_to_cpath.get((vv, ww, kk), ())) > 1:
                contained = True
        if not contained:
            paths_3[k] = val

    compound: dict = {}
    for (s, v, t), val in paths_3.items():
        if (reverse_end(t), "NA", reverse_end(s)) in paths_3:
            compound[(s, v, t)] = val
    return compound


def construct_c_path_from_utgs(ug: MultiDiGraph, u_edge_data: dict, live):
    """Chain unitigs into contig paths, gated by best-in edges
    (reference ovlp_to_graph.py:1250-1360)."""
    s_nodes: dict = {}
    simple_out: set = set()
    for n in ug.nodes():
        ind, outd = ug.in_degree(n), ug.out_degree(n)
        if not (ind == 1 and outd == 1) and outd != 0:
            s_nodes[n] = None
        if outd == 1:
            simple_out.add(n)

    c_path = []
    free_edges: dict = {e: None for e in ug.edges()}

    while free_edges:
        if s_nodes:
            n, _ = s_nodes.popitem()
        else:
            n = next(iter(free_edges))[0]

        for s, t, v in ug.out_edges(n):
            path_start = n
            path = []
            path_length = 0
            path_score = 0
            path_nodes = {s}
            path_key = t
            t0 = s
            while t in simple_out:
                if t in path_nodes or reverse_end(t) in path_nodes:
                    break
                length, score, path_or_edges, type_ = u_edge_data[(t0, t, v)]

                # best-overlap gate at multi-in junctions
                # (reference ovlp_to_graph.py:1317-1332)
                if len(ug.in_edges(t)) > 1:
                    best_in_node = live.node_attr.get(t, {}).get("best_in")
                    if type_ == "simple" and best_in_node != path_or_edges[-2]:
                        break
                    if type_ == "compound":
                        t_in_nodes = set()
                        for ss, vv, tt in path_or_edges:
                            if tt != t:
                                continue
                            _, _, sub, sub_type = u_edge_data[(ss, vv, tt)]
                            if sub[-1] == tt:
                                t_in_nodes.add(sub[-2])
                        if best_in_node not in t_in_nodes:
                            break

                path.append((t0, t, v))
                path_nodes.add(t)
                path_length += length
                path_score += score
                t0, t, v = ug.out_edges(t)[0]

            path.append((t0, t, v))
            length, score, _, _ = u_edge_data[(t0, t, v)]
            path_length += length
            path_score += score
            path_nodes.add(t)

            c_path.append((path_start, path_key, t, path_length,
                           path_score, path, len(path)))
            for e in path:
                free_edges.pop(e, None)
    return c_path


def assemble_graph(result: GraphResult):
    """Full layout: string graph -> unitigs -> contig paths
    (reference ovlp_to_graph.py:1363-1555).

    Returns (u_edge_data, ctg_path_rows, utg_rows, compound_rows) where
    ctg_path_rows are the reference's ctg_paths columns.
    """
    live, edge_data = result.live, result.edge_data

    simple_paths = identify_simple_paths(live, edge_data)

    ug = MultiDiGraph()
    u_edge_data: dict = {}
    circular_path: dict = {}
    for (s, v, t), (length, score, path) in simple_paths.items():
        u_edge_data[(s, t, v)] = (length, score, path, "simple")
        if s != t:
            ug.add_edge(s, t, v)
        else:
            circular_path[(s, t, v)] = None

    ug2 = identify_spurs(ug, u_edge_data, 50000)
    ug2 = remove_dup_simple_path(ug2, u_edge_data)

    compound_paths = construct_compound_paths(ug2, u_edge_data)
    compound_rows = []
    ug2_edges = set(ug2.edges())
    to_remove = set()
    for (s, v, t), (width, length, score, bundle_edges) in compound_paths.items():
        compound_rows.append(
            f"{s} {v} {t} {width} {length} {score} "
            + "|".join(e[0] + "~" + e[2] + "~" + e[1] for e in bundle_edges))
        for e in bundle_edges:
            if e in ug2_edges:
                to_remove.add(e)
    for s, t, v in to_remove:
        ug2.remove_edge(s, t, v)
        length, score, edges, type_ = u_edge_data[(s, t, v)]
        if type_ != "spur":
            u_edge_data[(s, t, v)] = (length, score, edges, "contained")
    for (s, v, t), (width, length, score, bundle_edges) in compound_paths.items():
        u_edge_data[(s, t, v)] = (length, score, bundle_edges, "compound")
        ug2.add_edge(s, t, v)

    # repeat-bridge removal (reference ovlp_to_graph.py:1456-1470)
    bridge_remove = set()
    for s, t, v in ug2.edges():
        if (ug2.in_degree(s) == 1 and ug2.out_degree(s) == 2
                and ug2.in_degree(t) == 2 and ug2.out_degree(t) == 1):
            if u_edge_data[(s, t, v)][0] < 60000:
                bridge_remove.add((s, t, v))
                bridge_remove.add((reverse_end(t), reverse_end(s), reverse_end(v)))
    for s, t, v in bridge_remove:
        if ug2.has_edge(s, t, v):
            ug2.remove_edge(s, t, v)
        length, score, edges, _ = u_edge_data[(s, t, v)]
        u_edge_data[(s, t, v)] = (length, score, edges, "repeat_bridge")

    ug2 = identify_spurs(ug2, u_edge_data, 80000)

    utg_rows = []
    for (s, t, v), (length, score, path_or_edges, type_) in u_edge_data.items():
        if v == "NA":
            poe = "|".join(ss + "~" + vv + "~" + tt for ss, tt, vv in path_or_edges)
        else:
            poe = "~".join(path_or_edges)
        utg_rows.append(f"{s} {v} {t} {type_} {length} {score} {poe}")

    c_path = construct_c_path_from_utgs(ug2, u_edge_data, live)
    c_path.sort(key=lambda x: -x[3])

    free_edges = {e: None for e in ug2.edges()}
    ctg_rows = []
    ctg_id = 0
    for path_start, path_key, path_end, p_len, p_score, path, n_edges in c_path:
        length = score = length_r = score_r = 0
        nop = []     # non-overlapped path
        nop_r = []
        for s, t, v in path:
            rs, rt = reverse_end(t), reverse_end(s)
            rv = reverse_end(v) if v != "NA" else "NA"
            if (s, t, v) in free_edges and (rs, rt, rv) in free_edges:
                nop.append((s, t, v))
                nop_r.append((rs, rt, rv))
                length += u_edge_data[(s, t, v)][0]
                score += u_edge_data[(s, t, v)][1]
                length_r += u_edge_data[(rs, rt, rv)][0]
                score_r += u_edge_data[(rs, rt, rv)][1]
            else:
                break
        if not nop:
            continue
        s0, t0, v0 = nop[0]
        end_node = nop[-1][1]
        c_type = "ctg_linear" if end_node != s0 else "ctg_circular"
        ctg_rows.append(
            f"{ctg_id:06d}F {c_type} {s0}~{v0}~{t0} {end_node} {length} {score} "
            + "|".join(c[0] + "~" + c[2] + "~" + c[1] for c in nop))
        nop_r.reverse()
        s0, t0, v0 = nop_r[0]
        end_node = nop_r[-1][1]
        ctg_rows.append(
            f"{ctg_id:06d}R {c_type} {s0}~{v0}~{t0} {end_node} {length_r} {score_r} "
            + "|".join(c[0] + "~" + c[2] + "~" + c[1] for c in nop_r))
        ctg_id += 1
        for e in nop:
            free_edges.pop(e, None)
        for e in nop_r:
            free_edges.pop(e, None)

    for s, t, v in circular_path:
        length, score, path, type_ = u_edge_data[(s, t, v)]
        ctg_rows.append(f"{ctg_id:6d} ctg_circular {s}~{v}~{t} {t} {length} "
                        f"{score} {s}~{v}~{t}")
        ctg_id += 1

    return u_edge_data, ctg_rows, utg_rows, compound_rows
