"""Contig tiling paths from the layout (reference py/scripts/graph_to_path.py).

Resolves each contig's unitig chain into a single read-edge tiling path;
compound unitigs contribute their best (score-weighted shortest) internal
path, with the remaining alternatives emitted as associate-contig paths.
"""

from __future__ import annotations

from .digraph import dijkstra_path
from .string_graph import reverse_end


def _parse_utg_rows(utg_rows):
    utg_data = {}
    for row in utg_rows:
        f = row.split()
        s, v, t, type_, length, score, poe = f
        if type_ not in ("compound", "simple", "contained"):
            continue
        if type_ in ("simple", "contained"):
            path_or_edges = poe.split("~")
        else:
            path_or_edges = [tuple(e.split("~")) for e in poe.split("|")]
        utg_data[(s, v, t)] = (type_, int(length), int(score), path_or_edges)
    return utg_data


def _parse_sg_edge_lines(lines):
    edge_data = {}
    for l in lines:
        f = l.split()
        v, w, rid, s, t, aln_score, idt, type_ = f
        if type_ != "G":
            continue
        edge_data[(v, w)] = (rid, int(s), int(t), int(aln_score), float(idt))
    return edge_data


def _compose_ctg(edge_data, ctg_id, path_edges):
    lines = []
    total_score = 0
    ctg_length = 0
    for vv, ww in path_edges:
        rid, s, t, aln_score, idt = edge_data[(vv, ww)]
        dl = abs(s - t)
        lines.append(f"{ctg_id} {vv} {ww} {rid} {s} {t} {aln_score} "
                     f"{idt:0.2f} {ctg_length} {dl}")
        ctg_length += dl
        total_score += aln_score
    return lines, total_score, ctg_length


def tiling_paths(sg_edge_lines, utg_rows, ctg_rows, edge_data=None):
    """ctg paths -> (p_ctg tiling rows, a_ctg tiling rows)
    (reference graph_to_path.py:134-326).

    edge_data may pass the G-edge dict directly
    (GraphResult.tiling_edge_data(); identical to parsing the lines —
    identities are round-tripped through the %5.2f format)."""
    if edge_data is None:
        edge_data = _parse_sg_edge_lines(sg_edge_lines)
    utg_data = _parse_utg_rows(utg_rows)

    p_lines: list[str] = []
    a_lines: list[str] = []
    layout_ctg: set = set()

    for row in ctg_rows:
        f = row.split()
        ctg_id, c_type_, i_utig, t0, _length, _score, utgs = f
        s0 = i_utig.split("~")[0]
        if (reverse_end(t0), reverse_end(s0)) in layout_ctg:
            continue
        layout_ctg.add((s0, t0))

        one_path: list[str] = []
        a_ctg_group: dict = {}

        for utg in utgs.split("|"):
            s, v, t = utg.split("~")
            type_, length, score, path_or_edges = utg_data[(s, v, t)]
            if type_ == "simple":
                one_path.extend(path_or_edges[1:] if one_path else path_or_edges)
            elif type_ == "compound":
                # best path through the bundle by alignment score
                succ: dict = {}
                weights: dict = {}
                for ss, vv, tt in path_or_edges:
                    sub_path = utg_data[(ss, vv, tt)][3]
                    v1 = sub_path[0]
                    for v2 in sub_path[1:]:
                        succ.setdefault(v1, {})[v2] = None
                        weights[(v1, v2)] = edge_data[(v1, v2)][3]
                        v1 = v2

                all_alt = []
                res = dijkstra_path(succ, s, t, lambda a, b: weights[(a, b)])
                while res is not None:
                    cost, sp = res
                    all_alt.append((cost, sp))
                    n0 = sp[0]
                    for n1 in sp[1:]:
                        del succ[n0][n1]
                        n0 = n1
                    res = dijkstra_path(succ, s, t, lambda a, b: weights[(a, b)])
                all_alt.sort(key=lambda x: x[0])
                all_alt.reverse()
                best = all_alt[0][1]
                one_path.extend(best[1:] if one_path else best)
                a_ctg_group[(s, t)] = all_alt

        if not one_path:
            continue
        edges = list(zip(one_path[:-1], one_path[1:]))
        lines, _, _ = _compose_ctg(edge_data, ctg_id, edges)
        p_lines.extend(lines)

        a_id = 0
        for (v, w), alts in a_ctg_group.items():
            for sub_id in range(1, len(alts)):
                _, atig_path = alts[sub_id]
                a_ctg_id = f"{ctg_id}-{a_id + 1:03d}-{sub_id:02d}"
                al, _, _ = _compose_ctg(
                    edge_data, a_ctg_id, list(zip(atig_path[:-1], atig_path[1:])))
                a_lines.extend(al)
            a_id += 1

    return p_lines, a_lines
