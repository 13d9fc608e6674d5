"""Minimal directed-graph containers for the host-side layout phase.

The layout algorithms need only: insertion-ordered adjacency, keyed
multi-edges, out-/in-degree, radius-limited ego subgraphs, and weighted
shortest paths.  A purpose-built ~150-line implementation keeps the layout
engine dependency-free and deterministic (plain dict ordering).
"""

from __future__ import annotations

import heapq
from typing import Hashable, Iterable


class DiGraph:
    """Simple directed graph; one edge per (u, v); attrs per edge and node."""

    def __init__(self):
        self.succ: dict[Hashable, dict[Hashable, dict]] = {}
        self.pred: dict[Hashable, dict[Hashable, dict]] = {}
        self.node_attr: dict[Hashable, dict] = {}

    def add_node(self, n) -> None:
        if n not in self.succ:
            self.succ[n] = {}
            self.pred[n] = {}
            self.node_attr[n] = {}

    def add_edge(self, u, v, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        self.succ[u].setdefault(v, {}).update(attr)
        self.pred[v][u] = self.succ[u][v]

    def nodes(self) -> Iterable:
        return self.succ.keys()

    def edges(self):
        return [(u, v) for u, nbrs in self.succ.items() for v in nbrs]

    def out_edges(self, n):
        return [(n, v) for v in self.succ.get(n, {})]

    def in_edges(self, n):
        return [(u, n) for u in self.pred.get(n, {})]

    def out_degree(self, n) -> int:
        return len(self.succ.get(n, {}))

    def in_degree(self, n) -> int:
        return len(self.pred.get(n, {}))

    def edge(self, u, v) -> dict:
        return self.succ[u][v]


class MultiDiGraph:
    """Directed multigraph with hashable edge keys ((u, v, key) identity)."""

    def __init__(self):
        self.succ: dict[Hashable, dict[Hashable, dict[Hashable, dict]]] = {}
        self.pred: dict[Hashable, dict[Hashable, dict[Hashable, dict]]] = {}

    def add_node(self, n) -> None:
        if n not in self.succ:
            self.succ[n] = {}
            self.pred[n] = {}

    def add_edge(self, u, v, key, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        self.succ[u].setdefault(v, {})[key] = attr
        self.pred[v].setdefault(u, {})[key] = attr

    def remove_edge(self, u, v, key) -> None:
        del self.succ[u][v][key]
        if not self.succ[u][v]:
            del self.succ[u][v]
        del self.pred[v][u][key]
        if not self.pred[v][u]:
            del self.pred[v][u]

    def has_edge(self, u, v, key) -> bool:
        return key in self.succ.get(u, {}).get(v, {})

    def copy(self) -> "MultiDiGraph":
        g = MultiDiGraph()
        for u, nbrs in self.succ.items():
            g.add_node(u)
            for v, keys in nbrs.items():
                for k, attr in keys.items():
                    g.add_edge(u, v, k, **attr)
        return g

    def nodes(self) -> Iterable:
        return self.succ.keys()

    def edges(self):
        return [(u, v, k)
                for u, nbrs in self.succ.items()
                for v, keys in nbrs.items()
                for k in keys]

    def out_edges(self, n):
        return [(n, v, k) for v, keys in self.succ.get(n, {}).items() for k in keys]

    def in_edges(self, n):
        return [(u, n, k) for u, keys in self.pred.get(n, {}).items() for k in keys]

    def out_degree(self, n) -> int:
        return sum(len(k) for k in self.succ.get(n, {}).values())

    def in_degree(self, n) -> int:
        return sum(len(k) for k in self.pred.get(n, {}).values())

    def ego_out(self, start, radius: int) -> "MultiDiGraph":
        """Subgraph of nodes reachable from start within `radius` hops
        (directed, outgoing), including all edges among them."""
        dist = {start: 0}
        frontier = [start]
        while frontier:
            nxt = []
            for u in frontier:
                d = dist[u]
                if d >= radius:
                    continue
                for v in self.succ.get(u, {}):
                    if v not in dist:
                        dist[v] = d + 1
                        nxt.append(v)
            frontier = nxt
        sub = MultiDiGraph()
        for u in dist:
            sub.add_node(u)
        for u in dist:
            for v, keys in self.succ.get(u, {}).items():
                if v in dist:
                    for k, attr in keys.items():
                        sub.add_edge(u, v, k, **attr)
        return sub


def dijkstra_path(succ: dict, src, dst, weight_of) -> tuple[float, list] | None:
    """Weighted shortest path over a successor map; returns (cost, path) or
    None when unreachable.  weight_of(u, v) supplies edge weights."""
    best = {src: 0.0}
    prev = {}
    heap = [(0.0, 0, src)]
    tie = 1
    while heap:
        d, _, u = heapq.heappop(heap)
        if u == dst:
            path = [u]
            while u != src:
                u = prev[u]
                path.append(u)
            return d, path[::-1]
        if d > best.get(u, float("inf")):
            continue
        for v in succ.get(u, {}):
            nd = d + weight_of(u, v)
            if nd < best.get(v, float("inf")):
                best[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, tie, v))
                tie += 1
    return None
