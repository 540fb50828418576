"""Undirected connected components over edge lists with payloads (a copy
of ``housescan_tpu/utils/graph.py``): the room-position least squares
solves each component alone, so no subproblem is underconstrained. A
host problem: a plain union-find."""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple, TypeVar

N = TypeVar("N", bound=Hashable)
A = TypeVar("A")

Edge = Tuple[Tuple[N, N], A]


class _UnionFind:
    def __init__(self) -> None:
        self.parent: Dict[Hashable, Hashable] = {}

    def find(self, x: Hashable) -> Hashable:
        parent = self.parent
        if x not in parent:
            parent[x] = x
            return x
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def union(self, a: Hashable, b: Hashable) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def group_connected_components(edges_data: Sequence[Edge]) -> List[List[Edge]]:
    """Partition an edge list (with payloads) into connected components,
    ordered by the first appearance of any of their edges; edges keep
    their input order, and a self-loop stays with its node."""
    uf = _UnionFind()
    for (i, j), _ in edges_data:
        uf.union(i, j)
    groups: Dict[Hashable, List[Edge]] = {}
    for edge in edges_data:
        groups.setdefault(uf.find(edge[0][0]), []).append(edge)
    return list(groups.values())
