"""Generic concurrent DAG with cycle detection (reference: pkg/graph/dag/dag.go).

Backs the scheduler's per-task peer graph (scheduler/resource/task.go:155):
vertices are peers, an edge parent→child means the child downloads pieces
from the parent.  Adding an edge that would close a cycle is rejected
(dag.go:277 CanAddEdge / :374-388 DFS), which is what keeps the swarm an
acyclic piece-flow graph.

Thread-safe via a single RLock — the scheduler mutates the graph from many
peer streams concurrently.
"""

from __future__ import annotations

import threading
from typing import Dict, Generic, Iterator, Set, TypeVar

V = TypeVar("V")


class DAGError(Exception):
    pass


class VertexNotFound(DAGError):
    pass


class VertexExists(DAGError):
    pass


class CycleError(DAGError):
    pass


class Vertex(Generic[V]):
    __slots__ = ("id", "value", "parents", "children")

    def __init__(self, vid: str, value: V):
        self.id = vid
        self.value: V = value
        self.parents: Set["Vertex[V]"] = set()
        self.children: Set["Vertex[V]"] = set()

    def in_degree(self) -> int:
        return len(self.parents)

    def out_degree(self) -> int:
        return len(self.children)


class DAG(Generic[V]):
    def __init__(self) -> None:
        self._mu = threading.RLock()
        self._vertices: Dict[str, Vertex[V]] = {}

    def __len__(self) -> int:
        with self._mu:
            return len(self._vertices)

    def __contains__(self, vid: str) -> bool:
        with self._mu:
            return vid in self._vertices

    def add_vertex(self, vid: str, value: V) -> Vertex[V]:
        with self._mu:
            if vid in self._vertices:
                raise VertexExists(vid)
            v = Vertex(vid, value)
            self._vertices[vid] = v
            return v

    def get_vertex(self, vid: str) -> Vertex[V]:
        with self._mu:
            try:
                return self._vertices[vid]
            except KeyError:
                raise VertexNotFound(vid) from None

    def delete_vertex(self, vid: str) -> None:
        with self._mu:
            v = self._vertices.pop(vid, None)
            if v is None:
                return
            for p in v.parents:
                p.children.discard(v)
            for c in v.children:
                c.parents.discard(v)
            v.parents.clear()
            v.children.clear()

    def vertex_ids(self) -> list[str]:
        with self._mu:
            return list(self._vertices)

    def vertices(self) -> list[Vertex[V]]:
        with self._mu:
            return list(self._vertices.values())

    def _reachable(self, start: Vertex[V], target: Vertex[V]) -> bool:
        # Iterative DFS down the children links.
        stack = [start]
        seen: Set[str] = set()
        while stack:
            cur = stack.pop()
            if cur is target:
                return True
            if cur.id in seen:
                continue
            seen.add(cur.id)
            stack.extend(cur.children)
        return False

    def can_add_edge(self, from_id: str, to_id: str) -> bool:
        with self._mu:
            if from_id == to_id:
                return False
            f = self._vertices.get(from_id)
            t = self._vertices.get(to_id)
            if f is None or t is None:
                return False
            if t in f.children:
                return False
            return not self._reachable(t, f)

    def add_edge(self, from_id: str, to_id: str) -> None:
        with self._mu:
            if from_id == to_id:
                raise CycleError(f"self edge {from_id}")
            f = self.get_vertex(from_id)
            t = self.get_vertex(to_id)
            if t in f.children:
                return
            if self._reachable(t, f):
                raise CycleError(f"{from_id}->{to_id} would close a cycle")
            f.children.add(t)
            t.parents.add(f)

    def delete_edge(self, from_id: str, to_id: str) -> None:
        with self._mu:
            f = self.get_vertex(from_id)
            t = self.get_vertex(to_id)
            f.children.discard(t)
            t.parents.discard(f)

    def delete_vertex_in_edges(self, vid: str) -> None:
        """Detach vertex from all its parents (reference: DeleteVertexInEdges)."""
        with self._mu:
            v = self.get_vertex(vid)
            for p in list(v.parents):
                p.children.discard(v)
            v.parents.clear()

    def delete_vertex_out_edges(self, vid: str) -> None:
        with self._mu:
            v = self.get_vertex(vid)
            for c in list(v.children):
                c.parents.discard(v)
            v.children.clear()

    def source_vertices(self) -> list[Vertex[V]]:
        """Vertices with no parents (swarm roots: seed peers / back-to-source)."""
        with self._mu:
            return [v for v in self._vertices.values() if not v.parents]

    def sink_vertices(self) -> list[Vertex[V]]:
        with self._mu:
            return [v for v in self._vertices.values() if not v.children]

    def topo_order(self) -> Iterator[Vertex[V]]:
        """Kahn's algorithm; raises CycleError if the graph is not acyclic."""
        with self._mu:
            in_deg = {vid: v.in_degree() for vid, v in self._vertices.items()}
            ready = [v for v in self._vertices.values() if in_deg[v.id] == 0]
            order: list[Vertex[V]] = []
            while ready:
                v = ready.pop()
                order.append(v)
                for c in v.children:
                    in_deg[c.id] -= 1
                    if in_deg[c.id] == 0:
                        ready.append(c)
            if len(order) != len(self._vertices):
                raise CycleError("graph contains a cycle")
        return iter(order)
