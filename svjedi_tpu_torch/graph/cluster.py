# Copied verbatim from svjedi_tpu/graph/cluster.py.
"""Junction clusters and local allele-path enumeration (the alignment panel).

The reference maps reads against the whole graph with minigraph and then asks
one question per alignment: which *tagged* edges does the best path cross,
with >= d_over aligned bases on each side (SURVEY §3.3)? An SV variation
graph is locally sparse — a linear genome with short allele detours — so the
set of distinguishable local haplotypes around each breakpoint neighborhood
is tiny and enumerable. This module:

1. Groups tagged links into **junction clusters**: connected components over
   (a) junction coordinates within ``cluster_gap`` on the same chromosome and
   (b) links sharing a node side. Every tagged link is *owned* by exactly one
   cluster, so counting once per (read, cluster) cannot double count.
2. Enumerates every simple oriented walk through each cluster from one
   border to another (bounded by ``max_paths_per_cluster``/``max_hops``),
   branching on owned links only and following the reference path elsewhere.
   Nested/overlapping SVs yield their combination haplotypes automatically
   via reverse traversal of alt links (e.g. a small INV nested inside a
   larger one produces the doubly-inverted walk).
3. Materializes each walk as a **panel path**: int8 sequence (flank-trimmed
   to ``flank`` bases beyond the outermost owned junction), the owned links
   it crosses with their path-space junction offsets, and the node/orient
   composition for GAF emission.

Reads are then aligned against panel paths (align/), and the winning path
per (read, cluster) determines which (sv, allele) tags are counted — the
branch-point competition that mirrors minigraph's best-path choice (taking
one INS branch at a shared breakpoint crosses neither of a co-located INS's
edges, exactly as in the reference graph).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..io.fastq import encode_ascii
from .build import FWD, REV, VariationGraph

State = Tuple[int, int]  # (node index, traversal strand)


def _flip(strand: int) -> int:
    return REV if strand == FWD else FWD


@dataclass
class PanelPath:
    cluster_id: int
    #: Oriented node walk, including flank-extension nodes.
    states: List[State]
    #: int8 sequence (A,C,G,T->0..3, N->4), flank-trimmed.
    seq: np.ndarray
    #: (tag, allele, junction_offset, link_idx) for owned links crossed,
    #: in walk order. junction_offset = path-space index (trimmed coords) of
    #: the first base after the junction; link_idx identifies the crossed
    #: graph link (counting dedups per (read, link) across a read's kept
    #: alignments).
    owned: List[Tuple[str, int, int, int]]
    #: Bases trimmed off the front of the untrimmed walk (for GAF coords).
    trim_left: int
    #: Total untrimmed walk length (sum of full node lengths).
    full_len: int

    @property
    def length(self) -> int:
        return int(len(self.seq))


@dataclass
class Cluster:
    cluster_id: int
    link_indices: List[int]
    paths: List[int] = field(default_factory=list)  # indices into Panel.paths
    truncated: bool = False  # enumeration hit a cap


@dataclass
class Panel:
    clusters: List[Cluster]
    paths: List[PanelPath]
    graph: VariationGraph

    @property
    def n_paths(self) -> int:
        return len(self.paths)

    def total_bases(self) -> int:
        return int(sum(len(p.seq) for p in self.paths))


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def _junction_sides(graph: VariationGraph, link_idx: int) -> List[Tuple[str, int]]:
    """Genomic coordinates of a link's two junction sides (chrom, pos0)."""
    link = graph.links[link_idx]
    u, v = graph.nodes[link.u], graph.nodes[link.v]
    return [
        (u.chrom, u.end0 if link.su == FWD else u.start0),
        (v.chrom, v.start0 if link.sv == FWD else v.end0),
    ]


def build_clusters(graph: VariationGraph, cluster_gap: int) -> List[List[int]]:
    """Group tagged links into junction clusters (see module docstring)."""
    tagged = [i for i, l in enumerate(graph.links) if l.tags]
    if not tagged:
        return []
    uf = _UnionFind(len(tagged))

    coords: List[Tuple[str, int, int]] = []
    for ti, li in enumerate(tagged):
        for chrom, pos in _junction_sides(graph, li):
            coords.append((chrom, pos, ti))
    coords.sort()
    for a, b in zip(coords, coords[1:]):
        if a[0] == b[0] and b[1] - a[1] <= cluster_gap:
            uf.union(a[2], b[2])

    side_map: Dict[Tuple[int, int], int] = {}
    for ti, li in enumerate(tagged):
        link = graph.links[li]
        for side in (
            (link.u, 1 if link.su == FWD else 0),  # exit side of u
            (link.v, 0 if link.sv == FWD else 1),  # entry side of v
        ):
            if side in side_map:
                uf.union(side_map[side], ti)
            else:
                side_map[side] = ti

    groups: Dict[int, List[int]] = {}
    for ti, li in enumerate(tagged):
        groups.setdefault(uf.find(ti), []).append(li)
    return list(groups.values())


class _Traversal:
    """Oriented adjacency over the graph, scoped to one cluster's owned set."""

    def __init__(self, graph: VariationGraph):
        self.graph = graph
        self.owned: Set[int] = set()  # rebound per cluster by build_panel
        #: state -> [(link_idx, to_state)] over ALL links, both directions.
        self.out: Dict[State, List[Tuple[int, State]]] = {}
        for idx, link in enumerate(graph.links):
            self.out.setdefault((link.u, link.su), []).append(
                (idx, (link.v, link.sv))
            )
            self.out.setdefault((link.v, _flip(link.sv)), []).append(
                (idx, (link.u, _flip(link.su)))
            )
        self.path_pos: Dict[int, Tuple[str, int]] = {}
        for chrom, nodes in graph.chrom_path.items():
            for i, n in enumerate(nodes):
                self.path_pos[n] = (chrom, i)

    def owned_out(self, state: State) -> List[Tuple[int, State]]:
        return [
            (li, st) for (li, st) in self.out.get(state, []) if li in self.owned
        ]

    def has_owned_in(self, state: State) -> bool:
        """True if an owned link is incident to the entry side of ``state``."""
        return bool(self.owned_out((state[0], _flip(state[1]))))

    def ref_step(self, state: State, forward: bool) -> Optional[State]:
        """Neighbor state along the reference path (None at alt nodes/ends)."""
        node, strand = state
        if node not in self.path_pos:
            return None
        chrom, i = self.path_pos[node]
        nodes = self.graph.chrom_path[chrom]
        step = 1 if (strand == FWD) == forward else -1
        j = i + step
        if 0 <= j < len(nodes):
            return (nodes[j], strand)
        return None

    def moves(self, state: State) -> List[Tuple[int, State]]:
        """Transitions followed by the walk enumerator.

        Owned links (either direction) plus the plain reference continuation;
        foreign alt links are never branched into — reads carrying a foreign
        SV inside this cluster's span penalize all of this cluster's paths
        symmetrically, so the winner is unaffected, and the foreign SV is
        counted by its own cluster.
        """
        out = list(self.owned_out(state))
        cont = self.ref_step(state, forward=True)
        if cont is not None and not any(st == cont for _, st in out):
            for li, st in self.out.get(state, []):
                if st == cont:
                    out.append((li, st))
                    break
        return out


def _node_codes(graph: VariationGraph, cache: Dict[int, np.ndarray], idx: int) -> np.ndarray:
    if idx not in cache:
        cache[idx] = encode_ascii(graph.node_seq(idx))
    return cache[idx]


def oriented_codes(
    graph: VariationGraph, cache: Dict[int, np.ndarray], state: State
) -> np.ndarray:
    codes = _node_codes(graph, cache, state[0])
    if state[1] == REV:
        rc = codes[::-1].copy()
        mask = rc < 4
        rc[mask] = 3 - rc[mask]
        return rc
    return codes


@dataclass
class _Walk:
    states: List[State]
    #: (position i, link_idx): crossing joins states[i] -> states[i+1].
    owned_crossings: List[Tuple[int, int]]


def _enumerate_walks(
    trav: _Traversal,
    owned: Set[int],
    max_paths: int,
    max_hops: int,
    interior_cap: int,
) -> Tuple[List[_Walk], bool]:
    """DFS all simple border-to-border walks crossing >= 1 owned link."""
    graph = trav.graph
    sources: List[State] = []
    seen_src = set()
    for li in owned:
        link = graph.links[li]
        for state in ((link.u, link.su), (link.v, _flip(link.sv))):
            if state not in seen_src:
                seen_src.add(state)
                if not trav.has_owned_in(state):
                    sources.append(state)
    sources.sort()

    walks: List[_Walk] = []
    truncated = False

    def dfs(state: State, states: List[State], crossings: List, walked: int):
        nonlocal truncated
        if len(walks) >= max_paths:
            truncated = True
            return
        crossed_any = bool(crossings)
        owned_here = trav.owned_out(state)
        if crossed_any and not owned_here:
            walks.append(_Walk(list(states), list(crossings)))
            return
        if len(states) > max_hops or walked > interior_cap:
            truncated = True
            if crossed_any:
                walks.append(_Walk(list(states), list(crossings)))
            return
        progressed = False
        visited = set(states)
        for li, nxt in trav.moves(state):
            if nxt in visited or (nxt[0], _flip(nxt[1])) in visited:
                continue
            progressed = True
            states.append(nxt)
            if li in owned:
                crossings.append((len(states) - 2, li))
            dfs(nxt, states, crossings, walked + graph.nodes[nxt[0]].length)
            states.pop()
            if li in owned:
                crossings.pop()
        if not progressed and crossed_any:
            walks.append(_Walk(list(states), list(crossings)))

    for src in sources:
        dfs(src, [src], [], 0)
    return walks, truncated


def _canonical(states: Sequence[State]) -> tuple:
    fwd = tuple(states)
    rev = tuple((n, _flip(s)) for (n, s) in reversed(states))
    return min(fwd, rev)


def _materialize(
    graph: VariationGraph,
    trav: _Traversal,
    seq_cache: Dict[int, np.ndarray],
    cid: int,
    walk: _Walk,
    flank: int,
) -> Optional[PanelPath]:
    """Flank-extend, assemble, and trim one walk into a PanelPath."""
    if not walk.owned_crossings:
        return None
    states = list(walk.states)
    crossings = list(walk.owned_crossings)

    def node_len(state: State) -> int:
        return graph.nodes[state[0]].length

    # Front: ensure >= flank bases before the first owned junction.
    first_i = crossings[0][0]
    front_len = sum(node_len(s) for s in states[: first_i + 1])
    guard = 0
    while front_len < flank and guard < 64:
        pred = trav.ref_step(states[0], forward=False)
        if pred is None or pred in states:
            break
        states.insert(0, pred)
        crossings = [(i + 1, li) for (i, li) in crossings]
        front_len += node_len(pred)
        guard += 1
    # Back: ensure >= flank bases after the last owned junction.
    last_i = crossings[-1][0]
    back_len = sum(node_len(s) for s in states[last_i + 1 :])
    guard = 0
    while back_len < flank and guard < 64:
        nxt = trav.ref_step(states[-1], forward=True)
        if nxt is None or nxt in states:
            break
        states.append(nxt)
        back_len += node_len(nxt)
        guard += 1

    chunks = [oriented_codes(graph, seq_cache, s) for s in states]
    offsets = np.zeros(len(states) + 1, dtype=np.int64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    full = np.concatenate(chunks) if chunks else np.zeros(0, np.int8)
    full_len = int(offsets[-1])

    owned_list: List[Tuple[str, int, int, int]] = []
    junctions = []
    for i, li in crossings:
        boundary = int(offsets[i + 1])
        junctions.append(boundary)
        for tag, allele in graph.links[li].tags:
            owned_list.append((tag, allele, boundary, li))
    first_j, last_j = junctions[0], junctions[-1]

    trim_left = max(0, first_j - flank)
    trim_right = min(full_len, last_j + flank)
    seq = np.ascontiguousarray(full[trim_left:trim_right])
    owned_list = [(t, a, j - trim_left, li) for (t, a, j, li) in owned_list]
    return PanelPath(
        cluster_id=cid,
        states=states,
        seq=seq,
        owned=owned_list,
        trim_left=trim_left,
        full_len=full_len,
    )


def build_panel(
    graph: VariationGraph,
    flank: int = 1000,
    cluster_gap: int = 500,
    max_paths_per_cluster: int = 64,
    max_hops_per_path: int = 24,
    interior_cap: int = 30000,
) -> Panel:
    """Build the full alignment panel for a variation graph."""
    cluster_links = build_clusters(graph, cluster_gap)
    clusters: List[Cluster] = []
    paths: List[PanelPath] = []
    seq_cache: Dict[int, np.ndarray] = {}

    trav = _Traversal(graph)
    for cid, links in enumerate(cluster_links):
        owned = set(links)
        trav.owned = owned
        walks, truncated = _enumerate_walks(
            trav, owned, max_paths_per_cluster, max_hops_per_path, interior_cap
        )
        cluster = Cluster(cluster_id=cid, link_indices=sorted(links), truncated=truncated)
        seen = set()
        covered: Set[int] = set()
        for walk in walks:
            key = _canonical(walk.states)
            if key in seen:
                continue
            seen.add(key)
            panel_path = _materialize(graph, trav, seq_cache, cid, walk, flank)
            if panel_path is not None:
                cluster.paths.append(len(paths))
                covered.update(li for (_, _, _, li) in panel_path.owned)
                paths.append(panel_path)
        # Truncation fallback (per-SV sub-panels): combinatorially dense
        # clusters (2^n haplotype walks from n co-located SVs) can hit the
        # enumeration caps with some owned links crossed by NO kept walk —
        # those SVs would silently lose all support (the reference has no
        # such cap: whole-graph alignment, construct-graph.py:383-547).
        # Synthesize one minimal single-junction walk per uncovered link;
        # flank extension in _materialize turns it into a normal panel
        # path, so every (SV, allele) stays countable. The cluster keeps
        # its ``truncated`` flag — the pipeline surfaces it in stats and a
        # runtime warning (round-2 verdict #3: no silent truncation).
        for li in sorted(owned - covered):
            link = graph.links[li]
            walk = _Walk(
                states=[(link.u, link.su), (link.v, link.sv)],
                owned_crossings=[(0, li)],
            )
            key = _canonical(walk.states)
            if key in seen:
                continue
            seen.add(key)
            panel_path = _materialize(graph, trav, seq_cache, cid, walk, flank)
            if panel_path is not None:
                cluster.paths.append(len(paths))
                paths.append(panel_path)
        clusters.append(cluster)

    return Panel(clusters=clusters, paths=paths, graph=graph)
