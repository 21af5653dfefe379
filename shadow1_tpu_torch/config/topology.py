"""GraphML topology loader + vertex-level path compilation.

The reference loads a GraphML network graph with igraph and answers
latency/reliability queries with lazily-cached Dijkstra runs
(src/main/routing/topology.c getLatency/getReliability). Published
Shadow/Tor topology files therefore work here unchanged. We instead compile
the whole graph ONCE on the host into dense vertex-level tensors
(SURVEY §7.1: exploit the vertex/host split — topologies have few network
vertices with many attached hosts):

* ``lat_vv``  — all-pairs latency (ns) along minimum-latency paths;
* ``loss_vv`` — end-to-end loss probability along those same paths
  (1 - Π(1-loss_e), the reference's per-edge reliability product).

Edge attributes honored (reference GraphML schema): ``latency`` (float,
*milliseconds* — Shadow convention) or ``latency_ns``; ``packetloss``
(probability). Vertices are the points of presence hosts attach to.
"""

from __future__ import annotations

import numpy as np

from shadow1_tpu_torch.consts import MS


def load_graphml(path: str):
    """Returns (vertex_ids, lat_e, loss_e, directed): node id list (stable
    order) and dense [V, V] edge matrices (np.inf / 0 where no edge).

    Directed GraphML (Shadow's published Tor topologies use
    edgedefault="directed" with possibly asymmetric latencies) keeps each
    direction separate; undirected input is symmetrized. Read with the
    standard library's XML parser (:func:`_read_graphml_xml`), so the
    port needs no networkx."""
    nodes, edge_list, directed = _read_graphml_xml(path)
    index = {n: i for i, n in enumerate(nodes)}
    v = len(nodes)
    lat = np.full((v, v), np.inf)
    loss = np.zeros((v, v))
    for a, b, data in edge_list:
        if "latency_ns" in data:
            l_ns = float(data["latency_ns"])
        elif "latency" in data:
            l_ns = float(data["latency"]) * MS  # Shadow: milliseconds
        else:
            raise ValueError(f"edge {a}-{b} missing latency attribute")
        p = float(data.get("packetloss", data.get("loss", 0.0)))
        i, j = index[a], index[b]
        # Self-loop edges (Shadow convention) give the intra-PoP latency of
        # hosts attached to the same vertex.
        lat[i, j] = l_ns
        loss[i, j] = p
        if not directed:
            lat[j, i] = l_ns
            loss[j, i] = p
    return nodes, lat, loss, directed


def _read_graphml_xml(path: str):
    """(node ids, [(source, target, {attr name: text})], directed) of a
    GraphML file, as networkx's ``read_graphml`` gives them for the files
    this loader reads: nodes in document order (an edge's undeclared end
    appended), edge data by ``attr.name`` (a key's ``<default>`` is not
    filled in, as networkx does not), ``edgedefault="directed"`` directed
    and any other value not."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    ns = root.tag[:root.tag.index("}") + 1] if root.tag.startswith("{") else ""
    names = {k.get("id"): k.get("attr.name", k.get("id"))
             for k in root.findall(ns + "key")}
    graph = root.find(ns + "graph")
    nodes = [n.get("id") for n in graph.findall(ns + "node")]
    seen = set(nodes)
    edges = []
    for e in graph.findall(ns + "edge"):
        for end in (e.get("source"), e.get("target")):
            if end not in seen:
                seen.add(end)
                nodes.append(end)
        data = {names.get(d.get("key"), d.get("key")): d.text
                for d in e.findall(ns + "data")}
        edges.append((e.get("source"), e.get("target"), data))
    return nodes, edges, graph.get("edgedefault") == "directed"


def compile_paths(lat_e: np.ndarray, loss_e: np.ndarray,
                  self_latency_ns: int | None = None,
                  directed: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs min-latency paths → (lat_vv i64 ns, loss_vv f32).

    Loss accumulates along each chosen latency-shortest path via the
    predecessor matrix (vectorized back-walk, ≤V steps). The diagonal
    (same-vertex host pairs) uses the vertex's GraphML self-loop latency
    where present, else ``self_latency_ns``, else the minimum edge latency —
    it must stay positive, since the conservative window is min(lat_vv)
    (the reference computes runahead the same way, src/main/core/master.c).
    """
    from scipy.sparse.csgraph import dijkstra

    v = lat_e.shape[0]
    self_lat = np.diag(lat_e).copy()          # self-loops (inf = absent)
    lat_e = lat_e.copy()
    np.fill_diagonal(lat_e, np.inf)
    finite = lat_e[np.isfinite(lat_e)]
    min_edge = float(finite.min()) if finite.size else float(self_latency_ns or 0)
    default_self = self_latency_ns if self_latency_ns is not None else min_edge
    self_lat = np.where(np.isfinite(self_lat), self_lat, default_self)
    assert (self_lat > 0).all(), "intra-vertex latency must be positive"
    graph = np.where(np.isinf(lat_e), 0.0, lat_e)
    dist, pred = dijkstra(
        graph, directed=directed, return_predecessors=True, unweighted=False
    )
    if np.isinf(dist).any():
        bad = int(np.isinf(dist).sum())
        raise ValueError(f"topology is disconnected ({bad} unreachable pairs)")
    # Walk predecessors for all (src, dst) pairs at once, multiplying edge
    # reliability (1 - loss) per hop.
    rel = np.ones((v, v))
    rel_e = 1.0 - loss_e
    src = np.broadcast_to(np.arange(v)[:, None], (v, v)).copy()
    cur = np.broadcast_to(np.arange(v)[None, :], (v, v)).copy()
    for _ in range(v):
        prev = pred[src, cur]
        active = prev >= 0
        if not active.any():
            break
        p_safe = np.where(active, prev, 0)
        rel *= np.where(active, rel_e[p_safe, cur], 1.0)
        cur = np.where(active, p_safe, cur)
    lat_vv = np.rint(dist).astype(np.int64)
    np.fill_diagonal(lat_vv, np.rint(self_lat).astype(np.int64))
    loss_vv = (1.0 - rel).astype(np.float32)
    np.fill_diagonal(loss_vv, 0.0)
    assert (lat_vv > 0).all(), "zero-latency path would break the window"
    return lat_vv, loss_vv
