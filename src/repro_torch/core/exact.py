"""Exact MWM oracle (networkx blossom): a test reference only."""
from __future__ import annotations

from repro_torch.core.types import EdgeStream, to_numpy


def exact_mwm_weight(stream: EdgeStream) -> float:
    import networkx as nx  # test-only dependency

    src = to_numpy(stream.src)
    dst = to_numpy(stream.dst)
    w = to_numpy(stream.weight)
    valid = to_numpy(stream.valid)
    g = nx.Graph()
    for u, v, wt, ok in zip(src, dst, w, valid):
        if not ok or u == v:
            continue
        # parallel edges: keep the max weight (a matching would pick it)
        if g.has_edge(int(u), int(v)):
            g[int(u)][int(v)]["weight"] = max(g[int(u)][int(v)]["weight"], float(wt))
        else:
            g.add_edge(int(u), int(v), weight=float(wt))
    m = nx.max_weight_matching(g, maxcardinality=False)
    return float(sum(g[u][v]["weight"] for u, v in m))
