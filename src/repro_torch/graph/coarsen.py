"""Graph coarsening by matching: the paper's technique applied to the GNN
substrate.

Matched edges are contracted: both endpoints merge into one super-vertex.
Heavy-edge coarsening via MWM is the classic multilevel-partitioning move
(METIS-style); here the matcher is the substream-centric algorithm, so a
GNN pipeline gets a (4+eps)-weight coarsening pass whose Part 1 runs on the
card, through the packed per-edge kernel.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.merge import merge_host
from repro_torch.core.types import EdgeStream, SubstreamConfig, resolve_device


def coarsen_by_matching(src, dst, weight, n: int, L: int = 32, eps: float = 0.1, device=None):
    """Returns (mapping [n] -> coarse id, coarse_src, coarse_dst, coarse_w).

    Part 1 is :func:`repro_torch.kernels.substream_match.ops.substream_match`
    on the stream's own order (the per-edge kernel on the card, its plain
    version on the CPU), bit-identical to the JAX package's ``mwm_scan``;
    Part 2 is :func:`merge_host`. Coarse edge weights are summed (float32,
    in stream order) over merged multi-edges; intra-cluster edges vanish,
    and a graph left without an edge gives empty coarse arrays.
    ``device=None`` runs Part 1 on the card.
    """
    from repro_torch.kernels.substream_match.ops import substream_match  # imports core

    dev = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    stream = EdgeStream.from_numpy(src, dst, weight, device=dev)
    cfg = SubstreamConfig(n=n, L=L, eps=eps)
    res = substream_match(stream, cfg, device=dev)
    matched = merge_host(stream, res, cfg)

    mapping = np.arange(n, dtype=np.int64)
    for e in matched:
        u, v = src[e], dst[e]
        mapping[max(u, v)] = min(u, v)
    # compress ids
    uniq, mapping = np.unique(mapping, return_inverse=True)
    cs, cd = mapping[src], mapping[dst]
    keep = cs != cd
    cs, cd, cw = cs[keep], cd[keep], weight[keep]
    lo, hi = np.minimum(cs, cd), np.maximum(cs, cd)
    key = lo * len(uniq) + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, cw = key[order], lo[order], hi[order], cw[order]
    # [: len(key)]: without a coarse edge there is no first boundary (the
    # JAX package's copy raises in np.add.at there)
    boundary = np.concatenate([[True], key[1:] != key[:-1]])[: len(key)]
    group = np.cumsum(boundary) - 1
    agg_w = np.zeros(group[-1] + 1 if len(group) else 0, np.float32)
    np.add.at(agg_w, group, cw)
    return mapping, lo[boundary], hi[boundary], agg_w
