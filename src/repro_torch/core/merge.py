"""Part 2 (post processing): greedy merge of the L matchings into the MWM.

The paper runs this on the CPU (<1 % of its time, little parallelism);
so does this module, in numpy on host copies of the tensors.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import EdgeStream, MatchingResult, SubstreamConfig, to_numpy


def merge_host(
    stream: EdgeStream, result: MatchingResult, cfg: SubstreamConfig
) -> np.ndarray:
    """Faithful Listing 1 Part 2. Returns the sorted int64 stream indices of T.

    Reads only ``result.assigned``, never the matching bits. The merge
    order "descending substream i, then stream position" is one stable
    argsort over the recorded edges (key ``L-1-i``; stability supplies the
    stream-position minor key), then one greedy pass over those edges. The
    greedy pass is the dependency chain and stays a loop, like the paper's
    sequential post-processor.
    """
    assigned = to_numpy(result.assigned)
    recorded = np.nonzero(assigned >= 0)[0]
    if recorded.size == 0:
        # empty / all-dropped streams: a well-formed empty T, skipping the
        # n-sized allocation (n may be 0 here)
        return np.zeros(0, dtype=np.int64)
    order = recorded[np.argsort(cfg.L - 1 - assigned[recorded], kind="stable")]
    src = to_numpy(stream.src)[order].tolist()
    dst = to_numpy(stream.dst)[order].tolist()
    tbits = bytearray(cfg.n)
    out = []
    for e, u, v in zip(order.tolist(), src, dst):
        if not tbits[u] and not tbits[v]:
            tbits[u] = tbits[v] = 1
            out.append(e)
    return np.sort(np.asarray(out, dtype=np.int64))


def matching_weight(stream: EdgeStream, edge_idx: np.ndarray) -> float:
    """float32 sum of the weights at ``edge_idx``, as a Python float."""
    idx = np.asarray(edge_idx, dtype=np.int64)
    if idx.size == 0:
        return 0.0
    return float(to_numpy(stream.weight)[idx].sum())
