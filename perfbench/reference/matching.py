"""Plain reference of the substream-centric (4+eps)-approximate MWM.

Written from the paper (Besta et al., Listings 1 and 2) and imports
nothing of the program under test:

* blocked order (Listing 2): edges sorted by ``(u // K, v, u)``, ties in
  stream order;
* Part 1 (Listing 1): substream ``i`` admits the edges with
  ``w >= thr[i]`` and keeps the greedy maximal matching of them in blocked
  order; an edge is recorded in the highest substream that matched it;
* Part 2: the recorded edges, by descending substream and then stream
  position, merged by one more greedy maximal matching.

A greedy maximal matching under a total order is computed in rounds: every
live edge that is the least live edge at both its endpoints joins, and the
edges it touches die. That fixed point is the sequential greedy matching
(:mod:`perfbench.reference.sequential` is the loop it is tested against).
The edges are taken in chunks of consecutive priority: a chunk's rounds
start from the vertices that earlier chunks took, which is the same
fixed point at a fraction of the work (the blocked order's chains are
long, and most edges stay live through them). The substreams run side by
side as disjoint copies of the vertex set.
"""
from __future__ import annotations

import numpy as np
import torch

_BIG = torch.iinfo(torch.int32).max


def thresholds(L: int, eps: float) -> np.ndarray:
    """float32 [L]: ``(1+eps)^i`` worked out in float64, rounded once."""
    return ((1.0 + eps) ** np.arange(L, dtype=np.float64)).astype(np.float32)


def blocked_order(src: torch.Tensor, dst: torch.Tensor, n: int, K: int) -> torch.Tensor:
    """int64 permutation sorting edges by (u // K, v, u), stable."""
    u, v = src.to(torch.int64), dst.to(torch.int64)
    key = ((u // K) * n + v) * K + u % K
    return torch.sort(key, stable=True).indices


def greedy(src, dst, top, n: int, lanes: int, chunk: int):
    """Greedy maximal matchings of edges ``(src[e], dst[e])`` (int64,
    ids below ``n``) taken in index order, one matching per lane; edge
    ``e`` takes part in lanes ``0..top[e]`` (none where ``top[e] < 0``).
    Returns (int32 [m]: the highest lane each edge joined or -1, rounds)."""
    m = src.shape[0]
    if m >= _BIG:
        raise ValueError(f"{m} edges: priorities are int32")
    dev = src.device
    joined = torch.full((m,), -1, dtype=torch.int32, device=dev)
    taken = torch.zeros(lanes * n, dtype=torch.bool, device=dev)
    least = torch.full((lanes * n,), _BIG, dtype=torch.int32, device=dev)
    rounds = 0
    for lo in range(0, m, chunk):
        e = torch.arange(lo, min(m, lo + chunk), device=dev)
        ok = (top[e] >= 0) & (src[e] != dst[e])
        cnt = torch.where(ok, top[e] + 1, 0)
        edge = torch.repeat_interleave(e, cnt)
        first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
        lane = torch.arange(edge.shape[0], device=dev) - first
        a = lane * n + src[edge]
        b = lane * n + dst[edge]
        live = torch.nonzero(~(taken[a] | taken[b])).flatten()
        while live.numel():
            rounds += 1
            la, lb, pr = a[live], b[live], edge[live].to(torch.int32)
            least.scatter_reduce_(0, la, pr, "amin")
            least.scatter_reduce_(0, lb, pr, "amin")
            win = (least[la] == pr) & (least[lb] == pr)
            least[la] = _BIG
            least[lb] = _BIG
            joined.scatter_reduce_(0, edge[live[win]], lane[live[win]].to(torch.int32), "amax")
            taken[la[win]] = True
            taken[lb[win]] = True
            live = live[~(taken[la] | taken[lb])]
    return joined, rounds


def part1(src, dst, weight, thr, n: int, K: int, chunk: int = 1 << 20):
    """Listing 2's Part 1. Returns (assigned int32 [m] in stream order,
    each edge's highest matching substream or -1; rounds)."""
    order = blocked_order(src, dst, n, K)
    bs, bd = src[order].to(torch.int64), dst[order].to(torch.int64)
    # highest substream each edge is admitted to (thr non-decreasing)
    top = torch.searchsorted(thr, weight[order], right=True) - 1
    L = thr.shape[0]
    assigned_b, rounds = greedy(bs, bd, top, n, L, max(1, chunk))
    assigned = torch.empty_like(assigned_b)
    assigned[order] = assigned_b
    return assigned, rounds


def part2(src, dst, assigned, n: int, L: int, chunk: int = 1 << 20):
    """Part 2: int64 [k] sorted stream indices of the merged matching."""
    recorded = torch.nonzero(assigned >= 0).flatten()
    order = recorded[torch.sort((L - 1) - assigned[recorded], stable=True).indices]
    top = torch.zeros(order.shape, dtype=torch.int64, device=src.device)
    joined, _ = greedy(src[order].to(torch.int64), dst[order].to(torch.int64), top, n, 1,
                       chunk)
    return torch.sort(order[joined >= 0]).values


def mwm(src, dst, weight, thr, n: int, K: int, chunk: int | None = None,
        precision: str = "float32"):
    """Both parts on the tensors' device. Returns (sorted int64 numpy
    indices, the matching's weight, Part 1's rounds, recorded edges).

    ``precision="float32"`` is the reference: float32 comparisons, the
    weight summed in float64. ``"bfloat16"`` is its control, one precision
    below: weights and thresholds rounded to bfloat16, the weight summed
    in float32. ``chunk`` edges are matched at a time (default: about
    2^23 edge-substream pairs).
    """
    thr = torch.as_tensor(thr, dtype=torch.float32, device=src.device)
    if precision == "bfloat16":
        weight = weight.to(torch.bfloat16).to(torch.float32)
        thr = thr.to(torch.bfloat16).to(torch.float32)
        acc = torch.float32
    elif precision == "float32":
        acc = torch.float64
    else:
        raise ValueError(f"unknown precision {precision!r}")
    L = thr.shape[0]
    chunk = chunk or max(1, (1 << 23) // L)
    assigned, rounds = part1(src, dst, weight, thr, n, K, chunk)
    idx = part2(src, dst, assigned, n, L, chunk * L)
    w = float(weight[idx].to(acc).sum())
    recorded = int((assigned >= 0).sum())
    return idx.cpu().numpy(), w, rounds, recorded
