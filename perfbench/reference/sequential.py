"""Listing 1 and 2 of the paper as the plain loops they are, one edge at a
time: the second check of :mod:`perfbench.reference.matching` in the
tests, on small streams only.
"""
from __future__ import annotations


def part1(src, dst, weight, thr, n: int, K: int):
    """Python lists in, ``assigned`` (list of int, stream order) out."""
    m = len(src)
    L = len(thr)
    order = sorted(range(m), key=lambda e: (src[e] // K, dst[e], src[e], e))
    bits = [[False] * L for _ in range(n)]
    assigned = [-1] * m
    for e in order:
        u, v, w = src[e], dst[e], weight[e]
        if u == v:
            continue
        for i in range(L - 1, -1, -1):
            if w >= thr[i] and not bits[u][i] and not bits[v][i]:
                bits[u][i] = bits[v][i] = True
                if assigned[e] < 0:
                    assigned[e] = i
    return assigned


def part2(src, dst, assigned, n: int, L: int):
    """Sorted stream indices of the greedy merge of the recorded edges."""
    recorded = [e for e in range(len(src)) if assigned[e] >= 0]
    recorded.sort(key=lambda e: (L - 1 - assigned[e], e))
    taken = [False] * n
    out = []
    for e in recorded:
        if not taken[src[e]] and not taken[dst[e]]:
            taken[src[e]] = taken[dst[e]] = True
            out.append(e)
    return sorted(out)
