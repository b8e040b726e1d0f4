"""The benchmark's arithmetic: percentiles, interval unions, span self
time, idle gaps and the roofline bytes of Part 1. Pure Python, no device."""
from __future__ import annotations

import bisect
import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of all values, linear between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(jobs, window_s: float) -> float:
    """Edges of every job completed in the window over the window's whole
    length."""
    if window_s <= 0:
        raise ValueError("empty window")
    return sum(j["edges"] for j in jobs) / window_s


def union(intervals, lo: float | None = None, hi: float | None = None):
    """Sorted disjoint [start, end] intervals covering ``intervals``,
    clipped to [lo, hi] when given."""
    out = []
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Timeline:
    """The union of busy intervals, asked for the busy length of a stretch."""

    def __init__(self, intervals):
        self.spans = union(intervals)
        self.starts = [a for a, _ in self.spans]

    def busy(self, lo: float, hi: float) -> float:
        k = max(0, bisect.bisect_right(self.starts, lo) - 1)
        end = bisect.bisect_left(self.starts, hi)
        return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in self.spans[k:end])


def covered(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that ``intervals`` cover."""
    return Timeline(intervals).busy(lo, hi)


def gaps(busy, lo: float, hi: float):
    """[start, end] stretches of [lo, hi] that no busy interval covers."""
    out = []
    at = lo
    for a, b in union(busy, lo, hi):
        if a > at:
            out.append([at, a])
        at = max(at, b)
    if hi > at:
        out.append([at, hi])
    return out


def self_time(spans, parent: str, child: str):
    """Mean over the ``parent`` spans of their length less that of the
    ``child`` spans inside them; None without a parent span or where a
    parent holds no child (the child layer was not reached).
    ``spans`` are (name, start, end) tuples."""
    parents = [s for s in spans if s[0] == parent]
    kids = [s for s in spans if s[0] == child]
    if not parents:
        return None
    total = 0.0
    for _, a, b in parents:
        inner = [(c, d) for _, c, d in kids if a <= c and d <= b]
        if not inner:
            return None
        total += (b - a) - covered(inner, a, b)
    return total / len(parents)


def dominant(spans, lo: float, hi: float, frames=()):
    """Name of the span that covers most of [lo, hi], the shorter one on a
    tie; spans named in ``frames`` (those that hold whole jobs) only where
    no other span overlaps. None where no span overlaps."""
    best = None
    for name, a, b in spans:
        over = min(b, hi) - max(a, lo)
        if over <= 0:
            continue
        key = (name not in frames, over, a - b)
        if best is None or key > best[0]:
            best = (key, name)
    return None if best is None else best[1]


def part1_bytes(m: int, n: int, L: int) -> int:
    """Least bytes Part 1 moves for one job, counted from its shapes: each
    edge's pair (8 B) and weight (4 B) read and its substream (4 B) written
    once, the ``L`` float32 thresholds read once, and the bit block of
    ``n`` rows of ``ceil(L/8)`` bytes written once."""
    return 16 * m + 4 * L + n * -(-L // 8)
