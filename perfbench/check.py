"""The comparison that decides ``correct``: every job of the window on the
checked pool graphs against the plain reference on the same graph.

Numbers compared, each against its limit (the configuration file's
``limits``; a number passes when it is at most its limit):

* ``mismatched_edges``: over the checked jobs, the edges in one matching
  and not the other (a repeated index counts as a mismatch);
* ``weight_rel_gap``: the largest ``|w - w_ref| / w_ref`` of a checked job;
* ``unchecked_graphs``: checked graphs that no job of the window reached.
"""
from __future__ import annotations

import math

import numpy as np

NAMES = ("mismatched_edges", "weight_rel_gap", "unchecked_graphs")


def mismatches(idx, ref_idx) -> int:
    """Size of the symmetric difference of two index lists, counting a
    repeated index of ``idx`` as one more mismatch."""
    a = np.asarray(idx, dtype=np.int64)
    b = np.asarray(ref_idx, dtype=np.int64)
    return int(a.size + b.size - 2 * np.intersect1d(a, b).size)


def compare(answers: dict, refs: dict, limits: dict) -> dict:
    """``answers`` {graph: [(idx, weight), ...]} of the window's jobs,
    ``refs`` {graph: (idx, weight)} of the reference. Returns {name:
    {"value", "limit", "ok"}} in :data:`NAMES` order."""
    mism, rels, unchecked = 0, [], 0
    for g, (ref_idx, ref_w) in refs.items():
        got = answers.get(g, [])
        unchecked += not got
        for idx, w in got:
            mism += mismatches(idx, ref_idx)
            rels.append(abs(float(w) - ref_w) / abs(ref_w) if ref_w else abs(float(w)))
    gap = max(rels, default=0.0) if all(map(math.isfinite, rels)) else math.nan
    out = {}
    for name, value in zip(NAMES, (mism, gap, unchecked)):
        limit = limits[name]
        ok = math.isfinite(value) and value <= limit
        out[name] = {"value": value if math.isfinite(value) else None,
                     "limit": limit, "ok": ok}
    return out


def correct(numbers: dict) -> bool:
    return all(v["ok"] for v in numbers.values())


def lines(numbers: dict) -> list[str]:
    """One plain line per number: name, value, limit."""
    return [f"{k} {v['value']} limit {v['limit']} {'ok' if v['ok'] else 'FAIL'}"
            for k, v in numbers.items()]
