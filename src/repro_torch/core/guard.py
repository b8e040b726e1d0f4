"""Guard between edge streams and the matching core: the structured input
faults that :meth:`EdgeStream.from_numpy` reports, and the postcondition
check of a Part-1 result.

* :class:`StreamProblem` / :class:`StreamValidationError`: one class of
  input fault with its count and sample stream positions;
* :func:`check_matching` / :func:`matching_problems`: check a
  :class:`~repro_torch.core.types.MatchingResult` against the stream it
  claims to describe: recorded edges exist, are eligible for their
  substream, each vertex is matched at most once per substream, the
  matching bits agree with the recorded lists, and (optionally) the
  merged set is a matching within the (4+eps) bound of an exact optimum.

Everything here is host numpy. The eligibility check reads the
thresholds from ``cfg``, the very vector the engines used.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import to_numpy

#: How many offending stream positions a problem reports (the count is
#: always exact; the index list is a sample so errors stay readable on
#: million-edge streams).
MAX_REPORT_INDICES = 16


@dataclasses.dataclass(frozen=True)
class StreamProblem:
    """One class of input fault found in a stream.

    ``kind`` is a stable machine-readable tag, ``count`` the exact number
    of offending edges, ``indices`` the first :data:`MAX_REPORT_INDICES`
    offending stream positions.
    """

    kind: str
    count: int
    indices: tuple
    detail: str = ""

    def __str__(self) -> str:
        idx = list(self.indices)
        more = "" if self.count <= len(idx) else f" (+{self.count - len(idx)} more)"
        detail = f" — {self.detail}" if self.detail else ""
        return f"{self.kind}: {self.count} edge(s) at positions {idx}{more}{detail}"


class StreamValidationError(ValueError):
    """Strict-policy rejection of a malformed edge stream.

    ``problems`` holds the structured :class:`StreamProblem` list; the
    message enumerates every kind with counts and sample positions.
    """

    def __init__(self, problems, n=None):
        self.problems = tuple(problems)
        where = "" if n is None else f" (vertex space [0, {n}))"
        msg = "invalid edge stream" + where + ": " + "; ".join(
            str(p) for p in self.problems
        )
        super().__init__(msg)


class MatchingInvariantError(ValueError):
    """A :class:`~repro_torch.core.types.MatchingResult` violates a Part-1
    postcondition (see :func:`matching_problems` for the checks)."""

    def __init__(self, problems):
        self.problems = tuple(problems)
        super().__init__(
            "matching result violates invariants: " + "; ".join(self.problems)
        )


def _problem(kind: str, mask: np.ndarray, detail: str = "") -> StreamProblem:
    idx = np.nonzero(mask)[0]
    return StreamProblem(
        kind=kind,
        count=int(idx.size),
        indices=tuple(int(i) for i in idx[:MAX_REPORT_INDICES]),
        detail=detail,
    )


def matching_problems(
    result, stream, cfg, merged=None, exact_weight=None
) -> list[str]:
    """Check a Part-1 result (and optionally a Part-2 merge) against the
    stream it claims to describe. Returns human-readable problem strings
    (empty = every invariant holds). The checks:

    1. ``assigned`` has shape ``[m]`` with values in ``[-1, L)``;
    2. every recorded edge (``assigned >= 0``) is a valid, non-self-loop
       stream edge with in-range endpoints;
    3. eligibility: a recorded edge's weight reaches its substream's
       threshold ``cfg.thresholds()[i]``;
    4. each vertex is matched at most once per substream;
    5. the matching bits agree: a recorded edge at substream ``i`` set
       ``mb[u, i]`` and ``mb[v, i]``;
    6. (``merged`` given: stream positions of the Part-2 output ``T``)
       the merge picked recorded edges only, each at most once, and
       vertex-disjoint overall;
    7. (``exact_weight`` given as well) the merged weight honours the
       composed Crouch–Stubbs bound ``w(M*)/w(T) <= 4 + eps``.

    Pure numpy on host copies of the tensors; never raises
    (:func:`check_matching` is the raising wrapper).
    """
    problems: list[str] = []
    m = stream.num_edges
    assigned = to_numpy(result.assigned)
    if assigned.shape != (m,):
        problems.append(
            f"assigned shape {assigned.shape} != stream shape ({m},)"
        )
        return problems
    out_of_range = (assigned < -1) | (assigned >= cfg.L)
    if out_of_range.any():
        idx = np.nonzero(out_of_range)[0][:MAX_REPORT_INDICES]
        problems.append(
            f"assigned out of range [-1, {cfg.L}) at positions {idx.tolist()}"
        )
        return problems
    rec = np.nonzero(assigned >= 0)[0]
    src = to_numpy(stream.src)
    dst = to_numpy(stream.dst)
    weight = to_numpy(stream.weight)
    valid = to_numpy(stream.valid).astype(bool)
    if rec.size:
        not_valid = rec[~valid[rec]]
        if not_valid.size:
            problems.append(
                f"recorded edges at padding/invalid positions "
                f"{not_valid[:MAX_REPORT_INDICES].tolist()}"
            )
        u, v = src[rec], dst[rec]
        loops = rec[u == v]
        if loops.size:
            problems.append(
                f"recorded self-loops at positions "
                f"{loops[:MAX_REPORT_INDICES].tolist()}"
            )
        oob = rec[(u < 0) | (u >= cfg.n) | (v < 0) | (v >= cfg.n)]
        if oob.size:
            problems.append(
                f"recorded edges with endpoints outside [0, {cfg.n}) at "
                f"positions {oob[:MAX_REPORT_INDICES].tolist()}"
            )
            return problems  # the mb/disjointness checks index by vertex
        thr = cfg.thresholds()  # the vector the engines used
        with np.errstate(invalid="ignore"):
            below = ~(weight[rec].astype(np.float32) >= thr[assigned[rec]])
        if below.any():
            bad = rec[below]
            problems.append(
                f"recorded edges below their substream threshold at "
                f"positions {bad[:MAX_REPORT_INDICES].tolist()}"
            )
        # vertex matched <= once per substream: fuse (substream, vertex)
        # into one int64 key over both endpoints; duplicates = conflicts
        i64 = assigned[rec].astype(np.int64)
        keep = u != v
        keys = np.concatenate(
            [i64 * cfg.n + u.astype(np.int64), (i64 * cfg.n + v.astype(np.int64))[keep]]
        )
        uniq, counts = np.unique(keys, return_counts=True)
        dup = uniq[counts > 1]
        if dup.size:
            sample = [
                (int(k // cfg.n), int(k % cfg.n))
                for k in dup[:MAX_REPORT_INDICES]
            ]
            problems.append(
                f"vertex matched more than once in a substream "
                f"(substream, vertex) pairs {sample}"
            )
        mb = to_numpy(result.mb)
        if mb.shape != (cfg.n, cfg.L):
            problems.append(f"mb shape {mb.shape} != ({cfg.n}, {cfg.L})")
        else:
            unset = ~(mb[u, assigned[rec]] & mb[v, assigned[rec]])
            if unset.any():
                bad = rec[unset]
                problems.append(
                    f"matching bit not set for recorded edges at positions "
                    f"{bad[:MAX_REPORT_INDICES].tolist()}"
                )
    if merged is not None:
        merged = np.asarray(merged)
        if merged.size:
            if (merged < 0).any() or (merged >= m).any():
                problems.append("merged indices outside the stream")
                return problems
            if np.unique(merged).size != merged.size:
                problems.append("merged picks a stream position twice")
            un_rec = merged[assigned[merged] < 0]
            if un_rec.size:
                problems.append(
                    f"merged edges that were never recorded at positions "
                    f"{un_rec[:MAX_REPORT_INDICES].tolist()}"
                )
            mu, mv = src[merged], dst[merged]
            ends = np.concatenate([mu, mv])
            uniq, counts = np.unique(ends, return_counts=True)
            if (counts > 1).any():
                problems.append(
                    f"merged matching not vertex-disjoint at vertices "
                    f"{uniq[counts > 1][:MAX_REPORT_INDICES].tolist()}"
                )
        if exact_weight is not None:
            got = float(weight[merged].sum()) if merged.size else 0.0
            if exact_weight > 0 and got <= 0:
                problems.append(
                    f"merged weight {got} but exact optimum {exact_weight}"
                )
            elif got > 0 and exact_weight / got > 4 + cfg.eps + 1e-3:
                problems.append(
                    f"merged weight {got:.6g} violates the (4+eps) bound "
                    f"against exact {exact_weight:.6g} "
                    f"(ratio {exact_weight / got:.4f})"
                )
    return problems


def check_matching(result, stream, cfg, merged=None, exact_weight=None) -> None:
    """Raise :class:`MatchingInvariantError` unless every postcondition of
    :func:`matching_problems` holds."""
    problems = matching_problems(
        result, stream, cfg, merged=merged, exact_weight=exact_weight
    )
    if problems:
        raise MatchingInvariantError(problems)
