"""Guard between edge streams and the matching core: input validation
and the postcondition check of a Part-1 result.

* :func:`validate_stream` / :func:`stream_problems`: the precondition
  check with three policies: ``strict`` (raise a structured
  :class:`StreamValidationError` listing the offending stream positions),
  ``sanitize`` (drop the bad edges, report what was dropped through
  telemetry counters) and ``off`` (no check at all, for trusted paths);
* :func:`check_matching` / :func:`matching_problems`: check a
  :class:`~repro_torch.core.types.MatchingResult` against the stream it
  claims to describe: recorded edges exist, are eligible for their
  substream, each vertex is matched at most once per substream, the
  matching bits agree with the recorded lists, and (optionally) the
  merged set is a matching within the (4+eps) bound of an exact optimum.

The stream checks run in torch on the stream's own device: only the
counts and the first :data:`MAX_REPORT_INDICES` offending positions of
each fault come to the host. The postcondition check is host numpy; its
eligibility check reads the thresholds from ``cfg``, the very vector the
engines used. The fallback cascade that consumes these guards lives in
:mod:`repro_torch.kernels.substream_match.ops` (``on_plan_failure=``);
the fault injector that proves they fire lives in
:mod:`repro_torch.testing.faultline`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import EdgeStream, to_numpy

#: Accepted validation policies, in decreasing strictness.
POLICIES = ("strict", "sanitize", "off")

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


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """What :func:`validate_stream` saw (and, under ``sanitize``, did).

    ``num_valid_in`` counts the valid edges before the policy ran,
    ``num_dropped`` how many of them ``sanitize`` masked out (always 0
    under ``strict``/``off``: strict raises instead of dropping).
    """

    policy: str
    n: int
    num_edges: int
    num_valid_in: int
    num_dropped: int
    problems: tuple = ()

    @property
    def ok(self) -> bool:
        return not self.problems

    @property
    def degenerate(self) -> bool:
        """True when nothing can ever match (no valid edges, or n < 2)."""
        return self.num_valid_in - self.num_dropped == 0 or self.n < 2

    def counters(self) -> dict:
        """The ``guard.*`` counter set (telemetry)."""
        out = {
            "guard.num_edges": int(self.num_edges),
            "guard.num_valid_in": int(self.num_valid_in),
            "guard.dropped_edges": int(self.num_dropped),
            "guard.num_problems": int(len(self.problems)),
        }
        for p in self.problems:
            out[f"guard.fault.{p.kind}"] = int(p.count)
        return out


def _problem(kind: str, mask, detail: str = "") -> StreamProblem:
    """A problem from a bool mask over the stream (numpy or torch): the
    exact count, and only the first :data:`MAX_REPORT_INDICES` positions
    copied to the host."""
    if isinstance(mask, torch.Tensor):
        count = int(mask.sum())
        idx = torch.nonzero(mask).flatten()[:MAX_REPORT_INDICES].tolist()
    else:
        where = np.nonzero(mask)[0]
        count, idx = int(where.size), where[:MAX_REPORT_INDICES].tolist()
    return StreamProblem(kind=kind, count=count, indices=tuple(int(i) for i in idx),
                         detail=detail)


def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x), device=device)


def _bad_masks(src, dst, weight, valid, n: int):
    """(bad id, non-finite weight, negative weight) masks over the valid edges."""
    bad_id = valid & ((src < 0) | (src >= n) | (dst < 0) | (dst >= n))
    finite = torch.isfinite(weight)
    return bad_id, valid & ~finite, valid & finite & (weight < 0)


def stream_problems(src, dst, weight, valid, n: int) -> list[StreamProblem]:
    """Pure fault detector: stream arrays in (tensors on any device, or
    array-likes), :class:`StreamProblem` list out.

    Only *valid* (non-padding) edges are examined: padding edges are a
    legitimate encoding, whatever their slots hold. Checks, in taxonomy
    order:

    * ``empty_vertex_space``: valid edges exist but ``n < 1``;
    * ``id_out_of_range``: an endpoint outside ``[0, n)``, which covers
      negative ids, ids at or past ``n``, and the sacrificial padding row
      ``n_pad`` the wave kernels point padding slots at (a real edge
      there would alias it);
    * ``nonfinite_weight``: NaN or ±Inf (+Inf matches *every* substream;
      NaN silently never matches; both void the (2+eps) analysis);
    * ``negative_weight``: finite ``w < 0``.
    """
    valid = _as_tensor(valid).to(torch.bool)
    dev = valid.device
    src, dst, weight = (_as_tensor(x, dev) for x in (src, dst, weight))
    problems: list[StreamProblem] = []
    if not bool(valid.any()):
        return problems
    if n < 1:
        problems.append(_problem("empty_vertex_space", valid, detail=f"n = {n}"))
        return problems
    bad_id, nonfinite, negative = _bad_masks(src, dst, weight, valid, n)
    if bool(bad_id.any()):
        problems.append(
            _problem("id_out_of_range", bad_id, detail=f"ids must be in [0, {n})")
        )
    if bool(nonfinite.any()):
        problems.append(_problem("nonfinite_weight", nonfinite))
    if bool(negative.any()):
        problems.append(_problem("negative_weight", negative))
    return problems


def validate_stream(stream, n: int, policy: str = "strict", telemetry=obs.DISABLED):
    """Validate (and under ``sanitize`` repair) an edge stream for ``n`` vertices.

    Returns ``(stream, report)``:

    * ``policy="off"``: no checks at all (the returned stream *is* the
      input, the report is empty);
    * ``policy="strict"``: raise :class:`StreamValidationError` naming
      every fault kind with counts and sample stream positions; the
      stream passes through untouched when clean;
    * ``policy="sanitize"``: mask every faulty edge out of ``valid`` and
      zero its slots, as padding is encoded (dropping, never clamping: a
      clamped id or weight would silently change which edges can match),
      on the stream's device; report what was dropped via the ``guard.*``
      telemetry counters and a ``guard.sanitize`` event.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown validation policy {policy!r}; use one of {POLICIES}")
    m = stream.num_edges
    if policy == "off":
        return stream, ValidationReport(
            policy=policy, n=n, num_edges=m, num_valid_in=-1, num_dropped=0
        )
    with telemetry.span("guard.validate", policy=policy):
        valid = stream.valid.to(torch.bool)
        num_valid_in = int(valid.sum())
        problems = stream_problems(stream.src, stream.dst, stream.weight, valid, n)
    if telemetry.enabled:
        telemetry.counters.add("guard.validate.calls")
    if not problems:
        report = ValidationReport(
            policy=policy, n=n, num_edges=m, num_valid_in=num_valid_in, num_dropped=0,
        )
        if telemetry.enabled:
            telemetry.counters.update(report.counters())
        return stream, report
    if policy == "strict":
        if telemetry.enabled:
            telemetry.event(
                "guard.reject",
                policy=policy,
                kinds=[p.kind for p in problems],
                bad_edges=sum(p.count for p in problems),
            )
            telemetry.counters.add("guard.rejected_streams")
        raise StreamValidationError(problems, n=n)

    # sanitize: drop every faulty edge (valid=False) and zero its slots, so
    # downstream paths see the same benign encoding padding uses
    if n < 1:
        bad = valid
    else:
        bad_id, nonfinite, negative = _bad_masks(stream.src, stream.dst, stream.weight, valid, n)
        bad = bad_id | nonfinite | negative
    clean = EdgeStream(
        src=torch.where(bad, 0, stream.src).to(torch.int32),
        dst=torch.where(bad, 0, stream.dst).to(torch.int32),
        weight=torch.where(bad, 0.0, stream.weight).to(torch.float32),
        valid=valid & ~bad,
    )
    report = ValidationReport(
        policy=policy, n=n, num_edges=m, num_valid_in=num_valid_in,
        num_dropped=int(bad.sum()), problems=tuple(problems),
    )
    if telemetry.enabled:
        telemetry.counters.update(report.counters())
        telemetry.event(
            "guard.sanitize",
            dropped=report.num_dropped,
            kinds=[p.kind for p in problems],
        )
    return clean, report


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


def check_matching(
    result, stream, cfg, merged=None, exact_weight=None, telemetry=obs.DISABLED
) -> None:
    """Raise :class:`MatchingInvariantError` unless every postcondition of
    :func:`matching_problems` holds. Records one ``guard.check_matching``
    span and the ``guard.invariant_violations`` counter when telemetry is
    enabled."""
    with telemetry.span("guard.check_matching"):
        problems = matching_problems(
            result, stream, cfg, merged=merged, exact_weight=exact_weight
        )
    if telemetry.enabled:
        telemetry.counters.add("guard.check_matching.calls")
        if problems:
            telemetry.counters.add("guard.invariant_violations", len(problems))
            telemetry.event("guard.invariant_violation", problems=problems)
    if problems:
        raise MatchingInvariantError(problems)
