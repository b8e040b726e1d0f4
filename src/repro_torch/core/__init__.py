"""Substream-centric maximum weighted matching, the paper's contribution.

Public API:
  EdgeStream, SubstreamConfig, MatchingResult  — data types
  mwm_scan              — faithful Listing 1 Part 1 (CS-SEQ oracle)
  mwm_waves             — the same over conflict-free waves (plain oracle)
  substream_matchings   — full [m, L] per-substream membership
  mwm_blocked           — Listing 2 blocked/lexicographic (SC-OPT path)
  mwm_rounds(_sharded)  — deterministic parallel rounds (beyond-paper; the
                          sharded one over torch.distributed)
  merge_host            — Part 2 greedy merge on the host (the CPU route of
                          mwm_pipeline; on the card it merges with
                          repro_torch.kernels.substream_match.ops.merge_device)
  gseq                  — Ghaffari (2+eps) baseline (G-SEQ)
  exact_mwm_weight      — networkx oracle (tests)
  mwm_pipeline          — end to end: Part 1 + Part 2 → matching + weight
  validate_stream / check_matching — input guard + result invariants
                          (strict / sanitize / off, repro_torch.core.guard)
  MatchState            — resumable per-stream-position state (repro_torch.core.state)
  ExecutionGuard        — deadline/retry/straggler guard (repro_torch.core.executor)
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.bitpack import pack_bits, packed_width, unpack_bits
from repro_torch.core.types import (
    EdgeStream,
    MatchingResult,
    SubstreamConfig,
    resolve_device,
)
from repro_torch.core.guard import (
    MatchingInvariantError,
    StreamValidationError,
    ValidationReport,
    check_matching,
    matching_problems,
    stream_problems,
    validate_stream,
)
from repro_torch.core.executor import (
    DeadlineExceededError,
    ExecutionGuard,
    RetriesExhaustedError,
    is_transient,
)
from repro_torch.core.matching import mwm_scan, mwm_waves, substream_matchings
from repro_torch.core.state import MatchState, fingerprint_for
from repro_torch.core.blocked import mwm_blocked, lexicographic_order, permute_stream
from repro_torch.core.rounds import mwm_rounds, mwm_rounds_sharded
from repro_torch.core.merge import merge_host, matching_weight
from repro_torch.core.gseq import gseq
from repro_torch.core.exact import exact_mwm_weight


def mwm_pipeline(
    stream: EdgeStream,
    cfg: SubstreamConfig,
    part1: str = "scan",
    K: int = 32,
    device=None,
    telemetry=obs.DISABLED,
    **kw,
):
    """End-to-end (4+eps)-approximate MWM. Returns (edge_indices, weight).

    part1 in {'scan', 'waves', 'blocked', 'kernel', 'rounds'}: the CS-SEQ
    loop, the plain wave engine (``kw`` to :func:`mwm_waves`), the blocked
    order through the CS-SEQ loop, the blocked order through the CUDA
    kernels (the JAX package's ``"pallas"``; ``kw`` to ``substream_match``,
    e.g. ``schedule="mega"`` or ``packed=False`` for the unpacked int8
    block), or the parallel rounds on the stream's own order. ``device=None``
    runs on the card.

    Part 2 runs where Part 1's result lives. On the card the stream is
    copied there once, Part 1 and
    :func:`repro_torch.kernels.substream_match.ops.merge_device` (the merge
    as a one-substream Part 1 through the per-edge kernel) both take that
    copy, and only the matched indices come back to the host; ``assigned``
    never does. On the CPU the merge is :func:`merge_host`, the reference
    semantics. Both give the same indices, and the weight is summed on the
    host from the stream as passed, so the result does not depend on the
    route.

    ``telemetry`` (resolved by :func:`repro_torch.obs.active`, so a
    ``torch.profiler`` window records without it) records one ``pipeline``
    span (args ``call``, the call's number in the session, ``m`` and
    ``part1``) holding, on the card, the stream's ``stream.to``, Part 1's
    spans, ``merge.device`` and ``merge.d2h`` (the matched indices to the
    host; arg ``bytes``), and on the CPU Part 1's spans and ``merge.host``;
    then ``merge.weight``.
    """
    dev = resolve_device(device)
    if part1 not in ("scan", "waves", "blocked", "kernel", "rounds"):
        raise ValueError(part1)
    tel = obs.active(telemetry)
    on_card = dev.type == "cuda"
    with tel.span("pipeline", sync=dev) as span:
        if tel.enabled:
            span.note(call=tel.pipeline_calls, m=stream.num_edges, part1=part1)
            tel.pipeline_calls += 1
        work = stream.to(dev, telemetry=tel) if on_card else stream
        if part1 == "scan":
            res = mwm_scan(work, cfg, device=dev)
        elif part1 == "waves":
            res = mwm_waves(work, cfg, device=dev, telemetry=tel, **kw)
        elif part1 == "blocked":
            res = mwm_blocked(work, cfg, K=K, backend="scan", device=dev, telemetry=tel)
        elif part1 == "kernel":
            res = mwm_blocked(work, cfg, K=K, backend="kernel", device=dev, telemetry=tel,
                              **kw)
        else:
            res = mwm_rounds(work, cfg, device=dev, telemetry=tel)
        if on_card:
            idx = _merge_on_device(work, res, cfg, tel)
        else:
            idx = merge_host(stream, res, cfg, telemetry=tel)
        with tel.span("merge.weight"):
            weight = matching_weight(stream, idx)
    return idx, weight


def _merge_on_device(stream: EdgeStream, res: MatchingResult, cfg: SubstreamConfig, tel):
    """Part 2 on the device of ``stream`` and ``res``: ``merge_device``'s
    mask, then its sorted int64 indices copied to the host (``merge.d2h``,
    arg ``bytes``)."""
    from repro_torch.kernels.substream_match.ops import merge_device  # imports core

    mask = merge_device(stream, res, cfg, telemetry=tel, device=stream.device)
    with tel.span("merge.d2h") as span:
        idx = torch.nonzero(mask).flatten()
        if tel.enabled:
            span.note(bytes=idx.nbytes)
        return idx.cpu().numpy()


__all__ = [
    "EdgeStream",
    "MatchingResult",
    "SubstreamConfig",
    "resolve_device",
    "pack_bits",
    "packed_width",
    "unpack_bits",
    "validate_stream",
    "stream_problems",
    "check_matching",
    "matching_problems",
    "StreamValidationError",
    "MatchingInvariantError",
    "ValidationReport",
    "mwm_scan",
    "mwm_waves",
    "substream_matchings",
    "mwm_blocked",
    "lexicographic_order",
    "permute_stream",
    "mwm_rounds",
    "mwm_rounds_sharded",
    "merge_host",
    "matching_weight",
    "gseq",
    "exact_mwm_weight",
    "mwm_pipeline",
    "MatchState",
    "fingerprint_for",
    "ExecutionGuard",
    "DeadlineExceededError",
    "RetriesExhaustedError",
    "is_transient",
]
