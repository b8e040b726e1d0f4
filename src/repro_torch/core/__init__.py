"""Substream-centric maximum weighted matching, the paper's contribution.

Public API:
  EdgeStream, SubstreamConfig, MatchingResult  — data types
  mwm_scan              — faithful Listing 1 Part 1 (CS-SEQ oracle)
  mwm_waves             — the same over conflict-free waves (plain oracle)
  mwm_blocked           — Listing 2 blocked/lexicographic (SC-OPT path)
  merge_host            — Part 2 greedy merge on the host (on the card:
                          repro_torch.kernels.substream_match.ops.merge_device)
  exact_mwm_weight      — networkx oracle (tests)
  mwm_pipeline          — end to end: Part 1 + Part 2 → matching + weight
  validate_stream / check_matching — input guard + result invariants
                          (strict / sanitize / off, repro_torch.core.guard)
  MatchState            — resumable per-stream-position state (repro_torch.core.state)
  ExecutionGuard        — deadline/retry/straggler guard (repro_torch.core.executor)
"""
from __future__ import annotations

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
from repro_torch.core.matching import mwm_scan, mwm_waves
from repro_torch.core.state import MatchState, fingerprint_for
from repro_torch.core.blocked import mwm_blocked, lexicographic_order, permute_stream
from repro_torch.core.merge import merge_host, matching_weight
from repro_torch.core.exact import exact_mwm_weight


def mwm_pipeline(
    stream: EdgeStream,
    cfg: SubstreamConfig,
    part1: str = "scan",
    K: int = 32,
    device=None,
    **kw,
):
    """End-to-end (4+eps)-approximate MWM. Returns (edge_indices, weight).

    part1 in {'scan', 'waves', 'blocked', 'kernel'}: the CS-SEQ loop, the
    plain wave engine (``kw`` to :func:`mwm_waves`), the blocked order
    through the CS-SEQ loop, or the blocked order through the CUDA kernels
    (the JAX package's ``"pallas"``; ``kw`` to ``substream_match``, e.g.
    ``schedule="mega"`` or ``packed=False`` for the unpacked int8 block).
    ``device=None`` runs on the card.
    """
    if part1 == "rounds":
        raise NotImplementedError(
            f"part1={part1!r} is not ported yet (ROADMAP.md §1 item 7)"
        )
    dev = resolve_device(device)
    if part1 == "scan":
        res = mwm_scan(stream, cfg, device=dev)
    elif part1 == "waves":
        res = mwm_waves(stream, cfg, device=dev, **kw)
    elif part1 == "blocked":
        res = mwm_blocked(stream, cfg, K=K, backend="scan", device=dev)
    elif part1 == "kernel":
        res = mwm_blocked(stream, cfg, K=K, backend="kernel", device=dev, **kw)
    else:
        raise ValueError(part1)
    idx = merge_host(stream, res, cfg)
    return idx, matching_weight(stream, idx)


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
    "mwm_blocked",
    "lexicographic_order",
    "permute_stream",
    "merge_host",
    "matching_weight",
    "exact_mwm_weight",
    "mwm_pipeline",
    "MatchState",
    "fingerprint_for",
    "ExecutionGuard",
    "DeadlineExceededError",
    "RetriesExhaustedError",
    "is_transient",
]
