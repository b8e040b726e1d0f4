"""Substream-centric maximum weighted matching, the paper's contribution.

Public API:
  EdgeStream, SubstreamConfig, MatchingResult  — data types
  mwm_scan              — faithful Listing 1 Part 1 (CS-SEQ oracle)
  mwm_waves             — the same over conflict-free waves (plain oracle)
  mwm_blocked           — Listing 2 blocked/lexicographic (SC-OPT path)
  merge_host            — Part 2 greedy merge
  exact_mwm_weight      — networkx oracle (tests)
  mwm_pipeline          — end to end: Part 1 + Part 2 → matching + weight
  check_matching        — result invariants (repro_torch.core.guard)
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
    check_matching,
    matching_problems,
)
from repro_torch.core.matching import mwm_scan, mwm_waves
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
    "check_matching",
    "matching_problems",
    "StreamValidationError",
    "MatchingInvariantError",
    "mwm_scan",
    "mwm_waves",
    "mwm_blocked",
    "lexicographic_order",
    "permute_stream",
    "merge_host",
    "matching_weight",
    "exact_mwm_weight",
    "mwm_pipeline",
]
