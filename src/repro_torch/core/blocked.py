"""Blocking and lexicographic ordering (Listing 2 / SC-OPT).

§4.2: merge K adjacent adjacency-matrix rows into an *epoch* and order the
epoch's edges lexicographically by ``(epoch(u), v, u)`` (weight ignored).
On the card this order keeps the u rows of an epoch hot and sweeps the v
rows of the bit block in ascending order.

Reordering changes *which* maximal matching each substream yields, but
any maximal matching preserves the (4+eps) bound, the argument the paper
uses for SC-OPT vs CS-SEQ.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.matching import mwm_scan
from repro_torch.core.types import EdgeStream, MatchingResult, SubstreamConfig, resolve_device

_I32_MAX = torch.iinfo(torch.int32).max


def lexicographic_order(stream: EdgeStream, K: int) -> torch.Tensor:
    """int64 permutation sorting edges by (epoch(u), v, u, stream position),
    epoch(u) = u // K; invalid (padding) edges sort to the end.

    Three chained stable sorts, least significant key first (u, then v,
    then epoch): a fused int64 key would overflow at large n.
    """
    u, v = stream.src, stream.dst
    epoch = torch.where(stream.valid, torch.div(u, K, rounding_mode="floor"), _I32_MAX)
    order = torch.argsort(u, stable=True)
    order = order[torch.argsort(v[order], stable=True)]
    return order[torch.argsort(epoch[order], stable=True)]


def permute_stream(stream: EdgeStream, order: torch.Tensor) -> EdgeStream:
    return EdgeStream(
        src=stream.src[order],
        dst=stream.dst[order],
        weight=stream.weight[order],
        valid=stream.valid[order],
    )


def mwm_blocked(
    stream: EdgeStream,
    cfg: SubstreamConfig,
    K: int = 32,
    backend: str = "scan",
    device=None,
    telemetry=obs.DISABLED,
    **kernel_kwargs,
) -> MatchingResult:
    """Listing 2: lexicographic blocked processing.

    backend='scan'   : the CS-SEQ loop over the blocked order (reference).
    backend='kernel' : :func:`repro_torch.kernels.substream_match.ops.substream_match`
                       (the SC-OPT path; the CUDA kernels on the card), with
                       ``kernel_kwargs`` (``schedule=``, ``packed=``,
                       ``seg_block=``, ...).

    ``assigned`` is returned in the *original* stream order.

    ``telemetry`` (resolved by :func:`repro_torch.obs.active`) records one
    ``blocked`` span holding ``stream.to`` (where the stream is copied),
    ``blocked.order`` (the three sorts), ``blocked.permute``, Part 1's own
    spans and ``blocked.unpermute``; each ends with a synchronise.
    """
    from repro_torch.kernels.substream_match.ops import substream_match  # imports core

    if backend not in ("scan", "kernel"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    tel = obs.active(telemetry)
    with tel.span("blocked", sync=dev):
        stream = stream.to(dev, telemetry=tel)
        with tel.span("blocked.order", sync=dev):
            order = lexicographic_order(stream, K)
        with tel.span("blocked.permute", sync=dev):
            blocked = permute_stream(stream, order)
        if backend == "scan":
            res = mwm_scan(blocked, cfg, device=dev)
        else:
            res = substream_match(blocked, cfg, device=dev, telemetry=tel, **kernel_kwargs)
        with tel.span("blocked.unpermute", sync=dev):
            assigned = torch.empty_like(res.assigned)
            assigned[order] = res.assigned
    return res.with_assigned(assigned)
