"""Typed and padded entry point of Part 1: :func:`substream_match`.

The bit block is ``mb[n_pad, width]`` uint8, bit ``j`` of word ``k`` =
substream ``8k + j`` (:mod:`repro_torch.core.bitpack`). :func:`device_plan`
gives its geometry on the H100: at the paper's size (2^20 vertices, L=64)
it is 8 MiB and stays resident in the card's 50 MB L2.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core.types import MatchingResult, SubstreamConfig, resolve_device
from repro_torch.kernels.substream_match import kernel as _kernel

#: L2 cache of one H100
L2_BYTES = 50 * 2**20


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Geometry of the bit block: ``n_pad`` rows of ``width`` uint8 words
    (``words = ceil(L/8)`` of them hold bits, the rest are +inf-threshold
    padding), ``nbytes = n_pad * width``, and whether it fits the L2."""

    n_pad: int
    width: int
    words: int
    nbytes: int
    fits_l2: bool


def device_plan(n: int, L: int, free_bytes: int | None = None) -> DevicePlan:
    """Plan the bit block for ``n`` vertices and ``L`` substreams.

    Raises ``ValueError`` when ``free_bytes`` (the card's free memory) is
    given and the block would not fit in it.
    """
    n_pad = _round_up(max(n, 1), 8)
    words = bitpack.packed_width(max(L, 1))
    width = _round_up(words, 8)
    nbytes = n_pad * width
    if free_bytes is not None and nbytes > free_bytes:
        raise ValueError(
            f"matching-bit block {nbytes / 2**20:.1f} MiB > "
            f"{free_bytes / 2**20:.1f} MiB free on the card"
        )
    return DevicePlan(
        n_pad=n_pad, width=width, words=words, nbytes=nbytes,
        fits_l2=nbytes <= L2_BYTES,
    )


def _thresholds_padded(cfg: SubstreamConfig, width: int, device) -> torch.Tensor:
    """Kernel-shaped thresholds: [8, width] bit planes, thr[j, k] =
    substream 8k+j, +inf pads."""
    flat = np.full(width * bitpack.BITS, np.inf, np.float32)
    flat[: cfg.L] = cfg.thresholds()
    return torch.from_numpy(flat.reshape(width, bitpack.BITS).T.copy()).to(device)


def _mb0_pad(mb0: torch.Tensor, n: int, words: int, rows: int, width: int, device):
    """Pad caller-format initial bits (uint8 [n, words]) to the kernel's
    block [rows, width]; the padding is zero."""
    if tuple(mb0.shape) != (n, words):
        raise ValueError(f"mb0 shape {tuple(mb0.shape)} != ({n}, {words})")
    out = torch.zeros((rows, width), dtype=torch.uint8, device=device)
    out[:n, :words] = mb0.to(device=device, dtype=torch.uint8)
    return out


def _empty_result(stream, cfg: SubstreamConfig) -> MatchingResult:
    """Well-formed nothing-matched result (n == 0 vertex spaces)."""
    dev = stream.device
    return MatchingResult(
        assigned=torch.full((stream.num_edges,), -1, dtype=torch.int32, device=dev),
        mb_packed=torch.zeros(
            (0, bitpack.packed_width(max(cfg.L, 1))), dtype=torch.uint8, device=dev
        ),
        L=cfg.L,
    )


def substream_match(
    stream,
    cfg: SubstreamConfig,
    mb0: torch.Tensor | None = None,
    device=None,
    schedule: str = "edges",
) -> MatchingResult:
    """Run Part 1 on the given stream order, one edge at a time.

    ``mb0`` (uint8 ``[n, ceil(L/8)]``) seeds the matching bits with
    carried-in state; default zeros. ``device=None`` runs on the CUDA card
    through the kernel; ``device="cpu"`` runs the plain version. Invalid
    edges enter with weight 0 and vertex 0, below every threshold, so they
    never match. Returns packed storage: ``mb_packed`` uint8
    ``[n, ceil(L/8)]``.

    Only ``schedule="edges"`` with ``mb_layout="packed"`` is ported; the
    wave schedules and the unpacked layout raise ``NotImplementedError``.
    """
    if schedule in ("waves", "mega"):
        raise NotImplementedError(
            f"schedule={schedule!r} is not ported yet (ROADMAP.md §1 item 6)"
        )
    if schedule != "edges":
        raise ValueError(f"unknown schedule {schedule!r}")
    if cfg.mb_layout == "unpacked":
        raise NotImplementedError(
            "mb_layout='unpacked' is not ported yet (ROADMAP.md §1 item 8)"
        )
    if cfg.mb_layout != "packed":
        raise ValueError(f"unknown mb_layout {cfg.mb_layout!r}")
    dev = resolve_device(device)
    stream = stream.to(dev)
    if cfg.n == 0:
        return _empty_result(stream, cfg)
    assigned, mb = _kernel.substream_match_packed(*kernel_inputs(stream, cfg, mb0))
    return MatchingResult(
        assigned=assigned, mb_packed=mb[: cfg.n, : bitpack.packed_width(cfg.L)], L=cfg.L
    )


def kernel_inputs(stream, cfg: SubstreamConfig, mb0: torch.Tensor | None = None):
    """The kernel's operands ``(edges, weights, thresholds, n_pad, mb_init)``
    for a stream on its device: int32 [m, 2] edges and float32 [m] weights
    (invalid edges as vertex 0 with weight 0), the [8, width] bit-plane
    thresholds, and ``mb0`` padded to the block (``None`` stays ``None``)."""
    dev = stream.device
    free = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None
    plan = device_plan(cfg.n, cfg.L, free_bytes=free)
    valid = stream.valid
    edges = torch.stack(
        [torch.where(valid, stream.src, 0), torch.where(valid, stream.dst, 0)], dim=1
    ).to(torch.int32)
    w = torch.where(valid, stream.weight.to(torch.float32), 0.0)
    thr = _thresholds_padded(cfg, plan.width, dev)
    mb_init = (
        None if mb0 is None
        else _mb0_pad(mb0, cfg.n, plan.words, plan.n_pad, plan.width, dev)
    )
    return edges, w, thr, plan.n_pad, mb_init
