"""Typed and padded entry point of Part 1: :func:`substream_match`.

The bit block is ``mb[n_pad, width]`` uint8, bit ``j`` of word ``k`` =
substream ``8k + j`` (:mod:`repro_torch.core.bitpack`). :func:`device_plan`
gives its geometry on the H100: at the paper's size (2^20 vertices, L=64)
it is 8 MiB and stays resident in the card's 50 MB L2. :func:`wave_plan`
and :func:`mega_plan` add the geometry of a wave schedule's slot stream.
The TPU plans' VMEM budget and grid blocks have no counterpart: the wave
kernels are one block that walks the whole slot stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core.types import MatchingResult, SubstreamConfig, resolve_device, to_numpy
from repro_torch.graph import waves as _waves
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


#: bytes of device memory per slot of a wave schedule's slot stream: the
#: endpoint pair, the weight and the per-slot assigned index
SLOT_BYTES = 2 * 4 + 4 + 4


@dataclasses.dataclass(frozen=True)
class WavePlan(DevicePlan):
    """:class:`DevicePlan` plus the geometry of a wave schedule's slot stream.

    ``seg`` is the slot count per segment row, ``num_waves`` and
    ``num_segments`` the schedule's (for a mega plan: the block-aligned
    layout's) wave count and segment rows, ``fill`` the fraction of slots
    that hold a real edge. On a mega plan ``seg_block`` is the segments per
    tile and ``num_tiles`` the tile count; both are 0 on a waves plan.
    The kernel's bit block has ``rows = n_pad + SACRIFICIAL_ROWS`` rows.
    """

    seg: int = 0
    num_waves: int = 0
    num_segments: int = 0
    fill: float = 1.0
    seg_block: int = 0
    num_tiles: int = 0

    @property
    def rows(self) -> int:
        return self.n_pad + _kernel.SACRIFICIAL_ROWS

    @property
    def slots(self) -> int:
        return self.num_segments * self.seg


def _slot_plan(n, L, seg, num_waves, num_segments, fill, free_bytes, **mega) -> WavePlan:
    base = device_plan(n, L)
    plan = WavePlan(
        **dataclasses.asdict(base), seg=seg, num_waves=num_waves,
        num_segments=num_segments, fill=fill, **mega,
    )
    need = plan.rows * plan.width + plan.slots * SLOT_BYTES
    if free_bytes is not None and need > free_bytes:
        raise ValueError(
            f"bit block ({plan.rows * plan.width / 2**20:.1f} MiB) + slot stream "
            f"({plan.slots} slots, {plan.slots * SLOT_BYTES / 2**20:.1f} MiB) > "
            f"{free_bytes / 2**20:.1f} MiB free on the card; run the stream in "
            f"shorter pieces, each carrying the last one's bits (substream_match(mb0=...))"
        )
    return plan


def wave_plan(n: int, L: int, schedule, free_bytes: int | None = None) -> WavePlan:
    """Plan the segment kernel over ``schedule`` (a
    :class:`repro_torch.graph.waves.WaveSchedule`). Raises ``ValueError``
    when ``free_bytes`` is given and the bit block and slot stream would
    not fit in it."""
    return _slot_plan(
        n, L, int(schedule.width), int(schedule.num_waves),
        int(schedule.num_segments), float(schedule.fill), free_bytes,
    )


#: Default segments per megakernel tile, the JAX package's
#: ``MEGA_SEG_BLOCK``. On the card a tile is no unit of work (every slot
#: of a wave runs at once); it sets only the block-aligned padding.
MEGA_SEG_BLOCK = 2


def mega_plan(n: int, L: int, layout, free_bytes: int | None = None) -> WavePlan:
    """Plan the tile megakernel over ``layout`` (a
    :class:`repro_torch.graph.waves.BlockAlignedLayout`). Raises
    ``ValueError`` as :func:`wave_plan` does."""
    return _slot_plan(
        n, L, int(layout.width), int(layout.seg_offsets.shape[0] - 1),
        int(layout.num_segments), float(layout.fill), free_bytes,
        seg_block=int(layout.seg_block), num_tiles=int(layout.num_tiles),
    )


def _thresholds_padded(cfg: SubstreamConfig, width: int, device) -> torch.Tensor:
    """Kernel-shaped thresholds: [8, width] bit planes, thr[j, k] =
    substream 8k+j, +inf pads."""
    flat = np.full(width * bitpack.BITS, np.inf, np.float32)
    flat[: cfg.L] = cfg.thresholds()
    return torch.from_numpy(flat.reshape(width, bitpack.BITS).T.copy()).to(device)


def _thresholds_flat(cfg: SubstreamConfig, width: int, device) -> torch.Tensor:
    """Megakernel-shaped thresholds: the sorted float32 [8 * width] vector,
    +inf pads. Eligibility is then the prefix of the passing count."""
    flat = np.full(width * bitpack.BITS, np.inf, np.float32)
    flat[: cfg.L] = cfg.thresholds()
    return torch.from_numpy(flat).to(device)


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
    waves=None,
    max_width: int | None = None,
    seg_block: int | None = None,
) -> MatchingResult:
    """Run Part 1 on the given stream order.

    ``mb0`` (uint8 ``[n, ceil(L/8)]``) seeds the matching bits with
    carried-in state; default zeros. ``device=None`` runs on the CUDA card
    through the kernels; ``device="cpu"`` runs their plain versions.
    Returns packed storage: ``mb_packed`` uint8 ``[n, ceil(L/8)]``.

    ``schedule`` picks the engine; all three give the same bits:

    * ``"edges"``: one edge at a time, the paper's processor. Invalid
      edges enter with weight 0 and vertex 0, below every threshold.
    * ``"waves"``: the stream is cut on the host into vertex-disjoint
      waves (:mod:`repro_torch.graph.waves`), packed into segments of 8
      slots; the kernel runs one wave after another, every slot of a wave
      at once. Greedy matching is confluent over vertex-disjoint edges,
      so the result is bit-identical to ``"edges"``.
    * ``"mega"``: the same schedule re-padded so that every tile of
      ``seg_block`` segments (default :data:`MEGA_SEG_BLOCK`) lies in one
      wave, with self-loops moved to the sacrificial row on the host.

    ``waves`` passes a precomputed schedule for this stream order (it is
    validated, not rebuilt); ``max_width`` caps the wave width when one is
    built here. Only ``mb_layout="packed"`` is ported; the unpacked
    layout raises ``NotImplementedError``.
    """
    if schedule not in ("edges", "waves", "mega"):
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
    if schedule == "edges":
        assigned, mb = _kernel.substream_match_packed(*kernel_inputs(stream, cfg, mb0))
    else:
        sch = resolve_stream_schedule(stream, waves, max_width)
        if schedule == "waves":
            args, slots = waves_inputs(stream, cfg, sch, mb0)
            assigned_slots, mb = _kernel.substream_match_waves(*args)
        else:
            args, slots = mega_inputs(stream, cfg, sch, seg_block, mb0)
            assigned_slots, mb = _kernel.substream_match_mega(*args)
        assigned = _waves.scatter_slot_assignments(slots, assigned_slots, stream.num_edges)
    return MatchingResult(
        assigned=assigned, mb_packed=mb[: cfg.n, : bitpack.packed_width(cfg.L)], L=cfg.L
    )


def resolve_stream_schedule(stream, waves=None, max_width: int | None = None):
    """The wave schedule of ``stream``'s order: ``waves`` validated against
    the stream, or one built on the host."""
    src, dst, valid = (to_numpy(t) for t in (stream.src, stream.dst, stream.valid))
    return _waves.resolve_schedule(src, dst, valid, schedule=waves, max_width=max_width)


def _free_bytes(dev):
    return torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None


def _host_stream(stream):
    return tuple(to_numpy(t) for t in (stream.src, stream.dst, stream.weight, stream.valid))


def waves_inputs(stream, cfg: SubstreamConfig, sch, mb0: torch.Tensor | None = None):
    """The segment kernel's operands for ``stream`` under schedule ``sch``,
    and the slot map (int32 [slots], -1 on padding) that
    :func:`repro_torch.graph.waves.scatter_slot_assignments` reads.

    Operands ``(edges, weights, thresholds, seg_offsets, n_pad, seg,
    mb_init)``: the fill-packed slot stream as int32 [slots, 2] endpoints
    and float32 [slots] weights, padding slots remapped to the
    sacrificial row ``n_pad`` with weight 0 (self-loops stay: the kernel
    tests them), the [8, width] bit-plane thresholds, the schedule's
    segment offsets, and ``mb0`` padded to the kernel's block.
    """
    dev = stream.device
    plan = wave_plan(cfg.n, cfg.L, sch, free_bytes=_free_bytes(dev))
    src, dst, weight, valid = _host_stream(stream)
    u, v, w, ok = _waves.slot_arrays(sch, src, dst, weight, valid)
    sac = np.int32(plan.n_pad)
    edges = np.stack([np.where(ok, u, sac), np.where(ok, v, sac)], axis=-1).reshape(-1, 2)
    args = (
        torch.from_numpy(edges).to(dev),
        torch.from_numpy(w.reshape(-1)).to(dev),
        _thresholds_padded(cfg, plan.width, dev),
        torch.from_numpy(sch.seg_offsets).to(dev),
        plan.n_pad,
        plan.seg,
        _mb0_block(mb0, cfg, plan, dev),
    )
    return args, torch.from_numpy(sch.slots.reshape(-1)).to(dev)


def mega_inputs(
    stream, cfg: SubstreamConfig, sch, seg_block: int | None = None,
    mb0: torch.Tensor | None = None,
):
    """The tile megakernel's operands for ``stream`` under schedule
    ``sch``, and the slot map as :func:`waves_inputs` gives it.

    The schedule is re-padded block-aligned
    (:func:`repro_torch.graph.waves.block_aligned_layout`); operands
    ``(uv, weights, thresholds, seg_offsets, n_pad, seg, seg_block,
    mb_init)``: per tile all u's then all v's (int32), float32 weights,
    padding *and* self-loop slots remapped to the sacrificial row
    ``n_pad`` with weight 0, the sorted flat thresholds, the layout's
    block-aligned segment offsets, and ``mb0`` padded to the block.
    """
    dev = stream.device
    seg_block = MEGA_SEG_BLOCK if seg_block is None else seg_block
    layout = _waves.block_aligned_layout(sch, seg_block)
    plan = mega_plan(cfg.n, cfg.L, layout, free_bytes=_free_bytes(dev))
    src, dst, weight, _ = _host_stream(stream)
    flat = layout.slots.reshape(-1)
    live = flat >= 0
    pos = flat[live]
    sac = np.int32(plan.n_pad)
    uflat = np.full(flat.size, sac, np.int32)
    vflat = np.full(flat.size, sac, np.int32)
    wflat = np.zeros(flat.size, np.float32)
    u, v = src[pos], dst[pos]
    loop = u == v
    uflat[live] = np.where(loop, sac, u)
    vflat[live] = np.where(loop, sac, v)
    wflat[live] = np.where(loop, 0.0, weight[pos])
    bslots = seg_block * plan.seg
    uv = np.concatenate([uflat.reshape(-1, bslots), vflat.reshape(-1, bslots)], axis=1)
    args = (
        torch.from_numpy(uv.reshape(-1)).to(dev),
        torch.from_numpy(wflat).to(dev),
        _thresholds_flat(cfg, plan.width, dev),
        torch.from_numpy(layout.seg_offsets).to(dev),
        plan.n_pad,
        plan.seg,
        seg_block,
        _mb0_block(mb0, cfg, plan, dev),
    )
    return args, torch.from_numpy(flat).to(dev)


def _mb0_block(mb0, cfg: SubstreamConfig, plan: WavePlan, dev):
    return None if mb0 is None else _mb0_pad(mb0, cfg.n, plan.words, plan.rows, plan.width, dev)


def kernel_inputs(stream, cfg: SubstreamConfig, mb0: torch.Tensor | None = None):
    """The kernel's operands ``(edges, weights, thresholds, n_pad, mb_init)``
    for a stream on its device: int32 [m, 2] edges and float32 [m] weights
    (invalid edges as vertex 0 with weight 0), the [8, width] bit-plane
    thresholds, and ``mb0`` padded to the block (``None`` stays ``None``)."""
    dev = stream.device
    plan = device_plan(cfg.n, cfg.L, free_bytes=_free_bytes(dev))
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
