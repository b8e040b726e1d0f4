"""Typed and padded entry point of Part 1, :func:`substream_match`, and
the resumable epoch executor :func:`match_epochs`.

The bit block has two layouts (``SubstreamConfig.mb_layout``, or
``packed=`` per call), bit-identical in ``assigned`` and the bits:

* packed: ``mb[n_pad, width]`` uint8, bit ``j`` of word ``k`` = substream
  ``8k + j`` (:mod:`repro_torch.core.bitpack`); at the paper's size (2^20
  vertices, L=64) 8 MiB, resident in the card's 50 MB L2;
* unpacked: ``mb[n_pad, L_pad]`` int8, one byte per substream, rows of
  ``L_pad = round_up(L, 16)`` bytes; 64 MiB at the paper's size, which
  the L2 does not hold. Results come back dense (``bool [n, L]``).

:func:`device_plan` gives the block's geometry; :func:`wave_plan` and
:func:`mega_plan` add that of a wave schedule's slot stream. The TPU
plans' VMEM budget, 128-lane padding and grid blocks have no
counterpart: the wave kernels are one block that walks the whole slot
stream.

:func:`substream_match` and :func:`match_epochs` also take the robustness
and observability layers of the JAX package: ``telemetry=``
(:mod:`repro_torch.obs`), ``validate=``
(:func:`repro_torch.core.guard.validate_stream`), ``on_plan_failure=``
(the fallback ladder, :func:`_fallback_attempts`), and for the epochs
``snapshots=`` (:class:`repro_torch.checkpoint.snapshots.SnapshotManager`)
and ``guard=`` (:class:`repro_torch.core.executor.ExecutionGuard`).
:func:`merge_device` is Part 2 on the card, a one-substream Part 1 run
through the per-edge walker below :func:`substream_match`. The per-edge
schedule has two engines on the card, chosen by :func:`edges_route`: the
one-CTA walker of each layout, and the rounds engine for packed rows of
one 64-bit word (L <= 64). The
kernels are launched through the module-level seams :func:`_edges_device`,
:func:`_rounds_device`, :func:`_waves_device` and :func:`_mega_device`,
which :func:`repro_torch.testing.faultline.failing` patches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.snapshots import SnapshotCorruptError, SnapshotMismatchError
from repro_torch.core import bitpack
from repro_torch.core import guard as _guard
from repro_torch.core import matching as _matching
from repro_torch.core.merge import merge_order
from repro_torch.core.state import MatchState
from repro_torch.core.types import (
    EdgeStream,
    MatchingResult,
    SubstreamConfig,
    resolve_device,
    to_numpy,
)
from repro_torch.graph import waves as _waves
from repro_torch.kernels.substream_match import kernel as _kernel
from repro_torch.kernels.substream_match import ref as _ref
from repro_torch.kernels.substream_match.kernel import PlanRefusedError

#: L2 cache of one H100
L2_BYTES = 50 * 2**20


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Geometry of the bit block: ``n_pad`` rows of ``width`` bytes, of
    which ``words`` hold bits (packed: ``ceil(L/8)`` uint8 words; unpacked:
    ``L`` int8 bytes) and the rest are +inf-threshold padding;
    ``nbytes = n_pad * width``, whether it fits the L2, and the layout."""

    n_pad: int
    width: int
    words: int
    nbytes: int
    fits_l2: bool
    packed: bool = True


def device_plan(
    n: int, L: int, free_bytes: int | None = None, packed: bool = True
) -> DevicePlan:
    """Plan the bit block for ``n`` vertices and ``L`` substreams.

    Packed rows are ``ceil(L/8)`` words rounded up to 8 (one 64-bit word
    for the wave kernels); unpacked rows are ``L`` bytes rounded up to 16,
    whole 16-byte vector loads and whole 64-bit words for the wave kernels
    (the TPU's ``round_up(L, 128)`` is lane padding for its vector unit).
    Raises :class:`PlanRefusedError` (a ``ValueError``) when ``free_bytes``
    (the card's free memory) is given and the block would not fit in it.
    """
    n_pad = _round_up(max(n, 1), 8)
    if packed:
        words = bitpack.packed_width(max(L, 1))
        width = _round_up(words, 8)
    else:
        words = max(L, 1)
        width = _round_up(words, 16)
    nbytes = n_pad * width
    if free_bytes is not None and nbytes > free_bytes:
        raise PlanRefusedError(
            f"matching-bit block {nbytes / 2**20:.1f} MiB > "
            f"{free_bytes / 2**20:.1f} MiB free on the card"
        )
    return DevicePlan(
        n_pad=n_pad, width=width, words=words, nbytes=nbytes,
        fits_l2=nbytes <= L2_BYTES, packed=packed,
    )


#: bytes of device memory per slot of a wave schedule's slot stream: the
#: endpoint pair, the weight and the per-slot assigned index
SLOT_BYTES = 2 * 4 + 4 + 4
#: and the int32 passing count the wave kernels keep per slot
SLOT_SCRATCH = 4


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

    @property
    def gather_bytes(self) -> int:
        """Device bytes of the slot stream and its per-slot scratch, on top
        of the bit block (the JAX package's ``gather_bytes`` counts the
        VMEM tiles in that place)."""
        return self.slots * (SLOT_BYTES + SLOT_SCRATCH)


def _slot_plan(n, L, seg, num_waves, num_segments, fill, free_bytes, packed,
               **mega) -> WavePlan:
    base = device_plan(n, L, packed=packed)
    plan = WavePlan(
        **dataclasses.asdict(base), seg=seg, num_waves=num_waves,
        num_segments=num_segments, fill=fill, **mega,
    )
    block = plan.rows * plan.width
    if not packed:  # the unpacked kernels' packed working copy of the block
        block += plan.rows * 8 * -(-plan.width // 64)
    need = block + plan.gather_bytes
    if free_bytes is not None and need > free_bytes:
        raise PlanRefusedError(
            f"bit block ({block / 2**20:.1f} MiB) + slot stream "
            f"({plan.slots} slots, {plan.gather_bytes / 2**20:.1f} MiB) > "
            f"{free_bytes / 2**20:.1f} MiB free on the card; run the stream in "
            f"shorter pieces, each carrying the last one's bits (substream_match(mb0=...))"
        )
    return plan


def wave_plan(
    n: int, L: int, schedule, free_bytes: int | None = None, packed: bool = True
) -> WavePlan:
    """Plan the segment kernel over ``schedule`` (a
    :class:`repro_torch.graph.waves.WaveSchedule`) in the given layout.
    Raises :class:`PlanRefusedError` (a ``ValueError``) when ``free_bytes``
    is given and the bit block and slot stream would not fit in it."""
    return _slot_plan(
        n, L, int(schedule.width), int(schedule.num_waves),
        int(schedule.num_segments), float(schedule.fill), free_bytes, packed,
    )


#: Default segments per megakernel tile, the JAX package's
#: ``MEGA_SEG_BLOCK``. On the card a tile is no unit of work (every slot
#: of a wave runs at once); it sets only the block-aligned padding.
MEGA_SEG_BLOCK = 2


def mega_plan(
    n: int, L: int, layout, free_bytes: int | None = None, packed: bool = True
) -> WavePlan:
    """Plan the tile megakernel over ``layout`` (a
    :class:`repro_torch.graph.waves.BlockAlignedLayout`) in the given
    layout of the bit block. Raises :class:`PlanRefusedError` as
    :func:`wave_plan` does."""
    return _slot_plan(
        n, L, int(layout.width), int(layout.seg_offsets.shape[0] - 1),
        int(layout.num_segments), float(layout.fill), free_bytes, packed,
        seg_block=int(layout.seg_block), num_tiles=int(layout.num_tiles),
    )


def plan_counters(plan: DevicePlan) -> dict:
    """The plan-accounting counter set (``plan.*``) for telemetry:
    bit-exact copies of the :func:`device_plan` / :func:`wave_plan` /
    :func:`mega_plan` fields, so that tests can compare them ``==`` with a
    recomputed plan. Wave plans carry both
    :data:`repro_torch.obs.PLAN_COUNTERS`."""
    out = {
        "plan.n_pad": int(plan.n_pad),
        "plan.width": int(plan.width),
        "plan.words": int(plan.words),
        "plan.bit_block_bytes": int(plan.nbytes),
        "plan.fits_l2": int(plan.fits_l2),
        "plan.packed": int(plan.packed),
    }
    if isinstance(plan, WavePlan):
        out.update(
            {
                "plan.seg": int(plan.seg),
                "plan.num_waves": int(plan.num_waves),
                "plan.num_segments": int(plan.num_segments),
                "plan.rows": int(plan.rows),
                "plan.gather_bytes": int(plan.gather_bytes),
                "plan.fill": float(plan.fill),
                "plan.seg_block": int(plan.seg_block),
                "plan.num_tiles": int(plan.num_tiles),
            }
        )
    return out


def _thresholds_padded(cfg: SubstreamConfig, width: int, device, packed: bool = True):
    """Kernel-shaped thresholds, +inf pads: [8, width] bit planes, thr[j, k]
    = substream 8k+j (packed), or [1, width] lanes (unpacked)."""
    nbits = width * bitpack.BITS if packed else width
    flat = np.full(nbits, np.inf, np.float32)
    flat[: cfg.L] = cfg.thresholds()
    if packed:
        return torch.from_numpy(flat.reshape(width, bitpack.BITS).T.copy()).to(device)
    return torch.from_numpy(flat[None]).to(device)


def _thresholds_flat(cfg: SubstreamConfig, nbits: int, device) -> torch.Tensor:
    """Megakernel-shaped thresholds: the sorted float32 [nbits] vector,
    +inf pads (nbits = 8 * width packed, width unpacked). Eligibility is
    then the prefix of the passing count."""
    flat = np.full(nbits, np.inf, np.float32)
    flat[: cfg.L] = cfg.thresholds()
    return torch.from_numpy(flat).to(device)


def _mb0_pad(mb0: torch.Tensor, n: int, words: int, rows: int, width: int, device,
             packed: bool = True):
    """Pad caller-format initial bits (packed: uint8 [n, words]; unpacked:
    bool [n, L], any non-zero value a set bit) to the kernel's block
    [rows, width] (uint8 packed, int8 of 0/1 unpacked); the padding is
    zero."""
    if tuple(mb0.shape) != (n, words):
        raise ValueError(f"mb0 shape {tuple(mb0.shape)} != ({n}, {words})")
    mb0 = mb0.to(device)
    if packed:
        out = torch.zeros((rows, width), dtype=torch.uint8, device=device)
        out[:n, :words] = mb0.to(torch.uint8)
    else:
        out = torch.zeros((rows, width), dtype=torch.int8, device=device)
        out[:n, :words] = mb0.ne(0).to(torch.int8)
    return out


def _resolve_packed(cfg: SubstreamConfig, packed: bool | None) -> bool:
    """``packed=None`` follows ``cfg.mb_layout``."""
    return cfg.mb_layout != "unpacked" if packed is None else bool(packed)


def _result(assigned, mb, cfg: SubstreamConfig, packed: bool) -> MatchingResult:
    """The caller's storage of a kernel's block: packed ``mb_packed`` uint8
    [n, ceil(L/8)], or dense ``mb`` bool [n, L]."""
    if packed:
        return MatchingResult(
            assigned=assigned, mb_packed=mb[: cfg.n, : bitpack.packed_width(cfg.L)], L=cfg.L
        )
    return MatchingResult(assigned=assigned, mb=mb[: cfg.n, : cfg.L].ne(0))


def _empty_result(stream, cfg: SubstreamConfig, packed: bool = True) -> MatchingResult:
    """Well-formed nothing-matched result (n == 0 vertex spaces)."""
    dev = stream.device
    assigned = torch.full((stream.num_edges,), -1, dtype=torch.int32, device=dev)
    if packed:
        words = bitpack.packed_width(max(cfg.L, 1))
        return MatchingResult(
            assigned=assigned, mb_packed=torch.zeros((0, words), dtype=torch.uint8, device=dev),
            L=cfg.L,
        )
    return MatchingResult(
        assigned=assigned, mb=torch.zeros((0, cfg.L), dtype=torch.bool, device=dev)
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
    packed: bool | None = None,
    telemetry=obs.DISABLED,
    on_plan_failure: str = "raise",
    validate: str = "off",
) -> MatchingResult:
    """Run Part 1 on the given stream order.

    ``packed`` picks the bit block's layout; ``None`` follows
    ``cfg.mb_layout``. Packed runs return ``mb_packed`` uint8
    ``[n, ceil(L/8)]``; unpacked runs (``packed=False`` or
    ``mb_layout="unpacked"``) return dense ``mb`` bool ``[n, L]``. Both
    are bit-identical in ``assigned`` and ``mb``. ``mb0`` seeds the
    matching bits with carried-in state in the same storage (uint8
    ``[n, ceil(L/8)]`` packed, bool ``[n, L]`` unpacked); default zeros.
    ``device=None`` runs on the CUDA card through the kernels;
    ``device="cpu"`` runs their plain versions.

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
    built here.

    ``telemetry`` (a :class:`repro_torch.obs.Telemetry`; default the no-op
    :data:`repro_torch.obs.DISABLED`, resolved by
    :func:`repro_torch.obs.active`) records a ``stream.to`` span where the
    stream is copied, one ``substream_match.backend`` event naming the
    backend that ran (``"cuda"``, or ``"cpu"`` for the plain versions), the
    stage spans (schedule/pack/layout/compile/execute), the plan and
    schedule counters, and a :class:`repro_torch.obs.MatchTelemetry`
    appended to ``telemetry.match_calls``.

    ``validate`` is the input-guard policy: ``"off"`` (default, no cost),
    ``"strict"`` (raise on a malformed stream) or ``"sanitize"`` (drop the
    bad edges and report them), see
    :func:`repro_torch.core.guard.validate_stream`.

    ``on_plan_failure`` says what happens when a rung cannot run:
    ``"raise"`` (default) propagates; ``"fallback"`` steps down the ladder
    of :func:`_fallback_attempts`, with a ``fallback`` span, event and
    counter for every failed rung, never silently. On the card the ladder
    holds only kernel rungs and steps down only on a
    :class:`PlanRefusedError` (the card's free memory, a row wider than the
    kernels take), raised before any launch; a build, launch or operand
    error propagates, so no failing kernel is hidden behind a plain
    version. On the CPU it is the JAX package's ladder down to the plain
    engines.
    """
    if schedule not in ("edges", "waves", "mega"):
        raise ValueError(f"unknown schedule {schedule!r}")
    _check_on_plan_failure(on_plan_failure)
    packed = _resolve_packed(cfg, packed)
    dev = resolve_device(device)
    telemetry = obs.active(telemetry)
    stream = stream.to(dev, telemetry=telemetry)
    if validate != "off":
        stream, _ = _guard.validate_stream(stream, cfg.n, policy=validate, telemetry=telemetry)
    if telemetry.enabled:
        telemetry.event(
            "substream_match.backend", engine=schedule, backend=dev.type,
            interpret=dev.type == "cpu",
        )
    if cfg.n == 0:
        return _empty_result(stream, cfg, packed)
    kw = dict(packed=packed, waves=waves, max_width=max_width, seg_block=seg_block,
              telemetry=telemetry, mb0=mb0)
    if on_plan_failure == "fallback":
        return _substream_match_fallback(schedule, stream, cfg, **kw)
    return _run_engine(schedule, stream, cfg, **kw)


def merge_device(
    stream: EdgeStream, result: MatchingResult, cfg: SubstreamConfig,
    telemetry=obs.DISABLED, device=None,
) -> torch.Tensor:
    """Part 2 on the card: the bool [m] membership mask of T, bit-identical
    to :func:`repro_torch.core.merge.merge_host` (``torch.nonzero(mask)``
    gives its indices). ``mwm_pipeline`` merges with it on the card.

    The R recorded edges are put in merge order
    (:func:`repro_torch.core.merge.merge_order`) and run, with weight 1,
    through Part 1 with one substream (``L = 1``, threshold 1): the packed
    per-edge engine on the card, its plain version on the CPU. It is
    launched below :func:`substream_match`, so Part 1's entry, its stage
    spans, ``match_calls`` and backend event count Part 1 alone. An edge
    enters T exactly when that run records it, and the result is scattered
    back to stream positions. Only the recorded edges go through the
    kernel: the JAX package's ``merge_device`` scans all m edges with the
    rest marked invalid, which touches no bit either. Reads only
    ``result.assigned`` (packed-safe). ``device=None`` runs on the card.

    ``telemetry`` (resolved by :func:`repro_torch.obs.active`) records one
    ``merge.device`` span holding ``merge.order`` (the recorded edges in
    merge order and their endpoints; arg ``recorded``, R) and
    ``merge.greedy`` (the one-substream run's operands, its launch and the
    scatter; args ``recorded`` and ``matched``), which holds
    ``merge.kernel`` (the L = 1 launch alone, where R > 0; args
    ``recorded``, ``bit_block_bytes`` and ``fits_l2`` of the L = 1 plan),
    each synchronised, and the ``merge.device.calls``,
    ``merge.recorded_edges`` and ``merge.matched_edges`` counters.
    """
    dev = resolve_device(device)
    telemetry = obs.active(telemetry)
    with telemetry.span("merge.device", sync=dev):
        stream = stream.to(dev, telemetry=telemetry)
        with telemetry.span("merge.order", sync=dev) as span:
            order = merge_order(result.with_assigned(result.assigned.to(dev)), cfg)
            r = order.numel()
            if r:
                src, dst = stream.src[order], stream.dst[order]
            if telemetry.enabled:
                span.note(recorded=r)
        with telemetry.span("merge.greedy", sync=dev) as span:
            mask = torch.zeros(stream.num_edges, dtype=torch.bool, device=dev)
            if r and cfg.n:
                one = EdgeStream(
                    src=src, dst=dst,
                    weight=torch.ones(r, dtype=torch.float32, device=dev),
                    valid=torch.ones(r, dtype=torch.bool, device=dev),
                )
                one_cfg = SubstreamConfig(n=cfg.n, L=1, eps=cfg.eps)
                args = kernel_inputs(one, one_cfg, None, True)
                with telemetry.span("merge.kernel", sync=dev) as kernel_span:
                    assigned, _ = _edges_device(args, True)
                    if telemetry.enabled:
                        kernel_span.note(recorded=r, **_block_args(device_plan(cfg.n, 1)))
                mask[order] = assigned >= 0
            if telemetry.enabled:
                matched = int(mask.sum())
                span.note(recorded=r, matched=matched)
    if telemetry.enabled:
        telemetry.counters.add("merge.device.calls")
        telemetry.counters.put("merge.recorded_edges", r)
        telemetry.counters.put("merge.matched_edges", matched)
    return mask


def _check_on_plan_failure(on_plan_failure: str):
    if on_plan_failure not in ("raise", "fallback"):
        raise ValueError(
            f"unknown on_plan_failure {on_plan_failure!r}; use 'raise' or 'fallback'"
        )


# --------------------------------------------------------------------------
# The device seams: every kernel launch of the entries goes through one of
# these module attributes, which the fault injector patches.


def _edges_device(args, packed: bool):
    """Launch the per-edge kernel of the layout on :func:`kernel_inputs`'s operands."""
    launch = _kernel.substream_match_packed if packed else _kernel.substream_match_unpacked
    return launch(*args)


def _rounds_device(args, stats=None):
    """Launch the rounds engine on :func:`kernel_inputs`'s packed operands."""
    return _kernel.substream_match_rounds(*args, stats=stats)


def _waves_device(args, packed: bool):
    """Launch the segment kernel on :func:`waves_inputs`'s operands."""
    return _kernel.substream_match_waves(*args, packed=packed)


def _mega_device(args, packed: bool):
    """Launch the tile megakernel on :func:`mega_inputs`'s operands."""
    return _kernel.substream_match_mega(*args, packed=packed)


def _library(dev, name: str):
    """The kernel library a launch on ``dev`` loads (none on the CPU)."""
    return name if dev.type == "cuda" else None


def _recorder(telemetry, engine: str, stream):
    dev = stream.device
    return obs.recorder(telemetry, engine, stream.num_edges, dev.type, dev.type == "cpu")


def _block_args(plan: DevicePlan) -> dict:
    """The bit block's size and whether it fits the L2, as span arguments."""
    return {"bit_block_bytes": int(plan.nbytes), "fits_l2": int(plan.fits_l2)}


def edges_route(device, packed: bool, width: int) -> str:
    """Which engine runs a per-edge call: ``"rounds_engine"``
    (:func:`repro_torch.kernels.substream_match.kernel.substream_match_rounds`)
    for a packed call on the card whose rows are one 64-bit word
    (``width <= ROUNDS_MAX_WIDTH``, L <= 64); else ``"walker"``, the
    one-CTA kernel of the layout (its plain version on the CPU)."""
    if torch.device(device).type == "cuda" and packed and width <= _kernel.ROUNDS_MAX_WIDTH:
        return "rounds_engine"
    return "walker"


def _edges_entry(stream, cfg, *, packed, telemetry, mb0=None) -> MatchingResult:
    """The per-edge engine on a stream on its device, routed by
    :func:`edges_route`. It has no host scheduling, so its schedule and
    pack stages stay 0. Under an enabled session the device stage's span
    carries ``edges``, ``bit_block_bytes`` and ``fits_l2`` (and on the
    rounds engine ``chunks`` and ``rounds``, read once after the launches),
    the session counts the route (``kernel_edges.rounds_engine.calls`` or
    ``kernel_edges.walker.calls``) and adds the rounds engine's
    ``kernel_edges.chunks`` and ``kernel_edges.rounds``, and the
    ``stream.self_loops`` counter (valid edges with ``src == dst``, which
    the kernel admits to no substream) is one device reduction in the
    layout stage."""
    m = stream.num_edges
    rec = _recorder(telemetry, "kernel_edges", stream)
    with rec.stage("layout"):
        args = kernel_inputs(stream, cfg, mb0, packed)
        if telemetry.enabled:
            loops = int((stream.valid & (stream.src == stream.dst)).sum())
    route = edges_route(stream.device, packed, args[2].shape[1])
    span_args, stats = {}, None
    if telemetry.enabled:
        plan = device_plan(cfg.n, cfg.L, packed=packed)
        rec.put_many(plan_counters(plan))
        rec.put("stream.num_edges", m)
        rec.put("stream.self_loops", loops)
        span_args = {"edges": m, **_block_args(plan)}
        telemetry.counters.add(f"kernel_edges.{route}.calls")
        if route == "rounds_engine":
            stats = torch.zeros(2, dtype=torch.int64, device=stream.device)
    with rec.device_stage(_library(stream.device, _kernel.EDGES_LIBRARY), **span_args) as span:
        if route == "rounds_engine":
            assigned, mb = rec.block(_rounds_device(args, stats))
        else:
            assigned, mb = rec.block(_edges_device(args, packed))
        if stats is not None:
            chunks, rounds = stats.tolist()
            span.note(chunks=chunks, rounds=rounds)
            telemetry.counters.add("kernel_edges.chunks", chunks)
            telemetry.counters.add("kernel_edges.rounds", rounds)
    rec.finish()
    return _result(assigned, mb, cfg, packed)


def _entry_schedule(rec, stream, waves, max_width, telemetry):
    """The entry's wave schedule, its cost credited to the stages: a
    schedule built here carries its own assign/pack times; a passed one
    costs its validation."""
    if waves is None:
        sch = resolve_stream_schedule(stream, None, max_width, telemetry)
        rec.add_stage("schedule", sch.schedule_seconds)
        rec.add_stage("pack", sch.pack_seconds)
        return sch
    with rec.stage("schedule"):
        return resolve_stream_schedule(stream, waves, max_width, telemetry)


def _waves_entry(stream, cfg, *, packed, waves, max_width, telemetry, mb0=None):
    m = stream.num_edges
    rec = _recorder(telemetry, "kernel_waves", stream)
    sch = _entry_schedule(rec, stream, waves, max_width, telemetry)
    with rec.stage("layout"):
        args, slots = waves_inputs(stream, cfg, sch, mb0, packed)
    if telemetry.enabled:
        plan = wave_plan(cfg.n, cfg.L, sch, packed=packed)
        rec.put_many(_waves.schedule_counters(sch))
        rec.put_many(plan_counters(plan))
        rec.put("stream.num_edges", m)
    with rec.device_stage(_library(stream.device, _kernel.WAVES_LIBRARY)):
        assigned_slots, mb = rec.block(_waves_device(args, packed))
    with rec.stage("layout"):
        assigned = rec.block(_waves.scatter_slot_assignments(slots, assigned_slots, m))
    rec.finish()
    return _result(assigned, mb, cfg, packed)


def _mega_entry(stream, cfg, *, packed, waves, max_width, seg_block, telemetry, mb0=None):
    m = stream.num_edges
    seg_block = MEGA_SEG_BLOCK if seg_block is None else seg_block
    rec = _recorder(telemetry, "kernel_mega", stream)
    sch = _entry_schedule(rec, stream, waves, max_width, telemetry)
    with rec.stage("layout"):
        args, slots, layout, plan = _mega_operands(stream, cfg, sch, seg_block, mb0, packed)
    if telemetry.enabled:
        rec.put_many(_waves.schedule_counters(sch))
        rec.put_many(_waves.layout_counters(layout, sch))
        rec.put_many(plan_counters(plan))
        rec.put("stream.num_edges", m)
    with rec.device_stage(_library(stream.device, _kernel.WAVES_LIBRARY)):
        assigned_slots, mb = rec.block(_mega_device(args, packed))
    with rec.stage("layout"):
        assigned = rec.block(_waves.scatter_slot_assignments(slots, assigned_slots, m))
    rec.finish()
    return _result(assigned, mb, cfg, packed)


def resolve_stream_schedule(
    stream, waves=None, max_width: int | None = None, telemetry=obs.DISABLED
):
    """The wave schedule of ``stream``'s order: ``waves`` validated against
    the stream, or one built on the host."""
    src, dst, valid = (to_numpy(t) for t in (stream.src, stream.dst, stream.valid))
    return _waves.resolve_schedule(
        src, dst, valid, schedule=waves, max_width=max_width, telemetry=telemetry
    )


def _free_bytes(dev):
    return torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else None


def _host_stream(stream):
    return tuple(to_numpy(t) for t in (stream.src, stream.dst, stream.weight, stream.valid))


def waves_inputs(
    stream, cfg: SubstreamConfig, sch, mb0: torch.Tensor | None = None, packed: bool = True,
):
    """The segment kernel's operands for ``stream`` under schedule ``sch``,
    and the slot map (int32 [slots], -1 on padding) that
    :func:`repro_torch.graph.waves.scatter_slot_assignments` reads.

    Operands ``(edges, weights, thresholds, seg_offsets, n_pad, seg,
    mb_init)``: the fill-packed slot stream as int32 [slots, 2]
    endpoints and float32 [slots] weights, padding slots remapped to the
    sacrificial row ``n_pad`` with weight 0 (self-loops stay: the kernel
    tests them), the thresholds ([8, width] bit planes packed, [1, width]
    lanes unpacked), the schedule's segment offsets, and ``mb0`` padded
    to the kernel's block. The kernel takes ``packed`` besides.
    """
    dev = stream.device
    plan = wave_plan(cfg.n, cfg.L, sch, free_bytes=_free_bytes(dev), packed=packed)
    src, dst, weight, valid = _host_stream(stream)
    u, v, w, ok = _waves.slot_arrays(sch, src, dst, weight, valid)
    sac = np.int32(plan.n_pad)
    edges = np.stack([np.where(ok, u, sac), np.where(ok, v, sac)], axis=-1).reshape(-1, 2)
    args = (
        torch.from_numpy(edges).to(dev),
        torch.from_numpy(w.reshape(-1)).to(dev),
        _thresholds_padded(cfg, plan.width, dev, plan.packed),
        torch.from_numpy(sch.seg_offsets).to(dev),
        plan.n_pad,
        plan.seg,
        _mb0_block(mb0, cfg, plan, dev),
    )
    return args, torch.from_numpy(sch.slots.reshape(-1)).to(dev)


def mega_inputs(
    stream, cfg: SubstreamConfig, sch, seg_block: int | None = None,
    mb0: torch.Tensor | None = None, packed: bool = True,
):
    """The tile megakernel's operands for ``stream`` under schedule
    ``sch``, and the slot map as :func:`waves_inputs` gives it.

    The schedule is re-padded block-aligned
    (:func:`repro_torch.graph.waves.block_aligned_layout`); operands
    ``(uv, weights, thresholds, seg_offsets, n_pad, seg, seg_block,
    mb_init)``: per tile all u's then all v's (int32), float32 weights,
    padding *and* self-loop slots remapped to the sacrificial row
    ``n_pad`` with weight 0, the sorted flat thresholds (8 * width
    packed, width unpacked), the layout's block-aligned segment offsets,
    and ``mb0`` padded to the block. The kernel takes ``packed`` besides.
    """
    return _mega_operands(stream, cfg, sch, seg_block, mb0, packed)[:2]


def _mega_operands(stream, cfg, sch, seg_block, mb0, packed):
    """:func:`mega_inputs`, and the block-aligned layout and plan."""
    dev = stream.device
    seg_block = MEGA_SEG_BLOCK if seg_block is None else seg_block
    layout = _waves.block_aligned_layout(sch, seg_block)
    plan = mega_plan(cfg.n, cfg.L, layout, free_bytes=_free_bytes(dev), packed=packed)
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
        _thresholds_flat(cfg, plan.width * bitpack.BITS if plan.packed else plan.width, dev),
        torch.from_numpy(layout.seg_offsets).to(dev),
        plan.n_pad,
        plan.seg,
        seg_block,
        _mb0_block(mb0, cfg, plan, dev),
    )
    return args, torch.from_numpy(flat).to(dev), layout, plan


def _mb0_block(mb0, cfg: SubstreamConfig, plan: WavePlan, dev):
    if mb0 is None:
        return None
    return _mb0_pad(mb0, cfg.n, plan.words, plan.rows, plan.width, dev, plan.packed)


def kernel_inputs(
    stream, cfg: SubstreamConfig, mb0: torch.Tensor | None = None, packed: bool = True,
):
    """A per-edge kernel's operands ``(edges, weights, thresholds, n_pad,
    mb_init)`` for a stream on its device: int32 [m, 2] edges and float32
    [m] weights (invalid edges as vertex 0 with weight 0), the thresholds
    ([8, width] bit planes packed, [1, width] lanes unpacked), and ``mb0``
    padded to the block (``None`` stays ``None``)."""
    dev = stream.device
    plan = device_plan(cfg.n, cfg.L, free_bytes=_free_bytes(dev), packed=packed)
    valid = stream.valid
    edges = torch.stack(
        [torch.where(valid, stream.src, 0), torch.where(valid, stream.dst, 0)], dim=1
    ).to(torch.int32)
    w = torch.where(valid, stream.weight.to(torch.float32), 0.0)
    thr = _thresholds_padded(cfg, plan.width, dev, plan.packed)
    mb_init = (
        None if mb0 is None
        else _mb0_pad(mb0, cfg.n, plan.words, plan.n_pad, plan.width, dev, plan.packed)
    )
    return edges, w, thr, plan.n_pad, mb_init


# --------------------------------------------------------------------------
# Engines, the fallback ladder, and resumable chunked execution.

#: Engines :func:`match_epochs` can drive: the three kernel schedules, the
#: plain CS-SEQ scan ``"scan"`` (:func:`repro_torch.core.mwm_scan`), the
#: plain wave engine ``"waves_xla"`` (:func:`repro_torch.core.mwm_waves`,
#: named after the JAX package's XLA engine) and the oracles ``"ref"``.
#: All take the carried bits, so every engine is epoch-chunkable.
EPOCH_ENGINES = ("edges", "waves", "mega", "scan", "waves_xla", "ref")


def epoch_bounds(num_edges: int, epochs: int) -> list[int]:
    """Stream positions of the epoch barriers: ``epochs + 1`` monotone
    bounds with near-equal slices (``round(i * m / E)``). Fixed by
    ``(m, E)`` alone, so a resumed run recomputes the same barriers."""
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    return [round(i * num_edges / epochs) for i in range(epochs + 1)]


def _mb0_dense(mb0, cfg: SubstreamConfig, packed: bool):
    """Caller-format initial bits as the dense bool [n, L] the plain
    engines take."""
    if mb0 is None:
        return None
    return bitpack.unpack_bits(mb0, cfg.L) if packed else mb0.ne(0)


def _repack(result: MatchingResult, packed: bool) -> MatchingResult:
    """A dense result in the storage the caller asked for, so every engine
    keeps the layout's ``is_packed`` contract (the bits are the same)."""
    if packed and not result.is_packed:
        return MatchingResult(
            assigned=result.assigned, mb_packed=bitpack.pack_bits(result.mb), L=result.L
        )
    return result


def _run_engine(
    engine: str, stream, cfg: SubstreamConfig, *, packed: bool, waves=None,
    max_width: int | None = None, seg_block: int | None = None, telemetry=obs.DISABLED,
    mb0=None,
) -> MatchingResult:
    """Run one engine of :data:`EPOCH_ENGINES` on ``stream`` (on its device)
    from the carried bits ``mb0`` (caller storage: uint8 [n, words] packed
    / bool [n, L] dense); the plain engines take the dense view. They are
    looked up in their module at call time, so the fault injector can make
    them fail too."""
    if engine == "edges":
        return _edges_entry(stream, cfg, packed=packed, telemetry=telemetry, mb0=mb0)
    if engine == "waves":
        return _waves_entry(stream, cfg, packed=packed, waves=waves, max_width=max_width,
                            telemetry=telemetry, mb0=mb0)
    if engine == "mega":
        return _mega_entry(stream, cfg, packed=packed, waves=waves, max_width=max_width,
                           seg_block=seg_block, telemetry=telemetry, mb0=mb0)
    dev = stream.device
    if engine == "waves_xla":
        return _repack(
            _matching.mwm_waves(
                stream, cfg, schedule=waves, max_width=max_width,
                mb0=_mb0_dense(mb0, cfg, packed), device=dev, telemetry=telemetry,
            ),
            packed,
        )
    if engine == "scan":
        return _repack(
            _matching.mwm_scan(stream, cfg, mb0=_mb0_dense(mb0, cfg, packed), device=dev),
            packed,
        )
    if engine == "ref":
        valid = stream.valid  # invalid edges enter as vertex 0 with weight 0, as in the kernels
        src, dst = (torch.where(valid, t, 0) for t in (stream.src, stream.dst))
        w = torch.where(valid, stream.weight.to(torch.float32), 0.0)
        thr = torch.from_numpy(cfg.thresholds().copy()).to(dev)
        if packed:
            assigned, mb = _ref.substream_match_ref_packed(src, dst, w, thr, cfg.n, mb0=mb0)
            return MatchingResult(assigned=assigned, mb_packed=mb, L=cfg.L)
        assigned, mb = _ref.substream_match_ref(src, dst, w, thr, cfg.n, mb0=mb0)
        return MatchingResult(assigned=assigned, mb=mb.ne(0))
    raise ValueError(f"unknown engine {engine!r}")


class FallbackExhaustedError(RuntimeError):
    """Every engine of the fallback ladder failed.

    ``attempts`` is the ordered ``(engine_label, exception)`` list, so a
    log shows the whole degradation path in one line.
    """

    def __init__(self, attempts):
        self.attempts = tuple(attempts)
        lines = "; ".join(
            f"{label}: {type(err).__name__}: {err}" for label, err in self.attempts
        )
        super().__init__(f"all fallback engines failed ({lines})")


def _fallback_attempts(schedule: str, seg_block: int | None, on_card: bool = False):
    """The degradation ladder of ``on_plan_failure="fallback"``, as
    ``(engine, {knob overrides}, label)`` entries:

    * ``"mega"``: mega, mega[seg_block=1] (when ``seg_block`` is not 1
      already), waves, waves_xla, scan;
    * ``"waves"``: waves, waves_xla, scan;
    * ``"edges"``: edges, waves_xla, scan.

    ``waves_xla`` is :func:`repro_torch.core.mwm_waves` and ``scan``
    :func:`repro_torch.core.mwm_scan`, plain torch. ``on_card`` keeps only
    the kernel rungs (mega, mega[seg_block=1], waves; waves; edges): a
    kernel on the card never gives way to a plain version. Both depart from
    the JAX package's ladder, which also shrinks the waves kernel's
    ``block_s`` (the port's waves kernel has no such knob) and reaches the
    plain engines on the accelerator too."""
    if schedule == "mega":
        attempts = [("mega", {"seg_block": seg_block}, "mega")]
        if (MEGA_SEG_BLOCK if seg_block is None else seg_block) != 1:
            attempts.append(("mega", {"seg_block": 1}, "mega[seg_block=1]"))
        attempts.append(("waves", {}, "waves"))
    else:
        attempts = [(schedule, {}, schedule)]
    if on_card:
        return attempts
    return attempts + [("waves_xla", {}, "waves_xla"), ("scan", {}, "scan")]


def _ladder(schedule: str, seg_block: int | None, device):
    """The rungs of the ladder on ``device`` and the failures they absorb:
    on the card the kernel rungs and :class:`PlanRefusedError` alone, on
    the CPU the whole ladder and every error."""
    on_card = device.type == "cuda"
    absorbed = PlanRefusedError if on_card else Exception
    return _fallback_attempts(schedule, seg_block, on_card), absorbed


def _substream_match_fallback(
    schedule: str, stream, cfg: SubstreamConfig, *, packed, waves, max_width, seg_block,
    telemetry, mb0=None,
) -> MatchingResult:
    """Run the :func:`_fallback_attempts` ladder until an engine returns.

    Every failure is observable: a ``fallback`` instant event
    (from_engine, to_engine, reason) and the ``fallback.count`` session
    counter, and each degraded attempt runs inside a ``fallback`` span. The
    :class:`repro_torch.obs.MatchTelemetry` record of the engine that
    delivered carries ``fallback.count`` (0 on the clean path). Validation
    and invariant errors are *not* absorbed: a bad stream fails every
    engine alike. On the card only a :class:`PlanRefusedError` is absorbed
    and the ladder holds only kernel rungs, so it ends in a kernel's result,
    in :class:`FallbackExhaustedError`, or in the error of a kernel that
    failed to build or launch; on the CPU every other error is absorbed,
    as in the JAX package.
    """
    attempts, absorbed = _ladder(schedule, seg_block, stream.device)
    failures = []
    for idx, (engine, overrides, label) in enumerate(attempts):
        kw = {"seg_block": seg_block, **overrides}
        ncalls = len(telemetry.match_calls)
        span = (
            telemetry.span("fallback", engine=label, attempt=idx)
            if failures
            else obs.NULL_SPAN
        )
        try:
            with span:
                out = _run_engine(
                    engine, stream, cfg, packed=packed, waves=waves, max_width=max_width,
                    seg_block=kw["seg_block"], telemetry=telemetry, mb0=mb0,
                )
        except (_guard.StreamValidationError, _guard.MatchingInvariantError):
            raise
        except absorbed as err:  # noqa: BLE001 (the availability ladder)
            failures.append((label, err))
            if telemetry.enabled:
                nxt = attempts[idx + 1][2] if idx + 1 < len(attempts) else None
                telemetry.event(
                    "fallback",
                    from_engine=label,
                    to_engine=nxt,
                    reason=f"{type(err).__name__}: {err}"[:500],
                )
                telemetry.counters.add("fallback.count")
            if idx + 1 == len(attempts):
                raise FallbackExhaustedError(failures) from err
            continue
        if telemetry.enabled and len(telemetry.match_calls) > ncalls:
            # the degradation depth, on the record of the engine that delivered
            telemetry.match_calls[-1].counters["fallback.count"] = len(failures)
        return out
    raise FallbackExhaustedError(failures)


def match_epochs(
    stream,
    cfg: SubstreamConfig,
    *,
    epochs: int = 1,
    engine: str = "mega",
    state: MatchState | None = None,
    snapshots=None,
    guard=None,
    packed: bool | None = None,
    telemetry=obs.DISABLED,
    validate: str = "off",
    on_plan_failure: str = "raise",
    max_width: int | None = None,
    seg_block: int | None = None,
    epoch_hook=None,
    device=None,
) -> MatchingResult:
    """Run Part 1 chunked into ``epochs`` resumable epochs.

    The stream is cut at :func:`epoch_bounds`; each epoch runs ``engine``
    (one of :data:`EPOCH_ENGINES`) on its slice with the carried matching
    bits as ``mb0`` and folds the result into a
    :class:`repro_torch.core.state.MatchState` on the host. Epoch bounds
    are barriers, so a wave schedule sees only the chains inside its
    epoch, and the result is bit-identical to the one-shot run for every
    engine: greedy matching is confluent in the carried bits, and the
    epochs' ``assigned`` slices concatenate.

    Resumability:

    * ``snapshots`` (a :class:`repro_torch.checkpoint.snapshots
      .SnapshotManager`) commits the state after every epoch and, when
      ``state`` is not given, resumes from the latest committed snapshot
      (this package's or the JAX package's: the layout on disk is the
      same), replaying only the remaining suffix;
    * ``state`` resumes from a carried state (this package's, or the JAX
      package's through :func:`repro_torch.convert.state_from_reference`);
    * either way a state made for another stream, config or storage raises
      :class:`~repro_torch.checkpoint.snapshots.SnapshotMismatchError`, and
      one that does not hold together (:meth:`MatchState.problems`)
      :class:`~repro_torch.checkpoint.snapshots.SnapshotCorruptError`;
    * ``guard`` (a :class:`repro_torch.core.executor.ExecutionGuard`) wraps
      each epoch's device work: per-epoch deadline, bounded retries with
      exponential backoff on transient faults, straggler EWMA. A plan the
      card refuses is the fallback ladder's job: pass
      ``on_plan_failure="fallback"`` to degrade engines inside the epoch.

    ``validate`` checks (or sanitizes) the whole stream before the first
    epoch (:func:`repro_torch.core.guard.validate_stream`). ``telemetry``
    records one ``epoch.index`` event per executed epoch, the
    ``epoch.count`` counter and each engine call's record.
    ``epoch_hook(epoch_index, state)`` fires after each epoch's snapshot
    commit (the crash-injection seam of
    :func:`repro_torch.testing.faultline.kill_at_epoch`).

    ``packed=None`` follows ``cfg.mb_layout``; ``device=None`` runs on the
    card, and the result's tensors lie there.
    """
    if engine not in EPOCH_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use {EPOCH_ENGINES}")
    _check_on_plan_failure(on_plan_failure)
    packed = _resolve_packed(cfg, packed)
    dev = resolve_device(device)
    stream = stream.to(dev)
    if validate != "off":
        stream, _ = _guard.validate_stream(stream, cfg.n, policy=validate, telemetry=telemetry)
    if cfg.n == 0:
        return _empty_result(stream, cfg, packed)
    template = MatchState.initial(stream, cfg, packed)
    if state is None and snapshots is not None:
        state = snapshots.latest(template)
    if state is None:
        state = template
    elif state.fingerprint != template.fingerprint:
        raise SnapshotMismatchError(
            f"carried state fingerprints {state.fingerprint!r}, run fingerprints "
            f"{template.fingerprint!r}: another stream, config or storage layout"
        )
    elif state.problems():
        raise SnapshotCorruptError(f"carried state is inconsistent: {state.problems()}")
    bounds = epoch_bounds(stream.num_edges, epochs)
    fallback = on_plan_failure == "fallback" and engine in ("edges", "waves", "mega")
    for k in range(epochs):
        a, b = max(bounds[k], state.pos), bounds[k + 1]
        if b <= state.pos:
            continue  # already in the carried state
        sub = EdgeStream(
            src=stream.src[a:b], dst=stream.dst[a:b],
            weight=stream.weight[a:b], valid=stream.valid[a:b],
        )
        telemetry.event("epoch.index", epoch=k, start=a, end=b, engine=engine)
        telemetry.count("epoch.count")
        mb0 = None if state.mb0 is None else torch.from_numpy(state.mb0.copy()).to(dev)

        def run_one(sub=sub, mb0=mb0):
            kw = dict(packed=packed, waves=None, max_width=max_width, seg_block=seg_block,
                      telemetry=telemetry, mb0=mb0)
            if fallback:
                return _substream_match_fallback(engine, sub, cfg, **kw)
            return _run_engine(engine, sub, cfg, **kw)

        out = guard.run(run_one, label=f"epoch[{k}]") if guard is not None else run_one()
        state = state.advance(out, b)
        if snapshots is not None:
            snapshots.save(state)
        if epoch_hook is not None:
            epoch_hook(k, state)
    if snapshots is not None:
        snapshots.wait()
    return state.result(dev)
