"""Faithful substream-centric MWM, Listing 1 Part 1 of the paper: the
CS-SEQ oracle that every other Part-1 engine is held to, bit for bit, and
the same update over conflict-free waves (:func:`mwm_waves`).

One pass over the edge stream; for every edge all ``L`` substreams are
updated at once (the FPGA's bit-parallel matching-bit word). These are
Python loops on tensors, meant for tests and for comparing a kernel with
its plain version, not for speed.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.types import MatchingResult, SubstreamConfig, resolve_device, to_numpy


def greedy_scan(te: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, mb: torch.Tensor):
    """Listing 1's per-edge matching update on precomputed eligibility words.

    ``te`` [m, ...] holds each edge's eligibility word (bool lanes or uint8
    bit planes; self-loops and invalid edges already cleared), ``mb`` the
    matching bits [n, ...] of the same type, updated in place. Per edge
    e = (u, v): ``add = te & ~mb[u] & ~mb[v]``, then ``mb[u] |= add`` and
    ``mb[v] |= add``. Returns ``added`` [m, ...], each edge's ``add``.
    """
    added = torch.zeros_like(te)
    for i, (u, v) in enumerate(zip(src.tolist(), dst.tolist())):
        add = te[i] & ~mb[u] & ~mb[v]
        mb[u] |= add
        mb[v] |= add
        added[i] = add
    return added


def highest_lane(added: torch.Tensor) -> torch.Tensor:
    """int32 [m]: the highest True lane of each row of bool [m, L], or -1
    (Stage 7: Listing 1's descending loop records the first i added)."""
    lane = torch.arange(added.shape[1], dtype=torch.int32, device=added.device)
    return torch.where(added, lane, -1).amax(dim=1).to(torch.int32)


def mwm_scan(
    stream, cfg: SubstreamConfig, mb0: torch.Tensor | None = None, device=None
) -> MatchingResult:
    """Listing 1, Part 1, one edge at a time.

    ``mb0`` (bool [n, L], default zeros) seeds the matching bits.

    Per edge e=(u,v,w):
      te    = [w >= thr_i]_i & valid & (u != v)   (eligibility, Stage 4)
      add   = te & ~MB[u] & ~MB[v]                (Stage 5)
      MB[u]|= add ; MB[v]|= add                   (Stage 6)
      assigned = highest set bit of add, else -1  (Stage 7)
    """
    dev = resolve_device(device)
    stream = stream.to(dev)
    if cfg.n == 0:
        return MatchingResult(
            assigned=torch.full((stream.num_edges,), -1, dtype=torch.int32, device=dev),
            mb=torch.zeros((0, cfg.L), dtype=torch.bool, device=dev),
        )
    thr = torch.tensor(cfg.thresholds(), device=dev)
    te = (
        (stream.weight[:, None] >= thr)
        & stream.valid[:, None]
        & (stream.src != stream.dst)[:, None]
    )
    mb = (
        torch.zeros((cfg.n, cfg.L), dtype=torch.bool, device=dev)
        if mb0 is None
        else mb0.to(device=dev, dtype=torch.bool).clone()
    )
    added = greedy_scan(te, stream.src, stream.dst, mb)
    return MatchingResult(assigned=highest_lane(added), mb=mb)


def _wave_scan(u, v, w, ok, thr, mb):
    """One vectorized [SEG, L] update per segment row of the fill-packed
    slot arrays (:func:`repro_torch.graph.waves.slot_arrays`). Each row is
    a subset of one wave, hence vertex-disjoint. ``mb`` (bool [n, L]) is
    updated in place; returns the per-slot assigned [num_segments, SEG]."""
    idx = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    for i in range(u.shape[0]):
        wu, wv = u[i], v[i]
        te = (w[i][:, None] >= thr[None, :]) & ok[i][:, None] & (wu != wv)[:, None]
        add = te & ~mb[wu] & ~mb[wv]
        # scatter-OR: padding slots all alias row 0 with add == False, so
        # their duplicate indices add nothing
        mb.index_put_((wu,), add, accumulate=True)
        mb.index_put_((wv,), add, accumulate=True)
        idx[i] = highest_lane(add)
    return idx


def mwm_waves(
    stream,
    cfg: SubstreamConfig,
    schedule=None,
    max_width: int | None = None,
    mb0: torch.Tensor | None = None,
    device=None,
    telemetry=obs.DISABLED,
) -> MatchingResult:
    """Listing 1 Part 1 over conflict-free waves (the JAX package's
    waves_xla engine), one segment per loop step.

    Decomposes the stream with :func:`repro_torch.graph.waves.wave_schedule`
    (or validates a precomputed ``schedule``) and processes one
    vertex-disjoint segment at a time: bit-identical to :func:`mwm_scan`
    in ``assigned`` and ``mb``, because greedy matching is confluent over
    vertex-disjoint edges. ``mb0`` (bool [n, L]) seeds the matching bits.
    ``telemetry`` records the stage split of the kernel engines under the
    engine name ``waves_xla`` (its device stage is always ``execute``:
    plain torch builds nothing).
    """
    from repro_torch.graph import waves as _waves

    dev = resolve_device(device)
    stream = stream.to(dev)
    if cfg.n == 0:
        return MatchingResult(
            assigned=torch.full((stream.num_edges,), -1, dtype=torch.int32, device=dev),
            mb=torch.zeros((0, cfg.L), dtype=torch.bool, device=dev),
        )
    rec = obs.recorder(telemetry, "waves_xla", stream.num_edges, dev.type)
    src, dst, weight, valid = (
        to_numpy(t) for t in (stream.src, stream.dst, stream.weight, stream.valid)
    )
    if schedule is None:
        schedule = _waves.resolve_schedule(
            src, dst, valid, max_width=max_width, telemetry=telemetry
        )
        rec.add_stage("schedule", schedule.schedule_seconds)
        rec.add_stage("pack", schedule.pack_seconds)
    else:
        with rec.stage("schedule"):  # precomputed: validation cost only
            schedule = _waves.resolve_schedule(
                src, dst, valid, schedule=schedule, max_width=max_width, telemetry=telemetry
            )
    with rec.stage("layout"):
        u, v, w, ok = (
            torch.from_numpy(a).to(dev)
            for a in _waves.slot_arrays(schedule, src, dst, weight, valid)
        )
    if telemetry.enabled:
        rec.put_many(_waves.schedule_counters(schedule))
        rec.put("stream.num_edges", stream.num_edges)
    with rec.device_stage():
        mb = (
            torch.zeros((cfg.n, cfg.L), dtype=torch.bool, device=dev)
            if mb0 is None
            else mb0.to(device=dev, dtype=torch.bool).clone()
        )
        thr = torch.tensor(cfg.thresholds(), device=dev)
        idx = _wave_scan(u.long(), v.long(), w, ok, thr, mb)
        slots = torch.from_numpy(schedule.slots).to(dev)
        assigned = _waves.scatter_slot_assignments(slots, idx, stream.num_edges)
        rec.block((assigned, mb))
    rec.finish()
    return MatchingResult(assigned=assigned, mb=mb)
