"""Fill-packed wave decomposition of an edge stream into conflict-free batches.

The paper's edge processor (§4.4) consumes one edge per cycle because
consecutive stream edges may share a vertex and therefore race on the
same matching-bit row. But greedy matching w.r.t. a fixed edge order is
*confluent* over vertex-disjoint edges: if no two edges of a batch share
an endpoint, processing the batch in any order — or simultaneously —
yields bit-identical matching bits and recorded lists. So the stream can
be cut into **waves** such that every wave is vertex-disjoint while
conflicting edges keep their stream order across waves.

Scheduling (the tentpole of this module) is earliest-fit packing:
every edge goes into the earliest wave that is

* at or past its **conflict depth** — one past the wave of every earlier
  edge sharing an endpoint, tracked with per-vertex next-free-wave
  pointers, and
* not **full** — when ``max_width`` caps wave occupancy, full waves are
  skipped via an interval-union skip list, so scheduling stays near-O(m).

With no occupancy cap (the default) earliest-fit collapses to the pure
conflict-depth assignment, which is *provably minimal*: the wave count
equals the longest conflict chain (≥ the maximum vertex multiplicity —
every edge at the hub vertex needs its own wave), so no valid
vertex-disjoint decomposition can use fewer waves. The depth pass is
fully vectorized as numpy batch passes over ready edges (an indegree
peel of the 2-predecessor conflict DAG), replacing the former per-edge
Python loop; the capped path keeps the sequential earliest-fit packer.

Layout (where the "fill-packed" in the title lives): waves are *not*
padded to one global maximum width. They are packed back-to-back into
fixed-size **segments** of ``SEG`` slots (a wave of size s occupies
``ceil(s / SEG)`` segments; only its last segment carries padding), so
``slots`` is ``[num_segments, SEG]`` and the fill — the fraction of
slots holding a real edge — stays high regardless of wave-size skew.
Each segment is a *subset* of one wave and therefore vertex-disjoint
itself: every consumer that processes "one slots-row at a time" (the
plain wave scan, the segment kernel's plain version) keeps its
row-major contract unchanged, with per-row traffic proportional to
``SEG`` instead of the largest wave.

This module is pure scheduling — numpy in, numpy out, no dependency on
:mod:`repro_torch.core` — so the plain wave engine
(`repro_torch.core.matching.mwm_waves`) and the CUDA wave kernels
(`repro_torch.kernels.substream_match`) share one schedule. Schedules
are reusable across `L`/`eps` sweeps because they depend only on the
edge endpoints and order. It is the JAX package's
``repro.graph.waves``, array for array, telemetry spans and counters
included (:mod:`repro_torch.obs`): the port keeps its own copy because
it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs

#: Slots per segment — the row width of ``WaveSchedule.slots`` and the
#: trip unit of every vectorized consumer. Waves are padded only up to
#: the next multiple of ``SEG`` (not to a global max), so per-wave
#: padding is < SEG slots.
SEG = 8


@dataclasses.dataclass(frozen=True)
class WaveSchedule:
    """A conflict-free, fill-packed wave decomposition of one edge stream.

    ``wave`` int32 [m]: wave id per stream position (-1 = unscheduled,
    i.e. a padding edge). ``order`` int32 [num_scheduled]: stream
    positions sorted by (wave, stream position) — the wave-major
    permutation. ``offsets`` int32 [num_waves + 1]: CSR offsets of each
    wave inside ``order``. ``slots`` int32 [num_segments, SEG]: the
    packed slot layout — wave k occupies segment rows
    ``seg_offsets[k] : seg_offsets[k + 1]`` back-to-back, -1 in the
    (< SEG) padding slots at its tail. Every row is vertex-disjoint (a
    subset of one wave), which is the only invariant row-major consumers
    need.

    ``schedule_seconds`` / ``pack_seconds`` record the host cost of the
    assignment and layout phases (``time.perf_counter``).
    """

    wave: np.ndarray
    order: np.ndarray
    offsets: np.ndarray
    slots: np.ndarray
    seg_offsets: np.ndarray
    num_edges: int
    schedule_seconds: float = 0.0
    pack_seconds: float = 0.0

    @property
    def num_waves(self) -> int:
        return int(self.offsets.shape[0]) - 1

    @property
    def num_segments(self) -> int:
        return int(self.slots.shape[0])

    @property
    def width(self) -> int:
        """Slots per segment row (= ``SEG``; kept as the legacy name)."""
        return int(self.slots.shape[1])

    @property
    def num_scheduled(self) -> int:
        return int(self.order.shape[0])

    @property
    def fill(self) -> float:
        """Fraction of slots holding a real edge (1.0 = no padding)."""
        total = self.slots.size
        return self.num_scheduled / total if total else 1.0

    def wave_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def max_wave_size(self) -> int:
        sizes = self.wave_sizes()
        return int(sizes.max()) if sizes.size else 0


def _conflict_links(su: np.ndarray, sv: np.ndarray):
    """Successor links of the conflict DAG over ranks 0..k-1.

    Edge r (endpoints ``su[r]``, ``sv[r]``) conflicts with the previous
    and next edge touching either endpoint. Returns (succ int32 [k, 2],
    pred_count int32 [k]): ``succ[r, s]`` is the rank of the next edge
    at r's endpoint s (-1 = none), ``pred_count[r]`` how many earlier
    edges r directly waits on (0, 1, or 2). Self-loops contribute one
    endpoint entry, so an edge never depends on itself.
    """
    k = su.shape[0]
    loop = su == sv
    ranks = np.arange(k, dtype=np.int64)
    vert = np.concatenate([su, sv[~loop]])
    rank = np.concatenate([ranks, ranks[~loop]])
    side = np.concatenate(
        [np.zeros(k, np.int8), np.ones(int((~loop).sum()), np.int8)]
    )
    o = np.lexsort((rank, vert))
    vo, ro, so = vert[o], rank[o], side[o]
    same = np.empty(len(o), bool)
    if len(o):
        same[0] = False
        same[1:] = vo[1:] == vo[:-1]
    i = np.nonzero(same)[0]
    succ = np.full((k, 2), -1, np.int64)
    succ[ro[i - 1], so[i - 1]] = ro[i]
    pred_count = np.zeros(k, np.int64)
    np.add.at(pred_count, ro[i], 1)
    return succ, pred_count


def _assign_depth_batched(su: np.ndarray, sv: np.ndarray) -> np.ndarray:
    """Conflict depth per rank via numpy batch passes over ready edges.

    Pass t resolves exactly the edges of depth t (an edge is ready once
    every earlier edge sharing an endpoint has a depth, and its depth is
    one past its deepest predecessor — so the ready frontier of pass t
    IS depth level t). Each edge enters the frontier once and notifies
    at most two successors, so total element work is O(m) spread over
    ``depth_max`` vectorized passes — no per-edge Python loop.
    """
    k = su.shape[0]
    depth = np.zeros(k, np.int64)
    if k == 0:
        return depth
    succ, waiting = _conflict_links(su, sv)
    frontier = np.nonzero(waiting == 0)[0]
    d = -1
    while frontier.size:
        d += 1
        depth[frontier] = d
        nxt = succ[frontier].reshape(-1)
        nxt = nxt[nxt >= 0]
        if not nxt.size:
            break
        np.subtract.at(waiting, nxt, 1)
        frontier = nxt[waiting[nxt] == 0]
        if frontier.size > 1:
            # a rank occurs twice in ``nxt`` when both of its
            # predecessors resolved this pass
            frontier = np.unique(frontier)
    return depth


def _assign_earliest_fit(
    su: np.ndarray, sv: np.ndarray, max_width: int
) -> np.ndarray:
    """Sequential earliest-fit packer with per-wave occupancy ``max_width``.

    Every edge lands in the earliest wave at or past its conflict depth
    (per-vertex next-free-wave pointers in ``avail``) that still has a
    free slot. Full waves never reopen, so they are skipped with an
    interval union (path-halving) — amortized near-O(1) per edge, where
    a linear "first open wave" rescan would be quadratic on streams of
    mostly-independent edges that all target the lowest waves.
    """
    k = su.shape[0]
    n_hint = int(max(su.max(), sv.max())) + 1 if k else 1
    avail = np.zeros(n_hint, dtype=np.int64)  # next free wave per vertex
    counts: list[int] = []  # occupancy per wave
    parent: list[int] = []  # skip pointers over full waves
    wave = np.empty(k, dtype=np.int64)

    def _find_open(w: int) -> int:
        while w < len(counts) and parent[w] != w:
            nxt = parent[w]
            if nxt < len(counts) and parent[nxt] != nxt:
                parent[w] = parent[nxt]
            w = nxt
        return w

    for r in range(k):
        u = su[r]
        v = sv[r]
        w = _find_open(int(max(avail[u], avail[v])))
        if w == len(counts):
            counts.append(0)
            parent.append(w)
        counts[w] += 1
        if counts[w] >= max_width:
            parent[w] = w + 1
        wave[r] = w
        avail[u] = w + 1
        avail[v] = w + 1
    return wave


def wave_schedule(
    src,
    dst,
    valid=None,
    order=None,
    max_width: int | None = None,
    seg: int = SEG,
    telemetry=obs.DISABLED,
) -> WaveSchedule:
    """Decompose a stream into vertex-disjoint, fill-packed waves.

    ``order`` (optional int array [m]) pre-permutes the stream — e.g.
    ``repro_torch.core.blocked.lexicographic_order`` — so the waves respect the
    *processing* order rather than the arrival order; the returned
    schedule still indexes original stream positions. ``valid`` masks
    padding edges, which are left unscheduled (``wave == -1``).

    ``max_width`` (default None = uncapped) bounds per-wave occupancy
    via the sequential earliest-fit packer; uncapped scheduling is the
    vectorized conflict-depth assignment, which is wave-count minimal.
    Either way every edge is placed at or past its conflict depth, so
    any two edges sharing a vertex land in distinct waves in processing
    order while independent edges pack together. ``seg`` is the slot
    width of the packed layout (see :data:`SEG`).

    ``telemetry`` records the two host phases as spans
    (``wave_schedule.assign`` / ``wave_schedule.pack``) plus the schedule
    geometry counters; ``schedule_seconds`` / ``pack_seconds`` hold the
    *same* stopwatch measurements, so there is one timing path either way.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = src.shape[0]
    if dst.shape[0] != m:
        raise ValueError(f"src/dst length mismatch: {m} vs {dst.shape[0]}")
    if max_width is not None and max_width < 1:
        raise ValueError(f"max_width must be >= 1, got {max_width}")
    if seg < 1:
        raise ValueError(f"seg must be >= 1, got {seg}")
    valid_np = (
        np.ones(m, dtype=bool) if valid is None else np.asarray(valid, dtype=bool)
    )
    positions = np.arange(m) if order is None else np.asarray(order, dtype=np.int64)
    positions = positions[valid_np[positions]]

    with obs.stopwatch(telemetry, "wave_schedule.assign") as sw_assign:
        su = src[positions]
        sv = dst[positions]
        if max_width is None:
            wave_of_rank = _assign_depth_batched(su, sv)
        else:
            wave_of_rank = _assign_earliest_fit(su, sv, max_width)
        wave = np.full(m, -1, dtype=np.int64)
        wave[positions] = wave_of_rank

    with obs.stopwatch(telemetry, "wave_schedule.pack") as sw_pack:
        num_waves = int(wave_of_rank.max()) + 1 if wave_of_rank.size else 0
        scheduled = np.nonzero(wave >= 0)[0]
        # wave-major, stream-position-minor: stable sort on the wave key alone
        # (``scheduled`` is already ascending in stream position)
        order_out = scheduled[np.argsort(wave[scheduled], kind="stable")]
        counts = np.bincount(wave[scheduled], minlength=max(num_waves, 1))[:num_waves]
        offsets = np.zeros(num_waves + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])

        # fill-packed layout: wave k occupies ceil(counts[k] / seg) segment
        # rows back-to-back; only its last row carries (< seg) padding
        seg_counts = -(-counts // seg)
        seg_offsets = np.zeros(num_waves + 1, dtype=np.int64)
        np.cumsum(seg_counts, out=seg_offsets[1:])
        num_segments = int(seg_offsets[-1])
        slots = np.full((num_segments, seg), -1, dtype=np.int64)
        if num_segments:
            within = np.arange(len(order_out)) - np.repeat(offsets[:-1], counts)
            row = np.repeat(seg_offsets[:-1], counts) + within // seg
            slots[row, within % seg] = order_out

    schedule = WaveSchedule(
        wave=wave.astype(np.int32),
        order=order_out.astype(np.int32),
        offsets=offsets.astype(np.int32),
        slots=slots.astype(np.int32),
        seg_offsets=seg_offsets.astype(np.int32),
        num_edges=m,
        schedule_seconds=sw_assign.seconds,
        pack_seconds=sw_pack.seconds,
    )
    if telemetry.enabled:
        telemetry.counters.update(schedule_counters(schedule))
    return schedule


def schedule_counters(schedule: WaveSchedule) -> dict:
    """The schedule-geometry counter set (``schedule.*``): bit-exact
    copies of the schedule's own accounting."""
    return {
        "schedule.num_edges": int(schedule.num_edges),
        "schedule.num_waves": int(schedule.num_waves),
        "schedule.num_segments": int(schedule.num_segments),
        "schedule.seg_width": int(schedule.width),
        "schedule.num_scheduled": int(schedule.num_scheduled),
        "schedule.padding_slots": int(schedule.slots.size - schedule.num_scheduled),
        "schedule.max_wave_size": int(schedule.max_wave_size),
        "schedule.fill": float(schedule.fill),
    }


def layout_counters(layout: "BlockAlignedLayout", schedule: WaveSchedule) -> dict:
    """The block-aligned layout counter set (``layout.*``) — the mega
    path's extra padding accounting on top of :func:`schedule_counters`."""
    live = int((layout.slots >= 0).sum())
    return {
        "layout.num_tiles": int(layout.num_tiles),
        "layout.num_segments": int(layout.num_segments),
        "layout.seg_block": int(layout.seg_block),
        "layout.padding_rows": int(layout.num_segments - schedule.num_segments),
        "layout.padding_slots": int(layout.slots.size - live),
        "layout.fill": float(layout.fill),
    }


def validate_schedule(schedule: WaveSchedule, src, dst, valid=None) -> None:
    """Vectorized safety check that ``schedule`` fits this stream.

    Guards the documented reuse path (precomputed schedules amortized
    across runs) against stale schedules — e.g. one built for a stream
    that was permuted afterwards. A non-disjoint wave would corrupt the
    engines silently (the kernels' row-addressed scatter relies on
    disjointness), so this raises instead. Checks length, that exactly
    the valid edges are scheduled, and per-wave vertex-disjointness —
    all O(m log m) numpy, negligible next to a kernel run. Deliberately
    does NOT pin the conflict order to stream order: schedules built
    over an explicit processing ``order`` are legitimate and simply
    realize the greedy matching of that order.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    m = schedule.num_edges
    if src.shape[0] != m:
        raise ValueError(
            f"wave schedule built for {m} edges, stream has {src.shape[0]}"
        )
    valid_np = np.ones(m, bool) if valid is None else np.asarray(valid, bool)
    if not np.array_equal(schedule.wave >= 0, valid_np):
        raise ValueError(
            "wave schedule does not cover exactly this stream's valid "
            "edges; rebuild the schedule for the current stream"
        )
    order = schedule.order
    # the engines gather from ``slots``, so check it agrees with the
    # wave-major permutation (its non-padding entries ARE ``order``) —
    # a schedule whose derived fields drifted from its slot layout would
    # otherwise pass the wave checks below and still corrupt the gather
    flat = schedule.slots.reshape(-1)
    if not np.array_equal(flat[flat >= 0], order):
        raise ValueError(
            "wave schedule slot layout disagrees with its wave order "
            "(corrupted or hand-built schedule); rebuild it with "
            "wave_schedule on the current stream"
        )
    if order.size == 0:
        return
    # order must be in-range and duplicate-free BEFORE it is used to
    # index the stream: a negative entry would silently wrap through
    # numpy indexing (src[-5] is a real edge) and corrupt the gather
    # with no error — the exact failure mode this check exists to stop
    if order.min() < 0 or order.max() >= m or np.unique(order).size != order.size:
        raise ValueError(
            "wave schedule order is not a permutation of edge indices "
            "(out-of-range or duplicate entries; corrupted or "
            "hand-built schedule); rebuild it with wave_schedule on "
            "the current stream"
        )
    # per-wave disjointness: sort (wave, vertex) pairs over both
    # endpoints (self-loops contribute one), adjacent duplicates are
    # conflicts. Checked over the full wave, not just segment rows —
    # strictly stronger than what the row-major consumers need. The two
    # keys are fused into one int64 (vertex ids fit far below 2**31 and
    # wave ids below m, so wave * (max_vertex + 1) + vertex cannot
    # overflow or collide) — one np.sort instead of a two-pass lexsort,
    # which halves the dominant host cost every engine pays per call on
    # the precomputed-schedule path.
    u = src[order].astype(np.int64)
    v = dst[order].astype(np.int64)
    w_ids = schedule.wave[order].astype(np.int64)
    keep = u != v
    verts = np.concatenate([u, v[keep]])
    waves = np.concatenate([w_ids, w_ids[keep]])
    key = np.sort(waves * (int(verts.max()) + 1) + verts)
    dup = key[1:] == key[:-1]
    if dup.any():
        raise ValueError(
            "wave schedule is not vertex-disjoint for this stream "
            "(stale or built for a different edge order); rebuild it "
            "with wave_schedule on the current stream"
        )


def resolve_schedule(
    src,
    dst,
    valid,
    schedule: WaveSchedule | None = None,
    max_width: int | None = None,
    telemetry=obs.DISABLED,
) -> WaveSchedule:
    """Build a schedule for the stream, or validate a precomputed one.

    The single entry every wave consumer (`mwm_waves`, the CUDA wave
    path) goes through, so the validation rules stay in one place.
    ``telemetry`` records the build (or validation) cost as
    ``wave_schedule.*`` spans.
    """
    if schedule is None:
        return wave_schedule(
            src, dst, valid=valid, max_width=max_width, telemetry=telemetry
        )
    with telemetry.span("wave_schedule.validate"):
        validate_schedule(schedule, src, dst, valid)
    return schedule


@dataclasses.dataclass(frozen=True)
class BlockAlignedLayout:
    """A :class:`WaveSchedule` slot layout re-padded to ``seg_block`` tiles.

    The megakernel (`repro_torch.kernels.substream_match`) consumes the slot
    stream one *tile* — ``seg_block`` consecutive segment rows, i.e.
    ``seg_block * SEG`` slots — per gather/compute/scatter op. A tile op
    is only safe when every slot in the tile is vertex-disjoint, which
    holds exactly when no tile straddles a wave boundary. This layout
    therefore pads each wave's segment-row run up to the next
    ``seg_block`` multiple (padding rows are all ``-1``), so

    * ``slots`` is ``[num_tiles * seg_block, SEG]`` int32; rows
      ``seg_offsets[k] : seg_offsets[k + 1]`` belong to wave ``k`` and
      that range length is a ``seg_block`` multiple;
    * ``seg_offsets`` int32 [num_waves + 1] is monotone, block-aligned
      (every entry a ``seg_block`` multiple), and its last entry is the
      total aligned segment count;
    * every stream position scheduled by the source schedule occupies
      exactly one slot (padding only ever *adds* ``-1`` slots).

    ``fill`` is the real-edge fraction of the aligned layout — always
    ≤ the source schedule's fill; the megakernel trades it for a
    ~``seg_block``× cut in sequential tile trips.
    """

    slots: np.ndarray
    seg_offsets: np.ndarray
    seg_block: int
    num_edges: int

    @property
    def num_tiles(self) -> int:
        return int(self.slots.shape[0]) // self.seg_block

    @property
    def num_segments(self) -> int:
        return int(self.slots.shape[0])

    @property
    def width(self) -> int:
        return int(self.slots.shape[1])

    @property
    def fill(self) -> float:
        total = self.slots.size
        return int((self.slots >= 0).sum()) / total if total else 1.0


def block_aligned_layout(
    schedule: WaveSchedule, seg_block: int
) -> BlockAlignedLayout:
    """Re-pad ``schedule.slots`` so every wave spans whole tiles.

    Pure numpy re-layout (no re-scheduling): wave ``k``'s segment rows
    are copied back-to-back to a ``seg_block``-aligned base row and the
    gap up to the next aligned base is left as ``-1`` padding rows. The
    result is the megakernel's HBM slot stream: consecutive groups of
    ``seg_block`` rows ("tiles") never straddle a wave, so each tile is
    vertex-disjoint and one ``[seg_block * SEG, width]`` tile op per
    trip is bit-identical to the sequential scan.
    """
    if seg_block < 1:
        raise ValueError(f"seg_block must be >= 1, got {seg_block}")
    seg = schedule.width
    segc = np.diff(schedule.seg_offsets).astype(np.int64)
    segc_aligned = -(-segc // seg_block) * seg_block
    offsets = np.zeros(segc_aligned.shape[0] + 1, np.int64)
    np.cumsum(segc_aligned, out=offsets[1:])
    total = int(offsets[-1])
    slots = np.full((total, seg), -1, np.int64)
    if schedule.num_segments:
        src_rows = np.arange(schedule.num_segments, dtype=np.int64)
        wave_of_row = np.repeat(
            np.arange(schedule.num_waves, dtype=np.int64), segc
        )
        dst_rows = offsets[wave_of_row] + (
            src_rows - schedule.seg_offsets[wave_of_row]
        )
        slots[dst_rows] = schedule.slots
    return BlockAlignedLayout(
        slots=slots.astype(np.int32),
        seg_offsets=offsets.astype(np.int32),
        seg_block=seg_block,
        num_edges=schedule.num_edges,
    )


def check_block_aligned(layout: BlockAlignedLayout, schedule: WaveSchedule) -> None:
    """Assert the block-aligned invariants (host-side, used by tests).

    * offsets are monotone, ``seg_block``-aligned, and end at the total;
    * every slot of the source schedule is covered exactly once, in the
      same wave-major order (the non-padding entries ARE ``order``);
    * padding rows appear only at the tail of each wave's tile run, so
      no tile straddles a wave boundary — the invariant that makes one
      tile op per trip race-free.
    """
    offs = layout.seg_offsets
    sb = layout.seg_block
    assert offs[0] == 0 and offs[-1] == layout.num_segments
    assert (np.diff(offs) >= 0).all(), "offsets must be monotone"
    assert (offs % sb == 0).all(), "offsets must be seg_block-aligned"
    flat = layout.slots.reshape(-1)
    live = flat[flat >= 0]
    assert np.array_equal(live, schedule.order), "slot coverage/order"
    counts = np.bincount(live, minlength=schedule.num_edges)
    assert counts.max(initial=0) <= 1, "a stream position occupies two slots"
    for k in range(schedule.num_waves):
        rows = layout.slots[offs[k] : offs[k + 1]]
        members = schedule.order[schedule.offsets[k] : schedule.offsets[k + 1]]
        rflat = rows.reshape(-1)
        assert (rflat[: len(members)] == members).all(), f"wave {k} layout"
        assert (rflat[len(members) :] == -1).all(), f"wave {k} padding"


def scatter_slot_assignments(slots, vals, m: int):
    """Scatter per-slot kernel outputs back to stream positions.

    ``slots`` int [..., W] maps slots to stream positions (-1 = padding),
    ``vals`` the matching per-slot assigned indices (>= -1), both
    tensors on one device. Returns int32 [m] with -1 for unscheduled
    edges. Padding slots alias position 0 with value -1, so the
    max-scatter makes them exact no-ops.
    """
    flat = slots.reshape(-1).long()
    vals = vals.reshape(-1)[: flat.shape[0]].to(torch.int32)
    live = flat >= 0
    out = torch.full((m,), -1, dtype=torch.int32, device=flat.device)
    return out.scatter_reduce_(
        0, torch.where(live, flat, 0), torch.where(live, vals, -1), reduce="amax"
    )


def slot_arrays(schedule: WaveSchedule, src, dst, weight, valid=None):
    """Gather per-slot endpoint/weight arrays for vectorized consumers.

    Returns numpy ``(u, v, w, ok)``, each shaped [num_segments, SEG].
    Padding slots get ``u == v == 0`` and ``w == 0`` — below every
    substream threshold and a self-loop besides, so they can never match
    (the plain wave engine relies on this encoding; the kernel path
    remaps ``~ok`` slots to a sacrificial bit-block row, see
    ``ops.waves_inputs``).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    weight = np.asarray(weight)
    slots = schedule.slots
    ok = slots >= 0
    if valid is not None:
        ok = ok & np.where(slots >= 0, np.asarray(valid, bool)[np.maximum(slots, 0)], False)
    safe = np.maximum(slots, 0)
    u = np.where(ok, src[safe], 0).astype(np.int32)
    v = np.where(ok, dst[safe], 0).astype(np.int32)
    w = np.where(ok, weight[safe], 0).astype(np.float32)
    return u, v, w, ok


def greedy_depths(src, dst, valid=None, order=None) -> np.ndarray:
    """Reference conflict depths (0-based), sequential oracle.

    ``depth[e] = 1 + max(depth of previous edge at u, at v)`` walked in
    processing order — the per-edge loop the vectorized scheduler
    replaced, kept as the test oracle for the "every edge is placed at
    or past its conflict depth" invariant. Returns int64 [m], -1 for
    unscheduled (invalid) edges.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    m = src.shape[0]
    valid_np = np.ones(m, bool) if valid is None else np.asarray(valid, bool)
    positions = np.arange(m) if order is None else np.asarray(order, dtype=np.int64)
    n_hint = int(max(src.max(), dst.max())) + 1 if m else 1
    last = np.full(n_hint, -1, np.int64)
    depth = np.full(m, -1, np.int64)
    for e in positions.tolist():
        if not valid_np[e]:
            continue
        u, v = src[e], dst[e]
        d = 1 + max(last[u], last[v])
        depth[e] = d
        last[u] = d
        last[v] = d
    return depth


def check_schedule(schedule: WaveSchedule, src, dst, valid=None, order=None) -> None:
    """Assert the wave invariants (used by tests; cheap, host-side).

    * every scheduled wave is vertex-disjoint (self-loops use one slot);
    * conflicting edges appear in processing order across waves
      (``order`` is the explicit permutation the schedule was built
      with, if any — stream order otherwise);
    * every edge sits at or past its conflict depth (equal when the
      schedule is uncapped);
    * ``order``/``offsets``/``seg_offsets``/``slots`` describe the same
      fill-packed decomposition: wave k's members fill its segment rows
      back-to-back with padding only at the tail of its last row.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    wave = schedule.wave
    if valid is not None:
        valid = np.asarray(valid, bool)
        assert (wave[~valid] == -1).all(), "padding edges must be unscheduled"
        assert (wave[valid] >= 0).all(), "valid edges must be scheduled"
    seg = schedule.width
    for k in range(schedule.num_waves):
        members = schedule.order[schedule.offsets[k] : schedule.offsets[k + 1]]
        assert (wave[members] == k).all()
        verts = []
        for e in members.tolist():
            verts.append(src[e])
            if dst[e] != src[e]:
                verts.append(dst[e])
        assert len(verts) == len(set(verts)), f"wave {k} not vertex-disjoint"
        rows = schedule.slots[schedule.seg_offsets[k] : schedule.seg_offsets[k + 1]]
        flat = rows.reshape(-1)
        assert rows.shape[0] == -(-len(members) // seg), f"wave {k} segment count"
        assert (flat[: len(members)] == members).all(), f"wave {k} slot layout"
        assert (flat[len(members) :] == -1).all(), f"wave {k} slot padding"
    # depth floor: earliest-fit never places an edge before its conflict
    # depth (uncapped scheduling places it exactly there)
    depths = greedy_depths(src, dst, valid=valid, order=order)
    scheduled = wave >= 0
    assert (wave[scheduled] >= depths[scheduled]).all(), "edge above its depth"
    # order preservation among conflicting edges (in processing order)
    positions = (
        np.nonzero(scheduled)[0]
        if order is None
        else np.asarray(order)[wave[np.asarray(order)] >= 0]
    )
    touch: dict[int, int] = {}
    for e in positions.tolist():
        for x in {int(src[e]), int(dst[e])}:
            if x in touch:
                assert wave[touch[x]] < wave[e], (
                    f"edges {touch[x]} and {e} share vertex {x} but waves "
                    f"{wave[touch[x]]} >= {wave[e]}"
                )
            touch[x] = e
