"""Deterministic propose–accept parallel matching (the JAX package's
beyond-paper scaling path), as plain torch.

Greedy maximal matching under a fixed total edge order is unique and equals
the fixed point of "repeatedly take every live edge that is the smallest
live edge at both its endpoints" (parallel greedy, lexicographically-first
matching). The priority is the stream position, Listing 1's order, so the
result is bit-identical to :func:`repro_torch.core.matching.mwm_scan`:

* one device (:func:`mwm_rounds`): ``O(#rounds)`` passes of bulk
  scatter-min and gather work in place of the sequential ``O(m)`` scan;
* several (:func:`mwm_rounds_sharded`): edges shard over the mesh's
  ``data`` dimension, substreams over ``model``; one ``all_reduce`` MIN a
  round resolves the conflicts across edge shards.

A round is three passes. The kill clears the live bits of edges with a
matched endpoint and the scatter-min takes each vertex's least live edge
priority: both walk the edges in chunks of :data:`CHUNK_ELEMENTS`
``[edges, L]`` elements, so that no ``[m, L]`` int32 temporary exists (the
vertex minimum is order-free). The acceptance needs no scatter of the
winners' bits: a vertex is matched in a substream exactly when its least
live edge there is also the least at that edge's other endpoint, so the
new bits are ``[n, L]`` gathers. What stays is the live mask (bool
``[m, L]``), ``assigned`` (int32 ``[m]``), the ``[n, L]`` minimum and the
bits (a round at the paper config: ``scripts/rounds_passes.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import bitpack
from repro_torch.core.matching import eligibility, mwm_waves
from repro_torch.core.types import EdgeStream, MatchingResult, SubstreamConfig, resolve_device

_INF = torch.iinfo(torch.int32).max
#: elements of one ``[edges, L]`` temporary of a round (int32: 1 GiB)
CHUNK_ELEMENTS = 1 << 28


def _chunks(m: int, L: int) -> list[tuple[int, int]]:
    step = max(1, CHUNK_ELEMENTS // max(L, 1))
    return [(a, min(m, a + step)) for a in range(0, m, step)]


def _operands(stream: EdgeStream, thr: torch.Tensor):
    """(eligibility bool [m, L], src, dst int64 [m]) of a stream on its
    device. Self-loops and invalid edges are never eligible; invalid edges
    enter as vertex 0, where they touch nothing (the JAX package drops or
    clamps their out-of-range ids)."""
    src, dst = (torch.where(stream.valid, e, 0).long() for e in (stream.src, stream.dst))
    return eligibility(stream, thr), src, dst


def _kill(alive, mb, src, dst, chunks) -> torch.Tensor:
    """Clear the live bits of every edge with an endpoint matched in that
    substream (``mb`` None: nothing is matched yet). Returns a bool scalar
    on the device: whether any bit is still live."""
    live = torch.zeros((), dtype=torch.bool, device=alive.device)
    for a, b in chunks:
        al = alive[a:b]
        if mb is not None:
            al &= ~(mb[src[a:b]] | mb[dst[a:b]])
        live |= al.any()
    return live


def _vertex_min(alive, pri, src, dst, n: int, chunks) -> torch.Tensor:
    """int32 [n, L]: the least live incident-edge priority (INF where none)."""
    L = alive.shape[1]
    best = torch.full((n, L), _INF, dtype=torch.int32, device=alive.device)
    for a, b in chunks:
        pri_el = torch.where(alive[a:b], pri[a:b, None], _INF)
        for ends in (src, dst):
            best.scatter_reduce_(0, ends[a:b, None].expand(-1, L), pri_el, "amin")
    return best


def _accept(best, src, dst, lo: int, lane0: int, assigned) -> torch.Tensor:
    """bool [n, L]: the vertices matched this round, seen from the edges
    of this shard (priorities ``[lo, lo + m_loc)``). Vertex v is matched in
    lane l exactly when its least live edge e = ``best[v, l]`` is also the
    least at e's other endpoint: then e is the least at both, a winner.
    Each winner's highest lane (offset by ``lane0``) is max-ed into
    ``assigned`` at its shard position."""
    n, L = best.shape
    local = best.long() - lo
    mine = (best != _INF) & (local >= 0) & (local < src.shape[0])
    e = torch.where(mine, local, 0)
    v = torch.arange(n, device=best.device)[:, None]
    other = torch.where(mine, src[e] + dst[e] - v, v)
    won = mine & (torch.gather(best, 0, other) == best)
    lanes = torch.arange(lane0, lane0 + L, dtype=torch.int32, device=best.device)
    assigned.scatter_reduce_(0, e[won], lanes.expand(n, L)[won], "amax")
    return won


def _fixed_point(te, src, dst, n: int, cap: int, lo: int = 0, lane0: int = 0, group=None):
    """The propose–accept loop on one edge shard, whose edges have the
    priorities ``lo, lo + 1, ...``; ``te`` becomes the live mask. With
    ``group`` (the process group of the edge shards) the live test, the
    vertex minimum and the new bits are reduced across it every round.
    Returns (assigned int32 [m], bits bool [n, L], rounds, live)."""
    m, L = te.shape
    alive = te
    mb = torch.zeros((n, L), dtype=torch.bool, device=te.device)
    assigned = torch.full((m,), -1, dtype=torch.int32, device=te.device)
    pri = torch.arange(lo, lo + m, dtype=torch.int32, device=te.device)
    chunks = _chunks(m, L)
    rounds = 0
    while True:
        live = _kill(alive, mb if rounds else None, src, dst, chunks)
        if group is not None:
            live = live.to(torch.int32)
            dist.all_reduce(live, op=dist.ReduceOp.MAX, group=group)
        live = bool(live)  # the host decides whether to go on
        if not live or rounds >= cap:
            return assigned, mb, rounds, live
        best = _vertex_min(alive, pri, src, dst, n, chunks)
        if group is not None:
            dist.all_reduce(best, op=dist.ReduceOp.MIN, group=group)
        won = _accept(best, src, dst, lo, lane0, assigned)
        if group is not None:
            won = won.to(torch.uint8)  # gloo reduces no bool
            dist.all_reduce(won, op=dist.ReduceOp.MAX, group=group)
        mb |= won.bool()
        rounds += 1


def _empty(m: int, cfg: SubstreamConfig, packed: bool, dev) -> MatchingResult:
    """The result on a zero-vertex block: nothing matches."""
    assigned = torch.full((m,), -1, dtype=torch.int32, device=dev)
    bits = torch.zeros((0, cfg.L), dtype=torch.bool, device=dev)
    if packed:
        return MatchingResult(assigned, mb_packed=bitpack.pack_bits(bits), L=cfg.L)
    return MatchingResult(assigned, mb=bits)


def mwm_rounds(
    stream: EdgeStream, cfg: SubstreamConfig, max_rounds: int = 0,
    packed: bool = False, waves=None, telemetry=obs.DISABLED, device=None,
) -> MatchingResult:
    """Parallel-rounds equivalent of Listing 1 Part 1 (one device).

    ``max_rounds`` (0: no cap) stops the loop after that many rounds and
    returns the partial result. ``packed=True`` returns the bits as uint8
    bit planes (:mod:`repro_torch.core.bitpack`); the round state itself
    stays one byte a substream.

    ``waves`` (a :class:`repro_torch.graph.waves.WaveSchedule`) runs
    :func:`repro_torch.core.matching.mwm_waves` on it instead: one
    conflict-free segment a step, the same result. It takes no
    ``max_rounds`` (``ValueError``).

    ``telemetry`` records the call: the wave path's ``waves_xla`` record,
    or one ``rounds`` record whose device stage is the whole loop, with the
    counters ``rounds.max_rounds``, ``rounds.rounds`` (rounds run) and
    ``rounds.converged`` (no live edge left). ``device=None`` runs on the
    card.
    """
    dev = resolve_device(device)
    stream = stream.to(dev)
    if waves is not None:
        if max_rounds:
            raise ValueError(
                "max_rounds only applies to the propose-accept fixed point; "
                "the wave path always computes the full matching"
            )
        res = mwm_waves(stream, cfg, schedule=waves, device=dev, telemetry=telemetry)
        if packed:
            return MatchingResult(res.assigned, mb_packed=bitpack.pack_bits(res.mb), L=cfg.L)
        return res
    m = stream.num_edges
    if cfg.n == 0:
        return _empty(m, cfg, packed, dev)
    rec = obs.recorder(telemetry, "rounds", m, dev.type)
    if telemetry.enabled:
        rec.put("stream.num_edges", m)
        rec.put("rounds.max_rounds", int(max_rounds))
    with rec.device_stage():
        thr = torch.tensor(cfg.thresholds(), device=dev)
        te, src, dst = _operands(stream, thr)
        assigned, bits, rounds, live = _fixed_point(te, src, dst, cfg.n, max_rounds or m + 1)
        del te
        out = (
            MatchingResult(assigned, mb_packed=bitpack.pack_bits(bits), L=cfg.L)
            if packed else MatchingResult(assigned, mb=bits)
        )
        rec.block(out.assigned)
    if telemetry.enabled:
        rec.put("rounds.rounds", rounds)
        rec.put("rounds.converged", not live)
    rec.finish()
    return out


def mwm_rounds_sharded(
    stream: EdgeStream,
    cfg: SubstreamConfig,
    mesh,
    edge_axis: str = "data",
    substream_axis: str = "model",
) -> MatchingResult:
    """Distributed rounds over a :class:`torch.distributed.device_mesh.DeviceMesh`
    (:func:`repro_torch.distributed.build_mesh`): edges in contiguous
    shards over ``edge_axis``, substreams in contiguous slices over
    ``substream_axis``. Every rank is given the whole stream and takes its
    shard: global priority ``shard * m_loc + i``, the thresholds of its
    lanes. A round reduces over the edge shards only: the live test
    (``MAX``), the vertex minimum (``MIN``) and the new bits (``MAX``), so
    each substream slice runs its own loop. At the end ``assigned`` is
    max-reduced over the substream slices.

    Returns on every rank the whole result, as the JAX package's global
    arrays hold it: ``assigned`` int32 [m] and ``mb`` bool [n, L]
    (all-gathered). Requires ``m % shards == 0`` and ``L % slices == 0``
    (pad the stream with invalid edges). NCCL on the card, gloo on the
    CPU; on the card each rank runs on its current CUDA device.
    """
    dev = resolve_device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    edges, lanes = mesh.get_group(edge_axis), mesh.get_group(substream_axis)
    shards, slices = dist.get_world_size(edges), dist.get_world_size(lanes)
    m, L = stream.num_edges, cfg.L
    if m % shards or L % slices:
        raise ValueError(
            f"mwm_rounds_sharded needs m % {edge_axis} == 0 and L % {substream_axis} == 0: "
            f"m={m} over {shards} edge shards, L={L} over {slices} substream slices "
            "(pad the stream with invalid edges)"
        )
    m_loc, L_loc = m // shards, L // slices
    shard, piece = dist.get_rank(edges), dist.get_rank(lanes)
    lo, lane0 = shard * m_loc, piece * L_loc
    local = EdgeStream(*(t[lo:lo + m_loc].to(dev) for t in
                         (stream.src, stream.dst, stream.weight, stream.valid)))
    thr = torch.tensor(cfg.thresholds()[lane0:lane0 + L_loc], device=dev)
    te, src, dst = _operands(local, thr)
    assigned, bits, _, _ = _fixed_point(te, src, dst, cfg.n, m + 1, lo, lane0, group=edges)
    del te
    dist.all_reduce(assigned, op=dist.ReduceOp.MAX, group=lanes)
    parts = [torch.empty_like(assigned) for _ in range(shards)]
    dist.all_gather(parts, assigned, group=edges)
    bits = bits.view(torch.uint8)  # gloo gathers no bool
    blocks = [torch.empty_like(bits) for _ in range(slices)]
    dist.all_gather(blocks, bits, group=lanes)
    return MatchingResult(torch.cat(parts), mb=torch.cat(blocks, dim=1).view(torch.bool))
