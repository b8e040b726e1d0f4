"""The unpacked wave kernels' schedule, modelled in numpy and held to the JAX oracles.

The CUDA kernels of ``csrc/substream_match_waves_unpacked.cu`` walk the waves
in one CTA of ``WAVE_THREADS`` threads with one barrier per wave, a thread
to a (slot, lane), a slot taking ``wave_lanes(width)`` lanes of
``WAVE_CHUNK_BITS`` substreams, on a packed working copy of the int8 block
(packed before the walk, unpacked after it); a wave wider than a pass runs
in several. The slot stream is staged in rings in shared memory: the
segment offsets ``WAVE_OFFSET_AHEAD`` waves ahead, the ids and passing
counts of wave k + ``WAVE_AHEAD`` copied during wave k and landed by the
barrier before wave k + ``WAVE_AHEAD``, when the wave fits the ring with
the waves back to the current one; the others are read from global memory.
The model below follows those rules with the constants of
``kernel.py`` and keeps every ring as tagged positions: a read must find
the entry it wants, landed by its wave, and no wave may overwrite an entry
that it or a later wave still reads. It is held bit for bit, no tolerance,
to the JAX package's dense oracle (``repro.kernels.substream_match.ref``)
and CS-SEQ scan (``repro.core.mwm_scan``) on the zoo, RMAT 8/10 and the
streams aimed at the ring (two waves of 5,000 edges, a star of 3,000
leaves, waves that cross the ring's capacity both ways), at L in {13, 64,
300}, through both kernels (mega at seg_block 1, 2 and 4), with and without
carried bits.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.substream_match.ref import substream_match_ref as jref
from repro_torch.convert import config_from_reference, mb0_from_reference, stream_from_arrays
from repro_torch.graph import waves
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    mega_inputs,
    resolve_stream_schedule,
    waves_inputs,
)
from repro_torch.testing.cases import WAVE, ZOO, rmat_case

ITEMS = kernel.WAVE_THREADS
BITS, RING = kernel.WAVE_CHUNK_BITS, kernel.WAVE_RING_SLOTS
AHEAD, OFF_AHEAD, OFF_RING = kernel.WAVE_AHEAD, kernel.WAVE_OFFSET_AHEAD, kernel.WAVE_OFFSET_RING
LANDED = AHEAD  # a copy issued during wave k is read from wave k + LANDED on
U64 = np.uint64


class Ring:
    """A ring in shared memory: per position, the global index it holds, the
    wave that index belongs to, and the first wave that may read it."""

    def __init__(self, size, dtype):
        self.size = size
        self.tag = np.full(size, -1, np.int64)
        self.owner = np.full(size, np.iinfo(np.int64).min, np.int64)
        self.landed = np.full(size, np.iinfo(np.int64).max, np.int64)
        self.vals = np.zeros(size, dtype)

    def get(self, idx, wave):
        idx = np.asarray(idx, np.int64)
        pos = idx % self.size
        assert (self.tag[pos] == idx).all(), "the ring lost an entry before it was read"
        assert (self.landed[pos] <= wave).all(), "an entry read before it landed"
        return self.vals[pos]

    def put(self, idx, vals, owner, landed, live_from):
        """Write; no entry owned by a wave (or offset index) >= ``live_from``
        may be overwritten."""
        idx = np.asarray(idx, np.int64)
        pos = idx % self.size
        assert len(set(pos.tolist())) == pos.size, "a copy wraps onto itself"
        assert (self.owner[pos] < live_from).all(), "a live ring entry was overwritten"
        self.tag[pos], self.vals[pos] = idx, vals
        self.owner[pos], self.landed[pos] = owner, landed


def _pack(block, chunks):
    bits = np.zeros((block.shape[0], BITS * chunks), bool)
    bits[:, : block.shape[1]] = block != 0
    return np.packbits(bits, axis=1, bitorder="little").view("<u8").copy()


def _unpack(work, width):
    raw = work.view(np.uint8)
    return np.unpackbits(raw, axis=1, bitorder="little")[:, :width].astype(np.int8)


def ring_model(ids, weights, thr, seg_offsets, n_pad, seg, bslots, mb_init, mega):
    """The kernel's walk in numpy on the wrapper's operands (numpy in and
    out). Returns (assigned [total], block [n_pad, width], stats)."""
    ids, weights, thr, offsets = (np.asarray(x) for x in (ids, weights, thr, seg_offsets))
    ids, thr = ids.reshape(-1).astype(np.int64), thr.reshape(-1)
    width = thr.shape[0]
    chunks = -(-width // BITS)
    G = kernel.wave_lanes(width)
    P = ITEMS // G
    rows = n_pad + kernel.SACRIFICIAL_ROWS
    block = (np.zeros((rows, width), np.int8) if mb_init is None
             else (np.asarray(mb_init) != 0).astype(np.int8))
    work = _pack(block, chunks)
    nw = offsets.shape[0] - 1
    assigned = np.full(weights.shape[0], -1, np.int32)
    lanes = np.arange(G)

    def slot_of(k, wave):
        return int(off.get([k], wave)[0]) * seg

    def rel(r):
        if mega:
            t = r // bslots
            iu = 2 * t * bslots + (r - t * bslots)
            return iu, iu + bslots
        return 2 * r, 2 * r + 1

    # the pass before the walk: every slot's passing count (0 on a self-loop), staged in place of
    # the weights when the thresholds are sorted
    sorted_thr = bool((thr[:-1] <= thr[1:]).all())
    iu_all, iv_all = rel(np.arange(weights.shape[0]))
    loop = ids[iu_all] == ids[iv_all]
    counts = np.where(loop, 0, (thr[None, :] <= weights[:, None]).sum(axis=1)) if sorted_thr else None
    vals = counts if sorted_thr else weights
    off, id_ring, val_ring = Ring(OFF_RING, np.int64), Ring(2 * RING, np.int64), Ring(RING, vals.dtype)

    def eligibility(val, u, v):
        """uint64 [slots, G]: lane c's word over substreams 64c..64c+63, the prefix below
        the passing count, or (unsorted) bit i = (w >= thr[64c + i]), none on u == v."""
        b = BITS * lanes[:, None] + np.arange(BITS)[None, :]
        if sorted_thr:
            bits = b[None] < val[:, None, None]
        else:
            ok = b < width
            t = np.where(ok, thr[np.minimum(b, width - 1)], 0)
            bits = ok[None] & (val[:, None, None] >= t[None]) & (u != v)[:, None, None]
        return np.packbits(bits, axis=2, bitorder="little").view("<u8")[..., 0]

    def fetch(lo, r, staged, wave):
        """The items of slots lo + r: (u, v, te [slots, chunks])."""
        iu, iv = rel(r)
        if staged:
            u, v = id_ring.get(2 * lo + iu, wave), id_ring.get(2 * lo + iv, wave)
            val = val_ring.get(lo + r, wave)
        else:
            u, v, val = ids[2 * lo + iu], ids[2 * lo + iv], vals[lo + r]
        return u, v, eligibility(val, u, v)[:, :chunks]

    def stage_slots(k, wave, landed):
        lo, hi = slot_of(k, wave), slot_of(k + 1, wave)
        gi, si = np.arange(2 * lo, 2 * hi), np.arange(lo, hi)
        id_ring.put(gi, ids[gi], k, landed, wave)
        val_ring.put(si, vals[si], k, landed, wave)

    def run_pass(s, u, v, te):
        live = (te != 0).any(axis=1)
        a, b = work[u], work[v]  # both rows loaded before either is stored
        add = te & ~(a | b)
        work[u[live]] = (a | add)[live]
        work[v[live]] = (b | add)[live]
        hi_bit = np.full(add.shape, -1)
        for i in range(BITS):
            hi_bit = np.where((add >> U64(i)) & U64(1), i, hi_bit)
        assigned[s] = np.where(hi_bit >= 0, BITS * np.arange(chunks)[None] + hi_bit, -1).max(
            axis=1, initial=-1)
        return set(np.concatenate([u[live], v[live]]).tolist()), int(live.sum())

    # prologue (wave -1): the first offsets, waves 0 .. AHEAD-1 where they fit from slot 0, all
    # landed by the barrier
    first = np.arange(min(OFF_AHEAD, nw + 1))
    off.put(first, offsets[first], first, -1, 0)
    staged = set()
    for k in range(min(AHEAD, nw)):
        if slot_of(k + 1, -1) <= RING:
            staged.add(k)
            stage_slots(k, -1, 0)
    stats = {"staged": [], "width": [], "passes": 0}
    for k in range(nw):
        lo, hi = slot_of(k, k), slot_of(k + 1, k)
        ahead = k + AHEAD
        stage_ahead = ahead < nw and slot_of(ahead + 1, k) - lo <= RING
        if ahead + 1 < nw:  # the staging warps plan the next step's range in this wave
            slot_of(ahead + 2, k)
        stats["staged"].append(k in staged)
        stats["width"].append(hi - lo)
        # staging beside the chain (positions of waves >= k are live: wave k's are read in this
        # wave, the later ones are in flight)
        if k + OFF_AHEAD <= nw:
            off.put([k + OFF_AHEAD], offsets[[k + OFF_AHEAD]], k + OFF_AHEAD, k + LANDED, k)
        if stage_ahead:
            stage_slots(ahead, k, k + LANDED)
            staged.add(ahead)
        touched, live = set(), 0
        for base in range(0, hi - lo, P):
            r = np.arange(base, min(base + P, hi - lo))
            t, n = run_pass(lo + r, *fetch(lo, r, k in staged, k))
            touched |= t
            live += n
            stats["passes"] += 1
        assert len(touched) == 2 * live, "a wave's slots share a vertex"
    return assigned, _unpack(work, width)[:n_pad], stats


CASES = {**{f"zoo_{k}": v for k, v in ZOO.items()},
         "rmat8_L13": lambda: rmat_case(8, edge_factor=8, L=13, pad=3),
         "rmat8_L64": lambda: rmat_case(8, edge_factor=8, L=64, seed=4),
         "rmat8_L300": lambda: rmat_case(8, edge_factor=8, L=300, eps=0.01, seed=1),
         "rmat10_L13": lambda: rmat_case(10, edge_factor=4, L=13, pad=3, seed=5),
         "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64, seed=2),
         "rmat10_L300": lambda: rmat_case(10, edge_factor=4, L=300, eps=0.01, seed=3),
         **{f"{k}_L{L}": functools.partial(f, L) for k, f in WAVE.items() for L in (13, 64, 300)}}
ENGINES = ["waves", "mega1", "mega2", "mega4"]


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The same inputs for both packages: the reference's stream and its
    jitted thresholds, carried into the port (unpacked)."""
    c = CASES[case]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=c.L, eps=c.eps, mb_layout="unpacked")
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    return js, jcfg, thr, arrays


def _stream(case, lo=None, hi=None):
    js, jcfg, thr, arrays = _pair(case)
    stream = stream_from_arrays(*(a[lo:hi] for a in arrays), device="cpu")
    return stream, config_from_reference(jcfg.n, jcfg.L, jcfg.eps, thr, mb_layout="unpacked")


@functools.lru_cache(maxsize=None)
def _oracle(case, split):
    """The dense oracle over the stream (or, with ``split``, over its second
    half seeded with the first half's bits) and the scan; numpy."""
    js, jcfg, thr, _ = _pair(case)
    w = jnp.where(js.valid, js.weight, 0.0)
    t = jnp.asarray(thr)
    if not split:
        a, mb = jref(js.src, js.dst, w, t, jcfg.n)
        scan = jcore.mwm_scan(js, jcfg)
        np.testing.assert_array_equal(np.asarray(scan.assigned), np.asarray(a))
        np.testing.assert_array_equal(np.asarray(scan.mb), np.asarray(mb).astype(bool))
        return np.asarray(a), np.asarray(mb).astype(bool), None
    h = js.src.shape[0] // 2
    _, mb1 = jref(js.src[:h], js.dst[:h], w[:h], t, jcfg.n)
    a2, mb2 = jref(js.src[h:], js.dst[h:], w[h:], t, jcfg.n, mb0=mb1)
    return np.asarray(a2), np.asarray(mb2).astype(bool), np.asarray(mb1).astype(bool)


def _run(case, engine, carried=False):
    """The model over the case's operands for one engine; returns the
    stream-order assigned and dense bits, and the model's stats."""
    want_a, want_mb, mb1 = _oracle(case, carried)
    js = _pair(case)[0]
    lo = js.src.shape[0] // 2 if carried else None
    stream, cfg = _stream(case, lo, None)
    mb0 = None if mb1 is None else mb0_from_reference(mb1, device="cpu")
    sch = resolve_stream_schedule(stream)
    if engine == "waves":
        args, slots = waves_inputs(stream, cfg, sch, mb0, packed=False)
        edges, w, thr, offs, n_pad, seg, mb_init = args
        bslots, mega = 1, False
    else:
        args, slots = mega_inputs(stream, cfg, sch, int(engine[4:]), mb0, packed=False)
        edges, w, thr, offs, n_pad, seg, seg_block, mb_init = args
        bslots, mega = seg_block * seg, True
    if mb_init is not None:  # a carried non-zero byte is a set bit, whatever its value
        rng = np.random.default_rng(7)
        mb_init = mb_init * torch.from_numpy(rng.integers(1, 100, mb_init.shape).astype(np.int8))
    a_slots, mb, stats = ring_model(edges.numpy(), w.numpy(), thr.numpy(), offs.numpy(), n_pad,
                                    seg, bslots, None if mb_init is None else mb_init.numpy(),
                                    mega)
    got_a = waves.scatter_slot_assignments(slots, torch.from_numpy(a_slots),
                                           stream.num_edges).numpy()
    return got_a, mb[: cfg.n, : cfg.L] != 0, (want_a, want_mb), stats


PARAMS = [(c, e) for c in sorted(CASES) for e in ENGINES]


@pytest.mark.parametrize("case, engine", PARAMS)
def test_ring_model_matches_oracles(case, engine):
    got_a, got_mb, (want_a, want_mb), _ = _run(case, engine)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


CARRIED = ["zoo_unaligned_n", "rmat8_L13", "rmat10_L300", "wide_L64", "star_L300", "mixed_L13"]


@pytest.mark.parametrize("engine", ["waves", "mega2"])
@pytest.mark.parametrize("case", CARRIED)
def test_ring_model_carries_bits(case, engine):
    """The second half of the stream seeded with the first half's bits, the
    carried bytes any non-zero value."""
    got_a, got_mb, (want_a, want_mb), _ = _run(case, engine, carried=True)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


@pytest.mark.parametrize("case", ["rmat8_L13", "mixed_L64", "wide_L300"])
def test_ring_model_takes_unsorted_thresholds(case):
    """The waves kernel takes its thresholds in any order: with the lanes
    permuted no passing count is staged, and every compare is made inline.
    Held to the dense oracle on the same permuted thresholds."""
    js, jcfg, thr, _ = _pair(case)
    stream, cfg = _stream(case)
    perm = np.random.default_rng(5).permutation(jcfg.L)
    args, slots = waves_inputs(stream, cfg, resolve_stream_schedule(stream), packed=False)
    edges, w, lanes, offs, n_pad, seg, _ = args
    lanes = lanes.clone()
    lanes[0, : jcfg.L] = lanes[0, perm]
    a_slots, mb, _ = ring_model(edges.numpy(), w.numpy(), lanes.numpy(), offs.numpy(), n_pad, seg,
                                1, None, False)
    want_a, want_mb = jref(js.src, js.dst, jnp.where(js.valid, js.weight, 0.0),
                           jnp.asarray(thr[perm]), jcfg.n)
    got_a = waves.scatter_slot_assignments(slots, torch.from_numpy(a_slots), stream.num_edges)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(mb[: cfg.n, : cfg.L] != 0, np.asarray(want_mb).astype(bool))


def test_ring_cases_reach_the_ring():
    """The aimed streams do what they are named for at L = 64 (one lane per
    slot, a ring of 4,096 slots, 1,024 slots a pass): a wide wave is read
    from global memory in several passes, the star's waves are all staged,
    and the mixed widths give both kinds, staged behind direct and back,
    and staged waves wider than a pass."""
    _, _, _, wide = _run("wide_L64", "waves")
    assert not wide["staged"][0] and wide["passes"] > len(wide["staged"])
    _, _, _, star = _run("star_L64", "waves")
    assert len(star["staged"]) == 3000 and all(star["staged"])
    _, _, _, mixed = _run("mixed_L64", "mega2")
    staged = mixed["staged"]
    assert any(a and not b for a, b in zip(staged, staged[1:]))
    assert any(b and not a for a, b in zip(staged, staged[1:]))
    assert any(st and w > ITEMS for st, w in zip(staged, mixed["width"]))  # several passes
    _, _, _, wide300 = _run("wide_L300", "waves")  # 8 lanes a slot: 128 slots a pass
    assert wide300["passes"] >= 2 * -(-5000 // 128)


def test_schedule_constants_match_the_source():
    """kernel.py's constants are the CUDA source's compile-time constants,
    and the unpacked launchers live in their own source."""
    src = kernel.WAVES_UNPACKED_SOURCE.read_text()
    want = {"kThreads": kernel.WAVE_THREADS,
            "kChunkBits": BITS, "kRingSlots": RING, "kAhead": AHEAD,
            "kOffsetAhead": OFF_AHEAD, "kOffsetRing": OFF_RING, "kStagers": kernel.WAVE_STAGERS,
            "kMaxBits": kernel.MAX_UNPACKED_WIDTH}
    for name, value in want.items():
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], name
    for entry in (kernel.MEGA_UNPACKED_NAME, kernel.WAVES_UNPACKED_NAME):
        assert f'extern "C" int {entry}(' in src
        assert f'extern "C" int {entry}(' not in kernel.WAVES_SOURCE.read_text()
    for entry in (kernel.MEGA_NAME, kernel.WAVES_NAME):
        assert f'extern "C" int {entry}(' in kernel.WAVES_SOURCE.read_text()


@pytest.mark.parametrize("width, lanes", [(16, 1), (64, 1), (80, 2), (128, 2), (144, 4),
                                          (304, 8), (512, 8), (1024, 16), (2048, 32)])
def test_wave_lanes(width, lanes):
    assert kernel.wave_lanes(width) == lanes
