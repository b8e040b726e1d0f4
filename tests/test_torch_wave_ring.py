"""The wave kernels' schedule, modelled in numpy and held to the JAX oracles.

The four CUDA kernels of ``csrc/substream_match_waves.cu`` share one walk:
the waves in one CTA of ``WAVE_THREADS`` threads with one barrier per wave,
a thread to a (slot, lane), a slot taking ``wave_lanes(lanes)`` lanes of
``WAVE_CHUNK_BITS`` substreams, on 64-bit words of the block: the packed
uint8 block itself, or a packed working copy of the unpacked int8 block
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
300}, through both kernels (mega at seg_block 1, 2 and 4) in both layouts,
with and without carried bits.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.bitpack import pack_bits as jpack
from repro.kernels.substream_match.ref import substream_match_ref as jref
from repro_torch.convert import config_from_reference, mb0_from_reference, stream_from_arrays
from repro_torch.graph import waves
from repro_torch.kernels.substream_match import kernel
from repro_torch.core.bitpack import pack_bits
from repro_torch.kernels.substream_match.ops import (
    _mb0_pad,
    device_plan,
    mega_inputs,
    resolve_stream_schedule,
    waves_inputs,
)
from repro_torch.testing.cases import WAVE, ZOO, permuted_lanes, rmat_case

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


def ring_model(ids, weights, thr, seg_offsets, n_pad, seg, bslots, mb_init, mega, packed=False):
    """The kernel's walk in numpy on the wrapper's operands (numpy in and
    out), in the layout ``packed`` names. Returns (assigned [total], block
    [n_pad, width] in the layout's type, stats)."""
    ids, weights, offsets = (np.asarray(x) for x in (ids, weights, seg_offsets))
    # one threshold a lane, as the wrapper hands them over: bit planes [8, width] as lane
    # 8k+j = thr[j, k]; unpacked lanes [1, width] and mega's flat vector as they are
    ids, thr = ids.reshape(-1).astype(np.int64), np.asarray(thr).T.reshape(-1)
    lanes = thr.shape[0]
    chunks = -(-lanes // BITS)
    G = kernel.wave_lanes(lanes)
    P = ITEMS // G
    rows = n_pad + kernel.SACRIFICIAL_ROWS
    if packed:  # the block is its own working copy: its rows are whole 64-bit words
        width = lanes // 8
        block = np.zeros((rows, width), np.uint8) if mb_init is None else np.array(mb_init, np.uint8)
        work = block.view("<u8")
        assert work.shape == (rows, chunks)
    else:
        width = lanes
        block = (np.zeros((rows, width), np.int8) if mb_init is None
                 else (np.asarray(mb_init) != 0).astype(np.int8))
        work = _pack(block, chunks)
    nw = offsets.shape[0] - 1
    assigned = np.full(weights.shape[0], -1, np.int32)
    lane_ids = np.arange(G)

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
        b = BITS * lane_ids[:, None] + np.arange(BITS)[None, :]
        if sorted_thr:
            bits = b[None] < val[:, None, None]
        else:
            ok = b < lanes
            t = np.where(ok, thr[np.minimum(b, lanes - 1)], 0)
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
    return assigned, (block if packed else _unpack(work, width))[:n_pad], stats


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


def _pad_mask(n, L, rows, width):
    """uint8 [rows, width]: the packed block's bits outside the n vertices' L substreams."""
    bits = np.ones((rows, 8 * width), bool)
    bits[:n, :L] = False
    return np.packbits(bits, axis=1, bitorder="little")


def _dense(mb, cfg, packed):
    """The block's bits of the n vertices' L substreams, bool [n, L]."""
    if packed:
        mb = np.unpackbits(mb, axis=1, bitorder="little")
    return mb[: cfg.n, : cfg.L] != 0


def _run(case, engine, carried=False, packed=False):
    """The model over the case's operands for one engine in one layout;
    returns the stream-order assigned and dense bits, and the model's stats.
    A carried packed block also holds random bits outside the vertices'
    substreams, which must come back unchanged."""
    want_a, want_mb, mb1 = _oracle(case, carried)
    js = _pair(case)[0]
    lo = js.src.shape[0] // 2 if carried else None
    stream, cfg = _stream(case, lo, None)
    if mb1 is not None and packed:
        mb1 = np.asarray(jpack(jnp.asarray(mb1)))
    mb0 = None if mb1 is None else mb0_from_reference(mb1, device="cpu")
    sch = resolve_stream_schedule(stream)
    if engine == "waves":
        args, slots = waves_inputs(stream, cfg, sch, mb0, packed=packed)
        edges, w, thr, offs, n_pad, seg, mb_init = args
        bslots, mega = 1, False
    else:
        args, slots = mega_inputs(stream, cfg, sch, int(engine[4:]), mb0, packed=packed)
        edges, w, thr, offs, n_pad, seg, seg_block, mb_init = args
        bslots, mega = seg_block * seg, True
    rng = np.random.default_rng(7)
    pad = None
    if mb_init is not None and packed:
        pad = _pad_mask(cfg.n, cfg.L, *mb_init.shape)
        mb_init = mb_init | torch.from_numpy(rng.integers(0, 256, pad.shape, np.uint8) & pad)
    elif mb_init is not None:  # a carried non-zero byte is a set bit, whatever its value
        mb_init = mb_init * torch.from_numpy(rng.integers(1, 100, mb_init.shape).astype(np.int8))
    a_slots, mb, stats = ring_model(edges.numpy(), w.numpy(), thr.numpy(), offs.numpy(), n_pad,
                                    seg, bslots, None if mb_init is None else mb_init.numpy(),
                                    mega, packed)
    if pad is not None:
        np.testing.assert_array_equal(mb & pad[:n_pad], mb_init.numpy()[:n_pad] & pad[:n_pad])
    got_a = waves.scatter_slot_assignments(slots, torch.from_numpy(a_slots),
                                           stream.num_edges).numpy()
    return got_a, _dense(mb, cfg, packed), (want_a, want_mb), stats


PARAMS = [(c, e) for c in sorted(CASES) for e in ENGINES]


@pytest.mark.parametrize("case, engine", PARAMS)
def test_ring_model_matches_oracles(case, engine):
    got_a, got_mb, (want_a, want_mb), _ = _run(case, engine)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


@pytest.mark.parametrize("case, engine", PARAMS)
def test_packed_ring_model_matches_oracles(case, engine):
    """The same walk on the packed block's own 64-bit words."""
    got_a, got_mb, (want_a, want_mb), _ = _run(case, engine, packed=True)
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


@pytest.mark.parametrize("engine", ["waves", "mega2"])
@pytest.mark.parametrize("case", CARRIED)
def test_packed_ring_model_carries_bits(case, engine):
    """The second half of the stream seeded with the first half's packed
    bits, and random bits past L and past n that come back unchanged."""
    got_a, got_mb, (want_a, want_mb), _ = _run(case, engine, carried=True, packed=True)
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


def _unsorted(case, packed):
    """The waves kernel on thresholds whose L lanes are permuted, against the
    dense oracle on the same permuted thresholds."""
    js, jcfg, _, _ = _pair(case)
    stream, cfg = _stream(case)
    args, slots = waves_inputs(stream, cfg, resolve_stream_schedule(stream), packed=packed)
    edges, w, planes, offs, n_pad, seg, _ = args
    planes = permuted_lanes(planes, jcfg.L)
    thr = planes.t().reshape(-1)[: jcfg.L].numpy()  # the thresholds in lane order
    a_slots, mb, _ = ring_model(edges.numpy(), w.numpy(), planes.numpy(), offs.numpy(), n_pad, seg,
                                1, None, False, packed)
    want_a, want_mb = jref(js.src, js.dst, jnp.where(js.valid, js.weight, 0.0), jnp.asarray(thr),
                           jcfg.n)
    got_a = waves.scatter_slot_assignments(slots, torch.from_numpy(a_slots), stream.num_edges)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(_dense(mb, cfg, packed), np.asarray(want_mb).astype(bool))


@pytest.mark.parametrize("case", ["rmat8_L13", "mixed_L64", "wide_L300"])
def test_ring_model_takes_unsorted_thresholds(case):
    """The waves kernel takes its thresholds in any order: with the lanes
    permuted no passing count is staged, and every compare is made inline.
    Held to the dense oracle on the same permuted thresholds."""
    _unsorted(case, packed=False)


@pytest.mark.parametrize("case", ["rmat8_L13", "mixed_L64", "wide_L300"])
def test_packed_ring_model_takes_unsorted_bit_planes(case):
    """The same with the bit planes [8, width] permuted across lanes."""
    _unsorted(case, packed=True)


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
    and the four wave kernels are entries of that one source, over one walk
    (count_passing, pack_block, unpack_block and the walk are its kernels)."""
    src = kernel.WAVES_SOURCE.read_text()
    want = {"kThreads": kernel.WAVE_THREADS,
            "kChunkBits": BITS, "kRingSlots": RING, "kAhead": AHEAD,
            "kOffsetAhead": OFF_AHEAD, "kOffsetRing": OFF_RING, "kStagers": kernel.WAVE_STAGERS,
            "kMaxBits": kernel.MAX_UNPACKED_WIDTH}
    for name, value in want.items():
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], name
    for entry in kernel.WAVE_NAMES:
        assert src.count(f'extern "C" int {entry}(') == 1, entry
    assert re.findall(r"__global__ void(?: __launch_bounds__\(kThreads, 1\))? (\w+)\(", src) == [
        "pack_block", "unpack_block", "count_passing", "substream_match_walk"]
    assert 8 * kernel.MAX_WIDTH == kernel.MAX_UNPACKED_WIDTH


@pytest.mark.parametrize("L", [1, 8, 13, 64, 65, 300, 2048])
def test_packed_block_is_the_working_copy(L):
    """A packed row (round_up(ceil(L/8), 8) bytes, LSB first) read as
    little-endian 64-bit words is the unpacked kernels' working copy of the
    same bits, so the packed kernels walk their own block; and both layouts
    give a slot the same lanes."""
    packed, unpacked = device_plan(21, L), device_plan(21, L, packed=False)
    rows = packed.n_pad + kernel.SACRIFICIAL_ROWS
    bits = torch.from_numpy(np.random.default_rng(L).random((21, L)) < 0.5)
    block = _mb0_pad(pack_bits(bits), 21, packed.words, rows, packed.width, "cpu").numpy()
    dense = _mb0_pad(bits, 21, L, rows, unpacked.width, "cpu", packed=False).numpy()
    chunks = -(-unpacked.width // BITS)
    np.testing.assert_array_equal(block.view("<u8"), _pack(dense, chunks))
    assert kernel.wave_lanes(8 * packed.width) == kernel.wave_lanes(unpacked.width)


@pytest.mark.parametrize("width, lanes", [(16, 1), (64, 1), (80, 2), (128, 2), (144, 4),
                                          (304, 8), (512, 8), (1024, 16), (2048, 32)])
def test_wave_lanes(width, lanes):
    assert kernel.wave_lanes(width) == lanes
