"""Port parity of the wave scheduler: the port's copy of ``graph/waves.py``
builds, lays out and validates schedules array for array as the JAX
package's ``repro.graph.waves`` does, on the adversarial zoo and on RMAT
graphs of scales 10-12, in generated and in blocked order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.graph import waves as jwaves
from repro_torch.convert import schedule_from_reference
from repro_torch.graph import waves
from repro_torch.testing.cases import ZOO, rmat_case

CASES = {**ZOO,
         "rmat10": lambda: rmat_case(10, edge_factor=4, pad=3),
         "rmat11": lambda: rmat_case(11, edge_factor=4, seed=1),
         "rmat12": lambda: rmat_case(12, edge_factor=4, seed=2)}
FIELDS = ("wave", "order", "offsets", "slots", "seg_offsets")


def _stream(case):
    """Host arrays (src, dst, w, valid) of the reference's padded stream."""
    c = CASES[case]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    return js, tuple(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid))


def _order(js, blocked):
    return np.asarray(jcore.lexicographic_order(js, 4)) if blocked else None


def _assert_same_schedule(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == np.int32
    assert got.num_edges == want.num_edges


@pytest.mark.parametrize("max_width", [None, 3, 64])
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_schedule_matches_reference(case, blocked, max_width):
    js, (src, dst, _, valid) = _stream(case)
    order = _order(js, blocked)
    got = waves.wave_schedule(src, dst, valid=valid, order=order, max_width=max_width)
    want = jwaves.wave_schedule(src, dst, valid=valid, order=order, max_width=max_width)
    _assert_same_schedule(got, want)
    assert got.schedule_seconds >= 0 and got.pack_seconds >= 0
    assert waves.schedule_counters(got) == jwaves.schedule_counters(want)
    waves.check_schedule(got, src, dst, valid=valid, order=order)
    np.testing.assert_array_equal(
        waves.greedy_depths(src, dst, valid=valid, order=order),
        jwaves.greedy_depths(src, dst, valid=valid, order=order))


@pytest.mark.parametrize("seg_block", [1, 2, 4])
@pytest.mark.parametrize("case", ["bipartite", "dense_small", "self_loops", "rmat10", "rmat12"])
def test_layouts_and_slot_arrays_match_reference(case, seg_block):
    _, (src, dst, w, valid) = _stream(case)
    sch = waves.wave_schedule(src, dst, valid=valid)
    jsch = jwaves.wave_schedule(src, dst, valid=valid)
    got = waves.block_aligned_layout(sch, seg_block)
    want = jwaves.block_aligned_layout(jsch, seg_block)
    np.testing.assert_array_equal(got.slots, want.slots)
    np.testing.assert_array_equal(got.seg_offsets, want.seg_offsets)
    assert (got.num_tiles, got.fill) == (want.num_tiles, want.fill)
    waves.check_block_aligned(got, sch)
    assert waves.layout_counters(got, sch) == jwaves.layout_counters(want, jsch)
    for g, r in zip(waves.slot_arrays(sch, src, dst, w, valid),
                    jwaves.slot_arrays(jsch, src, dst, w, valid)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", ["unaligned_n", "rmat11"])
def test_scatter_slot_assignments_matches_reference(case):
    _, (src, dst, _, valid) = _stream(case)
    sch = waves.wave_schedule(src, dst, valid=valid)
    vals = np.random.default_rng(0).integers(-1, 64, sch.slots.shape).astype(np.int32)
    got = waves.scatter_slot_assignments(torch.from_numpy(sch.slots), torch.from_numpy(vals), src.size)
    want = jwaves.scatter_slot_assignments(jnp.asarray(sch.slots), jnp.asarray(vals), src.size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _corrupted(sch):
    """(name, schedule) variants that a stale or hand-built schedule could be."""
    rep = lambda **kw: waves.WaveSchedule(**{**{f: getattr(sch, f) for f in FIELDS},
                                            "num_edges": sch.num_edges, **kw})
    slots = sch.slots.copy()
    flat = slots.reshape(-1)
    live = np.nonzero(flat >= 0)[0]
    flat[live[0]], flat[live[1]] = flat[live[1]], flat[live[0]]
    order = sch.order.copy()
    order[0] = sch.num_edges + 5  # out of range, and the slots agree
    wave = np.zeros_like(sch.wave)
    wave[sch.wave < 0] = -1
    return [
        ("length", rep(num_edges=sch.num_edges + 1)),
        ("coverage", rep(wave=np.full_like(sch.wave, -1))),
        ("slots", rep(slots=slots)),
        ("permutation", rep(order=order, slots=np.where(sch.slots == sch.order[0], order[0], sch.slots))),
        ("disjoint", rep(wave=wave)),
    ]


@pytest.mark.parametrize("case", ["dense_small", "rmat10"])
def test_validate_schedule_rejects_as_reference(case):
    _, (src, dst, _, valid) = _stream(case)
    sch = waves.wave_schedule(src, dst, valid=valid)
    assert waves.resolve_schedule(src, dst, valid, schedule=sch) is sch
    if case == "rmat10":  # stale: built before the stream was permuted
        perm = np.random.default_rng(0).permutation(src.size)
        with pytest.raises(ValueError, match="vertex-disjoint|cover"):
            waves.validate_schedule(sch, src[perm], dst[perm], valid[perm])
    for name, bad in _corrupted(sch):
        jbad = jwaves.WaveSchedule(**{f: getattr(bad, f) for f in FIELDS}, num_edges=bad.num_edges)
        with pytest.raises(ValueError) as got:
            waves.validate_schedule(bad, src, dst, valid)
        with pytest.raises(ValueError) as want:
            jwaves.validate_schedule(jbad, src, dst, valid)
        assert str(got.value) == str(want.value), name
        assert {"length": "built for", "coverage": "cover", "slots": "slot layout",
                "permutation": "permutation", "disjoint": "vertex-disjoint"}[name] in str(got.value)
    with pytest.raises(ValueError, match="max_width"):
        waves.wave_schedule(src, dst, max_width=0)


def test_schedule_from_reference_keeps_the_arrays():
    _, (src, dst, _, valid) = _stream("rmat10")
    want = jwaves.wave_schedule(src, dst, valid=valid, max_width=5)
    got = schedule_from_reference(*(getattr(want, f) for f in FIELDS))
    _assert_same_schedule(got, want)
    waves.validate_schedule(got, src, dst, valid)
    with pytest.raises(ValueError, match="int32"):
        schedule_from_reference(want.wave.astype(np.int64), *(getattr(want, f) for f in FIELDS[1:]))
