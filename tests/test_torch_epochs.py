"""Port parity of resumable execution: ``epoch_bounds``, ``MatchState``,
``fingerprint_for`` and ``match_epochs`` (the kernels' plain versions on the
CPU), held bit for bit against the JAX package's (``repro.core.state``,
``repro.kernels.substream_match.ops.match_epochs`` with ``engine="scan"``),
in both storage layouts. A state crosses between the packages both ways
and finishes bit-identically. No tolerance: ``assigned``, the bits, the
fingerprints and the state arrays are equal."""
import functools

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro.core.state import MatchState as JState
from repro.core.state import fingerprint_for as jfingerprint
from repro.kernels.substream_match import ops as jops
from repro_torch.checkpoint import SnapshotCorruptError, SnapshotMismatchError
from repro_torch.convert import config_from_reference, state_from_reference, stream_from_arrays
from repro_torch.core.state import MatchState, fingerprint_for
from repro_torch.kernels.substream_match.ops import (
    EPOCH_ENGINES,
    epoch_bounds,
    match_epochs,
)
from repro_torch.testing.cases import rmat_case

N, M, L = 44, 98, 12


def _adversarial():
    """The JAX package's resume-suite graph: duplicate edges, a self-loop,
    an invalid-masked tail, L % 8 != 0."""
    rng = np.random.default_rng(42)
    src = rng.integers(0, N, M).astype(np.int32)
    dst = rng.integers(0, N, M).astype(np.int32)
    w = rng.uniform(1.0, 60.0, M).astype(np.float32)
    src[10] = dst[10] = 7
    src[20], dst[20] = src[21], dst[21] = 3, 9
    valid = np.ones(M, bool)
    valid[[5, 50, 95]] = False
    return N, src, dst, w, valid, L, 0.1


def _rmat():
    c = rmat_case(8, edge_factor=4, L=13, pad=5, seed=3)
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    return (c.n, *(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)), c.L, c.eps)


GRAPHS = {"adversarial": _adversarial, "rmat8_L13": _rmat}


@functools.lru_cache(maxsize=None)
def _pair(graph):
    """The same stream and config in both packages (the reference's jitted
    thresholds carried into the port)."""
    n, src, dst, w, valid, L_, eps = GRAPHS[graph]()
    js = jcore.EdgeStream(src=jax.numpy.asarray(src), dst=jax.numpy.asarray(dst),
                          weight=jax.numpy.asarray(w), valid=jax.numpy.asarray(valid))
    jcfg = jcore.SubstreamConfig(n=n, L=L_, eps=eps)
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    stream = stream_from_arrays(src, dst, w, valid, device="cpu")
    return js, jcfg, stream, config_from_reference(n, L_, eps, thr)


@functools.lru_cache(maxsize=None)
def _reference(graph, packed, epochs=1):
    js, jcfg, _, _ = _pair(graph)
    out = jops.match_epochs(js, jcfg, epochs=epochs, engine="scan", packed=packed)
    return np.asarray(out.assigned), np.asarray(out.mb)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.assigned.numpy(), want[0])
    np.testing.assert_array_equal(got.mb.numpy(), want[1])


def test_epoch_bounds_match_reference():
    for m in (0, 1, 7, 98, 101, 44_350_400):
        for e in (1, 2, 3, 4, 7):
            assert epoch_bounds(m, e) == jops.epoch_bounds(m, e)
    with pytest.raises(ValueError):
        epoch_bounds(10, 0)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fingerprint_matches_reference(graph, packed):
    js, jcfg, stream, cfg = _pair(graph)
    assert fingerprint_for(stream, cfg, packed) == jfingerprint(js, jcfg, packed)
    other = config_from_reference(cfg.n, cfg.L + 1, cfg.eps, np.arange(1, cfg.L + 2, dtype=np.float32))
    assert fingerprint_for(stream, other, packed) != fingerprint_for(stream, cfg, packed)
    assert fingerprint_for(stream, cfg, not packed) != fingerprint_for(stream, cfg, packed)


@pytest.mark.parametrize("epochs", [1, 3, 4])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("engine", EPOCH_ENGINES)
def test_match_epochs_matches_reference(engine, packed, epochs):
    _, _, stream, cfg = _pair("adversarial")
    got = match_epochs(stream, cfg, epochs=epochs, engine=engine, packed=packed, device="cpu")
    assert got.is_packed == packed
    _assert_equal(got, _reference("adversarial", packed, epochs))
    if packed:
        want_packed = jcore.pack_bits(jax.numpy.asarray(_reference("adversarial", True)[1]))
        np.testing.assert_array_equal(got.mb_packed.numpy(), np.asarray(want_packed))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("engine", ["edges", "waves", "mega"])
def test_match_epochs_on_rmat(engine, packed):
    _, _, stream, cfg = _pair("rmat8_L13")
    got = match_epochs(stream, cfg, epochs=4, engine=engine, packed=packed, device="cpu")
    _assert_equal(got, _reference("rmat8_L13", packed))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("engine", ["edges", "mega", "waves", "scan"])
def test_reference_state_finishes_in_the_port(engine, packed):
    """A JAX run stopped after epoch 1 of 3 finishes in the port."""
    js, jcfg, stream, cfg = _pair("adversarial")
    states = {}
    jops.match_epochs(js, jcfg, epochs=3, engine="scan", packed=packed,
                      epoch_hook=lambda k, st: states.setdefault(k, st))
    jstate = states[0]
    state = state_from_reference(jstate.metadata(), jstate.to_arrays())
    assert state.pos == jstate.pos > 0 and state.problems() == []
    hook = []
    got = match_epochs(stream, cfg, epochs=3, engine=engine, packed=packed, state=state,
                       device="cpu", epoch_hook=lambda k, st: hook.append(k))
    assert hook == [1, 2]  # epoch 0 is in the carried state
    _assert_equal(got, _reference("adversarial", packed))


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("engine", ["edges", "mega", "waves", "ref"])
def test_port_state_finishes_in_the_reference(engine, packed):
    """A port run stopped after epoch 1 of 3 finishes in the JAX package."""
    js, jcfg, stream, cfg = _pair("adversarial")
    states = {}
    match_epochs(stream, cfg, epochs=3, engine=engine, packed=packed, device="cpu",
                 epoch_hook=lambda k, st: states.setdefault(k, st))
    state = states[0]
    jstate = JState.from_arrays(state.metadata(), state.to_arrays())
    assert jstate.problems() == []
    got = jops.match_epochs(js, jcfg, epochs=3, engine="scan", packed=packed, state=jstate)
    np.testing.assert_array_equal(np.asarray(got.assigned), _reference("adversarial", packed)[0])
    np.testing.assert_array_equal(np.asarray(got.mb), _reference("adversarial", packed)[1])


@pytest.mark.parametrize("packed", [True, False])
def test_match_state_follows_reference(packed):
    """initial, advance, metadata, arrays and the round trip agree with the
    JAX package's state after every epoch."""
    js, jcfg, stream, cfg = _pair("rmat8_L13")
    port_states, ref_states = [], []
    match_epochs(stream, cfg, epochs=3, engine="edges", packed=packed, device="cpu",
                 epoch_hook=lambda k, st: port_states.append(st))
    jops.match_epochs(js, jcfg, epochs=3, engine="scan", packed=packed,
                      epoch_hook=lambda k, st: ref_states.append(st))
    first = MatchState.initial(stream, cfg, packed)
    assert first.pos == 0 and first.mb0 is None and first.problems() == []
    assert first.metadata() == JState.initial(js, jcfg, packed).metadata()
    for st, jst in zip(port_states, ref_states, strict=True):
        assert st.metadata() == jst.metadata()
        for key, a in st.to_arrays().items():
            b = jst.to_arrays()[key]
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b)
        rebuilt = MatchState.from_arrays(st.metadata(), st.to_arrays())
        assert rebuilt.problems() == [] and rebuilt.mb.dtype == st.mb.dtype
    assert port_states[-1].done and not port_states[0].done
    with pytest.raises(ValueError, match="incomplete"):
        port_states[0].result()
    _assert_equal(port_states[-1].result(), _reference("rmat8_L13", packed))


def _torn(st, **change):
    fields = dict(fingerprint=st.fingerprint, pos=st.pos, num_edges=st.num_edges, n=st.n,
                  L=st.L, packed=st.packed, assigned=st.assigned, mb=st.mb,
                  recorded_counts=st.recorded_counts)
    return MatchState(**{**fields, **change})


def test_torn_state_is_detected_and_refused():
    _, _, stream, cfg = _pair("adversarial")
    states = []
    match_epochs(stream, cfg, epochs=3, engine="scan", device="cpu",
                 epoch_hook=lambda k, st: states.append(st))
    st = states[0]
    torn = _torn(st, recorded_counts=st.recorded_counts + 1)
    assert any("recorded_counts" in p for p in torn.problems())
    beyond = st.assigned.copy()
    beyond[-1] = 0
    assert any("beyond pos" in p for p in _torn(st, assigned=beyond).problems())
    assert any("mb shape" in p for p in _torn(st, mb=st.mb[:, :1]).problems())
    with pytest.raises(SnapshotCorruptError):
        match_epochs(stream, cfg, epochs=3, engine="scan", state=torn, device="cpu")
    with pytest.raises(ValueError, match="covers"):
        st.advance(match_epochs(stream, cfg, engine="scan", device="cpu"), st.pos + 1)


def test_mismatched_fingerprint_is_refused():
    _, _, stream, cfg = _pair("adversarial")
    _, _, other_stream, other_cfg = _pair("rmat8_L13")
    for state in (MatchState.initial(other_stream, other_cfg, True),
                  MatchState.initial(stream, cfg, False)):  # another layout
        with pytest.raises(SnapshotMismatchError):
            match_epochs(stream, cfg, epochs=2, engine="scan", state=state, device="cpu")


def test_completed_state_replays_nothing():
    _, _, stream, cfg = _pair("adversarial")
    states = []
    match_epochs(stream, cfg, epochs=2, engine="ref", device="cpu",
                 epoch_hook=lambda k, st: states.append(st))
    calls = []
    got = match_epochs(stream, cfg, epochs=2, engine="ref", state=states[-1], device="cpu",
                       epoch_hook=lambda k, st: calls.append(k))
    assert calls == []
    _assert_equal(got, _reference("adversarial", True))
    with pytest.raises(ValueError, match="unknown engine"):
        match_epochs(stream, cfg, engine="pallas", device="cpu")


def test_state_from_reference_checks_types():
    js, jcfg, _, _ = _pair("adversarial")
    jstate = JState.initial(js, jcfg, True)
    arrays = jstate.to_arrays()
    with pytest.raises(ValueError, match="assigned"):
        state_from_reference(jstate.metadata(), {**arrays, "assigned": arrays["assigned"].astype(np.int64)})
    state = state_from_reference(jstate.metadata(), arrays)
    assert state.fingerprint == jstate.fingerprint and isinstance(state.mb, np.ndarray)
    np.testing.assert_array_equal(state.mb, jstate.mb)
