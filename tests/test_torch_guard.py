"""Port parity of the input guard: ``validate_stream``, ``stream_problems``
and ``ValidationReport`` (``repro_torch.core.guard``), held exactly against
the JAX package's (``repro.core.guard``) on the dirty zoo of
``tests/test_guard.py`` and on every input fault of ``faultline``: the same
problems (kind, count, positions, detail), the same report and counters,
and the same sanitized stream, array for array. The engines run on the
sanitized stream give the reference's ``mwm_scan`` bits. No tolerance."""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import obs as jobs
from repro.core import guard as jguard
from repro.testing import faultline as jfaultline
from repro_torch import obs
from repro_torch.convert import config_from_reference, stream_from_arrays
from repro_torch.core import (
    EdgeStream,
    StreamValidationError,
    SubstreamConfig,
    check_matching,
    mwm_scan,
    stream_problems,
    validate_stream,
)
from repro_torch.core.guard import MatchingInvariantError
from repro_torch.kernels.substream_match.ops import substream_match
from repro_torch.testing import faultline


def _dirty(n, src, dst, w, L=12, pad=0):
    """The zoo's arrays, let through the reference's cast unchecked."""
    js = jcore.EdgeStream.from_numpy(
        np.asarray(src), np.asarray(dst), np.asarray(w), n_pad=len(src) + pad, policy="off"
    )
    return n, js, L


def _nan_weights():
    rng = np.random.default_rng(21)
    w = rng.uniform(0.5, 6.0, 60)
    w[::7] = np.nan
    return _dirty(24, rng.integers(0, 24, 60), rng.integers(0, 24, 60), w)


def _inf_weights():
    rng = np.random.default_rng(22)
    w = rng.uniform(0.5, 6.0, 60)
    w[3] = np.inf
    w[10] = -np.inf
    return _dirty(24, rng.integers(0, 24, 60), rng.integers(0, 24, 60), w)


def _negative_weights():
    rng = np.random.default_rng(23)
    w = rng.uniform(0.5, 6.0, 60)
    w[5::11] = -2.25
    return _dirty(24, rng.integers(0, 24, 60), rng.integers(0, 24, 60), w)


def _ids_past_n():
    rng = np.random.default_rng(24)
    src = rng.integers(0, 24, 60)
    dst = rng.integers(0, 24, 60)
    src[4] = 24
    dst[9] = 1_000_000
    src[17] = -3
    return _dirty(24, src, dst, rng.uniform(0.5, 6.0, 60))


def _sacrificial_collision():
    n = 21
    rng = np.random.default_rng(25)
    src = rng.integers(0, n, 60)
    dst = rng.integers(0, n, 60)
    dst[[2, 30]] = faultline.sacrificial_row(n)
    return _dirty(n, src, dst, rng.uniform(0.5, 6.0, 60))


def _dup_self_loop_flood():
    edges = [(3, 3, 9.0)] * 10 + [(1, 4, 5.0)] * 8 + [(4, 1, 5.0)] * 5
    src, dst, w = (np.asarray(x) for x in zip(*edges))
    return _dirty(8, src, dst, w, pad=3)


def _everything_at_once():
    rng = np.random.default_rng(26)
    src = rng.integers(0, 24, 80)
    dst = rng.integers(0, 24, 80)
    w = rng.uniform(0.5, 6.0, 80)
    src[0] = -1
    dst[1] = 99
    w[2] = np.nan
    w[3] = np.inf
    w[4] = -0.5
    src[5] = dst[5] = 7
    return _dirty(24, src, dst, w, pad=5)


def _empty():
    return _dirty(8, [], [], [])


def _int_max_ids():
    rng = np.random.default_rng(27)
    src = rng.integers(0, 24, 40)
    dst = rng.integers(0, 24, 40)
    src[[1, 2]] = np.iinfo(np.int32).max
    dst[3] = np.iinfo(np.int32).min
    return _dirty(24, src, dst, rng.uniform(0.5, 6.0, 40), pad=2)


DIRTY_ZOO = {
    "nan_weights": _nan_weights,
    "inf_weights": _inf_weights,
    "negative_weights": _negative_weights,
    "ids_past_n": _ids_past_n,
    "sacrificial_collision": _sacrificial_collision,
    "dup_self_loop_flood": _dup_self_loop_flood,
    "everything_at_once": _everything_at_once,
    "empty": _empty,
    "int_max_ids": _int_max_ids,
}
CLEAN_DIRT = {"dup_self_loop_flood", "empty"}


def _arrays(js):
    return tuple(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid))


def _port(js, device="cpu"):
    return stream_from_arrays(*_arrays(js), device=device)


@functools.lru_cache(maxsize=None)
def _zoo(graph):
    n, js, L = DIRTY_ZOO[graph]()
    return n, js, _port(js), L


def _problem_tuples(problems):
    return [(p.kind, p.count, tuple(p.indices), p.detail, str(p)) for p in problems]


def _report_fields(r):
    return (r.policy, r.n, r.num_edges, r.num_valid_in, r.num_dropped,
            _problem_tuples(r.problems), r.ok, r.degenerate, r.counters())


def _assert_same_stream(stream, js):
    for got, want in zip((stream.src, stream.dst, stream.weight, stream.valid), _arrays(js)):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype


@pytest.mark.parametrize("graph", sorted(DIRTY_ZOO))
def test_stream_problems_match_reference(graph):
    n, js, stream, _ = _zoo(graph)
    want = _problem_tuples(jguard.stream_problems(*_arrays(js), n))
    assert _problem_tuples(stream_problems(stream.src, stream.dst, stream.weight,
                                           stream.valid, n)) == want
    # host arrays in, the same problems out
    assert _problem_tuples(stream_problems(*_arrays(js), n)) == want
    assert bool(want) == (graph not in CLEAN_DIRT)


@pytest.mark.parametrize("graph", sorted(DIRTY_ZOO))
def test_strict_matches_reference(graph):
    n, js, stream, _ = _zoo(graph)
    try:
        jguard.validate_stream(js, n, policy="strict")
    except jguard.StreamValidationError as err:
        with pytest.raises(StreamValidationError) as exc:
            validate_stream(stream, n, policy="strict")
        assert _problem_tuples(exc.value.problems) == _problem_tuples(err.problems)
        assert str(exc.value) == str(err)
        return
    out, report = validate_stream(stream, n, policy="strict")
    assert out is stream
    _, jreport = jguard.validate_stream(js, n, policy="strict")
    assert _report_fields(report) == _report_fields(jreport)


@pytest.mark.parametrize("graph", sorted(DIRTY_ZOO))
def test_sanitize_matches_reference(graph):
    n, js, stream, _ = _zoo(graph)
    jclean, jreport = jguard.validate_stream(js, n, policy="sanitize")
    clean, report = validate_stream(stream, n, policy="sanitize")
    assert _report_fields(report) == _report_fields(jreport)
    _assert_same_stream(clean, jclean)
    assert clean.device == stream.device


@pytest.mark.parametrize("policy", ["strict", "sanitize"])
@pytest.mark.parametrize("graph", ["everything_at_once", "nan_weights", "ids_past_n"])
def test_validation_telemetry_matches_reference(graph, policy):
    n, js, stream, _ = _zoo(graph)
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    outcomes = []
    for fn, s, t, err in ((validate_stream, stream, tel, StreamValidationError),
                          (jguard.validate_stream, js, jtel, jguard.StreamValidationError)):
        try:
            fn(s, n, policy=policy, telemetry=t)
            outcomes.append("passed")
        except err:
            outcomes.append("raised")
    assert outcomes[0] == outcomes[1]
    assert tel.counters.asdict() == jtel.counters.asdict()
    assert tel.events == jtel.events
    assert [e["name"] for e in tel.tracer.events] == [e["name"] for e in jtel.tracer.events]


def test_off_policy_is_identity():
    n, js, stream, _ = _zoo("everything_at_once")
    out, report = validate_stream(stream, n, policy="off")
    _, jreport = jguard.validate_stream(js, n, policy="off")
    assert out is stream
    assert _report_fields(report) == _report_fields(jreport)
    with pytest.raises(ValueError, match="policy"):
        validate_stream(stream, n, policy="lenient")


@pytest.mark.parametrize("n", [0, -1])
def test_empty_vertex_space_matches_reference(n):
    js = jcore.EdgeStream.from_numpy(np.array([0, 1]), np.array([1, 2]), np.array([2.0, 3.0]))
    stream = _port(js)
    want = _problem_tuples(jguard.stream_problems(*_arrays(js), n))
    assert _problem_tuples(stream_problems(stream.src, stream.dst, stream.weight,
                                           stream.valid, n)) == want
    assert want[0][0] == "empty_vertex_space"
    jclean, jreport = jguard.validate_stream(js, n, policy="sanitize")
    clean, report = validate_stream(stream, n, policy="sanitize")
    assert _report_fields(report) == _report_fields(jreport)
    _assert_same_stream(clean, jclean)


def _fault_stream(seed=0, n=32, m=120):
    rng = np.random.default_rng(seed)
    js = jcore.EdgeStream.from_numpy(
        rng.integers(0, n, m), rng.integers(0, n, m), rng.uniform(0.5, 4.0, m)
    )
    return n, js


INPUT_FAULTS = {
    "id_past_n": lambda fl, s, n: fl.poison_ids(s, n, (3, 7), "past_n"),
    "id_sacrificial": lambda fl, s, n: fl.poison_ids(s, n, (0, 11), "sacrificial"),
    "id_negative": lambda fl, s, n: fl.poison_ids(s, n, (5,), "negative"),
    "id_int_max": lambda fl, s, n: fl.poison_ids(s, n, (2, 9), "int_max"),
    "weight_nan": lambda fl, s, n: fl.poison_weights(s, (4, 8), "nan"),
    "weight_posinf": lambda fl, s, n: fl.poison_weights(s, (1,), "posinf"),
    "weight_neginf": lambda fl, s, n: fl.poison_weights(s, (6, 13), "neginf"),
    "weight_negative": lambda fl, s, n: fl.poison_weights(s, (10,), "negative"),
}


@pytest.mark.parametrize("fault", sorted(INPUT_FAULTS))
def test_input_faults_match_reference(fault):
    """The port's injector plants the reference's fault; strict raises the
    same error and sanitize drops the same edges, into the same stream."""
    n, js = _fault_stream()
    jdirty, jinfo = INPUT_FAULTS[fault](jfaultline, js, n)
    dirty, info = INPUT_FAULTS[fault](faultline, _port(js), n)
    assert info == faultline.InjectedFault(jinfo.kind, jinfo.positions, jinfo.description)
    _assert_same_stream(dirty, jdirty)
    with pytest.raises(jguard.StreamValidationError) as jexc:
        jguard.validate_stream(jdirty, n, policy="strict")
    with pytest.raises(StreamValidationError) as exc:
        validate_stream(dirty, n, policy="strict")
    assert str(exc.value) == str(jexc.value)
    assert info.kind in {p.kind for p in exc.value.problems}
    jclean, jreport = jguard.validate_stream(jdirty, n, policy="sanitize")
    clean, report = validate_stream(dirty, n, policy="sanitize")
    assert report.num_dropped == len(info.positions)
    assert _report_fields(report) == _report_fields(jreport)
    _assert_same_stream(clean, jclean)


def _reference_scan(js, n, L):
    jcfg = jcore.SubstreamConfig(n=n, L=L)
    out = jcore.mwm_scan(js, jcfg)
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    return np.asarray(out.assigned), np.asarray(out.mb), config_from_reference(n, L, 0.1, thr)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
@pytest.mark.parametrize("graph", sorted(set(DIRTY_ZOO) - {"empty"}))
def test_sanitized_engines_match_reference_scan(graph, schedule, packed):
    """``substream_match(validate="sanitize")`` on the dirty stream gives the
    reference's ``mwm_scan`` on its own sanitized stream, bit for bit."""
    n, js, stream, L = _zoo(graph)
    jclean, _ = jguard.validate_stream(js, n, policy="sanitize")
    want_a, want_mb, cfg = _reference_scan(jclean, n, L)
    got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                          validate="sanitize")
    np.testing.assert_array_equal(got.assigned.numpy(), want_a)
    np.testing.assert_array_equal(got.mb.numpy(), want_mb)
    check_matching(got, validate_stream(stream, n, policy="sanitize")[0], cfg)


@pytest.mark.parametrize("schedule", ["edges", "waves", "mega"])
def test_strict_is_threaded_through_substream_match(schedule):
    n, js, stream, L = _zoo("nan_weights")
    cfg = SubstreamConfig(n=n, L=L)
    with pytest.raises(StreamValidationError, match="nonfinite_weight"):
        substream_match(stream, cfg, schedule=schedule, device="cpu", validate="strict")
    with pytest.raises(ValueError, match="policy"):
        substream_match(stream, cfg, schedule=schedule, device="cpu", validate="loose")


def test_check_matching_telemetry_matches_reference():
    n, js = _fault_stream(seed=5)
    jcfg = jcore.SubstreamConfig(n=n, L=12)
    jres = jcore.mwm_scan(js, jcfg)
    stream = _port(js)
    cfg = config_from_reference(n, 12, 0.1, np.asarray(jax.jit(jcfg.thresholds)()))
    res = mwm_scan(stream, cfg, device="cpu")
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    check_matching(res, stream, cfg, telemetry=tel)
    jguard.check_matching(jres, js, jcfg, telemetry=jtel)
    pos = int(np.nonzero(res.assigned.numpy() >= 0)[0][0])
    bad = faultline.corrupt_assigned(res, pos, cfg.L + 3)
    jbad = jfaultline.corrupt_assigned(jres, pos, cfg.L + 3)
    with pytest.raises(MatchingInvariantError) as exc:
        check_matching(bad, stream, cfg, telemetry=tel)
    with pytest.raises(jguard.MatchingInvariantError) as jexc:
        jguard.check_matching(jbad, js, jcfg, telemetry=jtel)
    assert exc.value.problems == jexc.value.problems
    assert tel.counters.asdict() == jtel.counters.asdict()
    assert tel.events == jtel.events


@pytest.mark.parametrize("mode", ["flip_packed", "flip_dense", "corrupt"])
def test_result_corruptors_match_reference(mode):
    n, js = _fault_stream(seed=6)
    jcfg = jcore.SubstreamConfig(n=n, L=12)
    jres = jcore.mwm_scan(js, jcfg)
    res = mwm_scan(_port(js), config_from_reference(n, 12, 0.1, np.asarray(jax.jit(jcfg.thresholds)())),
                   device="cpu")
    p = int(np.nonzero(res.assigned.numpy() >= 0)[0][0])
    u, sub = int(np.asarray(js.src)[p]), int(res.assigned[p])
    if mode == "flip_packed":
        got = faultline.flip_matching_bit(faultline.repacked(res), u, sub)
        want = jfaultline.flip_matching_bit(jfaultline.repacked(jres), u, sub)
        np.testing.assert_array_equal(got.mb_packed.numpy(), np.asarray(want.mb_packed))
    elif mode == "flip_dense":
        got = faultline.flip_matching_bit(res, u, sub)
        want = jfaultline.flip_matching_bit(jres, u, sub)
    else:
        got = faultline.corrupt_assigned(res, p, -5)
        want = jfaultline.corrupt_assigned(jres, p, -5)
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
    assert got.assigned.dtype == torch.int32


def test_sanitize_keeps_the_stream_on_its_device():
    """Sanitize builds the clean stream where the dirty one lies, never
    clamping: the dropped slots hold the padding encoding (0, 0, 0.0)."""
    n, js, stream, _ = _zoo("everything_at_once")
    clean, report = validate_stream(stream, n, policy="sanitize")
    assert isinstance(clean, EdgeStream) and clean.src.dtype == torch.int32
    dropped = ~clean.valid & stream.valid
    assert int(dropped.sum()) == report.num_dropped == 5
    assert clean.src[dropped].tolist() == [0] * 5 and clean.weight[dropped].tolist() == [0.0] * 5
    keep = clean.valid
    assert torch.equal(clean.src[keep], stream.src[keep])
