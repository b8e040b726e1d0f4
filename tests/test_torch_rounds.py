"""Port parity of the parallel-rounds engine, ``substream_matchings`` and
G-SEQ: the same numpy inputs, made from seeds, through the JAX package and
through the port on the CPU; ``assigned``, the bits, the masks and the
kept edges must be equal, no tolerance."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import obs as jobs
from repro.core.gseq import _gseq_pass as j_gseq_pass
from repro.core.gseq import gseq as j_gseq
from repro.core.rounds import mwm_rounds as j_mwm_rounds
from repro.graph import waves as jwaves
from repro_torch import obs
from repro_torch.convert import config_from_reference, schedule_from_reference, stream_from_arrays
from repro_torch.core import (
    EdgeStream,
    gseq,
    mwm_pipeline,
    mwm_rounds,
    mwm_scan,
    substream_matchings,
)
from repro_torch.core import rounds as rounds_mod
from repro_torch.core.gseq import gseq_pass
from repro_torch.graph.waves import wave_schedule
from repro_torch.testing.cases import WINDOW, ZOO, Case, rmat_case


def _on_thresholds():
    """Weights placed exactly on the reference's thresholds (and on the
    float32 values just below), with self-loops and padding."""
    rng = np.random.default_rng(17)
    n, m, L, eps = 40, 160, 16, 0.1
    thr = np.asarray(jax.jit(jcore.SubstreamConfig(n=n, L=L, eps=eps).thresholds)())
    lanes = rng.integers(0, L, m)
    w = thr[lanes]
    below = rng.random(m) < 0.3
    w[below] = np.nextafter(w[below], np.float32(0))
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    src[::17] = dst[::17]
    return Case(n, src, dst, w.astype(np.float32), L, eps, 9)


CASES = {f"zoo_{k}": v for k, v in ZOO.items()}
CASES.update({
    "on_thresholds": _on_thresholds,
    "window_hub": WINDOW["hub"],
    "rmat8_L16": lambda: rmat_case(8, edge_factor=8, L=16, pad=7, seed=1),
    "rmat9_L13": lambda: rmat_case(9, edge_factor=4, L=13, pad=4, seed=2),
    "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64, pad=3, seed=3),
})
SMALL = ["zoo_self_loops", "zoo_dense_small", "on_thresholds", "rmat9_L13"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case in both packages: the reference's stream and config, the
    port's stream on the CPU and a config holding the reference's jitted
    thresholds."""
    c = CASES[name]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=c.L, eps=c.eps)
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    stream = stream_from_arrays(*arrays, device="cpu")
    cfg = config_from_reference(c.n, c.L, c.eps, np.asarray(jax.jit(jcfg.thresholds)()))
    return js, jcfg, stream, cfg


def _assert_same(got, want):
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mwm_rounds_matches_reference(name, packed):
    js, jcfg, stream, cfg = _case(name)
    want = j_mwm_rounds(js, jcfg, packed=packed)
    got = mwm_rounds(stream, cfg, packed=packed, device="cpu")
    assert got.is_packed == packed and got.assigned.dtype == torch.int32
    if packed:
        np.testing.assert_array_equal(got.mb_packed.numpy(), np.asarray(want.mb_packed))
    _assert_same(got, want)
    _assert_same(got, mwm_scan(stream, cfg, device="cpu"))


@pytest.mark.parametrize("max_rounds", [1, 3])
@pytest.mark.parametrize("name", SMALL + ["rmat10_L64"])
def test_mwm_rounds_cap_matches_reference(name, max_rounds):
    """At the cap both return the same partial result."""
    js, jcfg, stream, cfg = _case(name)
    want = j_mwm_rounds(js, jcfg, max_rounds=max_rounds)
    got = mwm_rounds(stream, cfg, max_rounds=max_rounds, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["rmat9_L13", "rmat10_L64", "zoo_dense_small"])
def test_rounds_in_chunks_equal_one_pass(monkeypatch, name):
    """Walking the edges in chunks (the paper config's memory bound) changes
    nothing: the vertex minimum is order-free."""
    _, _, stream, cfg = _case(name)
    whole = mwm_rounds(stream, cfg, device="cpu")
    monkeypatch.setattr(rounds_mod, "CHUNK_ELEMENTS", 7 * cfg.L)
    assert len(rounds_mod._chunks(stream.num_edges, cfg.L)) > 10
    chunked = mwm_rounds(stream, cfg, device="cpu")
    assert torch.equal(chunked.assigned, whole.assigned) and torch.equal(chunked.mb, whole.mb)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", SMALL)
def test_mwm_rounds_waves_matches_reference(name, packed):
    """``waves=`` delegates to the plain wave engine, on one schedule."""
    js, jcfg, stream, cfg = _case(name)
    jsch = jwaves.wave_schedule(np.asarray(js.src), np.asarray(js.dst), valid=np.asarray(js.valid))
    sch = schedule_from_reference(*(getattr(jsch, f) for f in
                                    ("wave", "order", "offsets", "slots", "seg_offsets")))
    want = j_mwm_rounds(js, jcfg, packed=packed, waves=jsch)
    got = mwm_rounds(stream, cfg, packed=packed, waves=sch, device="cpu")
    assert got.is_packed == packed
    _assert_same(got, want)
    with pytest.raises(ValueError, match="max_rounds"):
        mwm_rounds(stream, cfg, max_rounds=2, waves=sch, device="cpu")


def test_mwm_rounds_invalid_edges_with_wild_ids():
    """Padding may hold any ids: the reference drops or clamps them, the
    port enters them as vertex 0; neither touches a bit."""
    src = np.array([0, -7, 1, 99, 2], np.int32)
    dst = np.array([1, 99, 2, -3, 3], np.int32)
    w = np.array([2.0, 5.0, 3.0, 9.0, 4.0], np.float32)
    valid = np.array([True, False, True, False, True])
    js = jcore.EdgeStream(*(jnp.asarray(a) for a in (src, dst, w, valid)))
    jcfg = jcore.SubstreamConfig(n=4, L=8)
    cfg = config_from_reference(4, 8, 0.1, np.asarray(jax.jit(jcfg.thresholds)()))
    got = mwm_rounds(stream_from_arrays(src, dst, w, valid, device="cpu"), cfg, device="cpu")
    _assert_same(got, j_mwm_rounds(js, jcfg))
    assert got.assigned.tolist()[1] == -1 and got.assigned.tolist()[3] == -1


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_rounds_matches_reference(name):
    js, jcfg, stream, cfg = _case(name)
    want_idx, want_w = jcore.mwm_pipeline(js, jcfg, part1="rounds")
    idx, weight = mwm_pipeline(stream, cfg, part1="rounds", device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_w
    scan_idx, _ = mwm_pipeline(stream, cfg, part1="scan", device="cpu")
    np.testing.assert_array_equal(idx, scan_idx)


@pytest.mark.parametrize("name", sorted(CASES))
def test_substream_matchings_matches_reference(name):
    js, jcfg, stream, cfg = _case(name)
    want = np.asarray(jcore.substream_matchings(js, jcfg))
    got = substream_matchings(stream, cfg, device="cpu")
    assert got.dtype == torch.bool and got.shape == (stream.num_edges, cfg.L)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eps", [0.1, 0.37])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gseq_matches_reference(name, eps):
    js, jcfg, stream, _ = _case(name)
    np.testing.assert_array_equal(
        gseq_pass(stream, jcfg.n, eps).numpy(), np.asarray(j_gseq_pass(js, jcfg.n, eps)))
    np.testing.assert_array_equal(gseq(stream, jcfg.n, eps, device="cpu"), j_gseq(js, jcfg.n, eps))


def _on_the_bound(eps, seed, n=24, m=300):
    """A stream whose weights sit exactly on ``(1+eps)(phi[u]+phi[v])``
    (float32, the reference's order of operations), one float32 step below
    or above it, so the pass's comparison decides on the last bit."""
    rng = np.random.default_rng(seed)
    factor = np.float32(1.0 + eps)
    phi = np.zeros(n, np.float32)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = np.zeros(m, np.float32)
    for i, (u, v) in enumerate(zip(src, dst)):
        bound = np.float32(factor * np.float32(phi[u] + phi[v]))
        if bound == 0:
            bound = np.float32(rng.uniform(1, 4))
        w[i] = (bound, np.nextafter(bound, np.float32(0)), np.nextafter(bound, np.float32(np.inf)),
                bound)[rng.integers(0, 4)]
        if u != v and w[i] >= bound:
            g = np.float32(np.float32(w[i] - phi[u]) - phi[v])
            phi[u] += g
            phi[v] += g
    return src, dst, w


@pytest.mark.parametrize("eps", [0.1, 0.01, 0.5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gseq_exact_on_the_bound(seed, eps):
    src, dst, w = _on_the_bound(eps, seed)
    js = jcore.EdgeStream.from_numpy(src, dst, w)
    stream = EdgeStream.from_numpy(src, dst, w, device="cpu")
    kept = gseq_pass(stream, 24, eps).numpy()
    np.testing.assert_array_equal(kept, np.asarray(j_gseq_pass(js, 24, eps)))
    assert 0 < kept.sum() < kept.size
    np.testing.assert_array_equal(gseq(stream, 24, eps, device="cpu"), j_gseq(js, 24, eps))


def test_rounds_telemetry_record():
    """One ``rounds`` record whose device stage is the whole loop, with the
    reference's counters and the rounds run; the wave path records
    ``waves_xla``."""
    js, jcfg, stream, cfg = _case("rmat9_L13")
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    mwm_rounds(stream, cfg, telemetry=tel, device="cpu")
    j_mwm_rounds(js, jcfg, telemetry=jtel)
    rec, jrec = tel.match_calls[-1], jtel.match_calls[-1]
    assert rec.engine == jrec.engine == "rounds"
    assert rec.backend == "cpu" and rec.num_edges == stream.num_edges
    for key in ("stream.num_edges", "rounds.max_rounds"):
        assert rec.counters[key] == jrec.counters[key]
    assert rec.counters["rounds.converged"] is True and rec.counters["rounds.rounds"] > 1
    assert obs.consistency_problems(rec.stage_seconds, rec.wall_seconds) == []
    assert rec.stage_seconds["execute"] > 0
    capped = obs.Telemetry()
    mwm_rounds(stream, cfg, max_rounds=1, telemetry=capped, device="cpu")
    assert capped.match_calls[-1].counters["rounds.rounds"] == 1
    assert capped.match_calls[-1].counters["rounds.converged"] is False
    sch = wave_schedule(stream.src.numpy(), stream.dst.numpy(), valid=stream.valid.numpy())
    mwm_rounds(stream, cfg, waves=sch, telemetry=tel, device="cpu")
    assert tel.match_calls[-1].engine == "waves_xla"
