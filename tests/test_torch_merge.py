"""Port parity of Part 2: ``merge_device`` (the one-substream Part 1 over the
recorded edges in merge order, through the packed per-edge kernel's plain
version on the CPU) held exactly to the JAX package's ``merge_device``
(which runs ``mwm_scan`` over all m edges) and to ``merge_host`` of both
packages; and the telemetry of ``merge_host`` and ``mwm_waves`` held to the
reference's ``merge.*`` counters and ``waves_xla`` record. Same inputs,
made from seeds with numpy; no tolerance."""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import obs as jobs
from repro.core import merge as jmerge
from repro.core.matching import mwm_waves as jmwm_waves
from repro_torch import obs
from repro_torch.convert import config_from_reference, stream_from_arrays
from repro_torch.core import MatchingResult, merge_host, mwm_waves
from repro_torch.core.merge import merge_order
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import device_plan, merge_device, substream_match
from repro_torch.testing.cases import WINDOW, ZOO, rmat_case

CASES = {f"zoo_{k}": v for k, v in ZOO.items()}
CASES.update({
    "rmat8_L1": lambda: rmat_case(8, edge_factor=4, L=1, pad=3, seed=1),
    "rmat9_L8": lambda: rmat_case(9, edge_factor=4, L=8, pad=4, seed=2),
    "rmat9_L13": lambda: rmat_case(9, edge_factor=4, L=13, seed=3),
    "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64, pad=7, seed=4),
    "rmat8_L300": lambda: rmat_case(8, edge_factor=8, L=300, eps=0.01, seed=5),
})


@functools.lru_cache(maxsize=None)
def _case(name):
    """The case in both packages, and the reference's Part 1 on it."""
    c = CASES[name]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=c.L, eps=c.eps)
    jres = jcore.mwm_scan(js, jcfg)
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    stream = stream_from_arrays(*arrays, device="cpu")
    cfg = config_from_reference(c.n, c.L, c.eps, np.asarray(jax.jit(jcfg.thresholds)()))
    result = MatchingResult(torch.from_numpy(np.asarray(jres.assigned).copy()),
                            mb=torch.from_numpy(np.asarray(jres.mb).copy()))
    return js, jcfg, jres, stream, cfg, result


@pytest.mark.parametrize("name", sorted(CASES))
def test_merge_device_matches_reference(name):
    js, jcfg, jres, stream, cfg, result = _case(name)
    want_mask = np.asarray(jmerge.merge_device(js, jres, jcfg))
    want_idx = jmerge.merge_host(js, jres, jcfg)
    mask = merge_device(stream, result, cfg, device="cpu")
    assert mask.dtype == torch.bool and mask.shape == (stream.num_edges,)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(torch.nonzero(mask).flatten().numpy(), want_idx)
    np.testing.assert_array_equal(merge_host(stream, result, cfg), want_idx)


@pytest.mark.parametrize("name", ["rmat9_L13", "rmat10_L64", "zoo_duplicates"])
def test_merge_device_reads_only_assigned(name):
    """Packed results merge the same, and the bits are never read."""
    _, _, _, stream, cfg, result = _case(name)
    want = merge_device(stream, result, cfg, device="cpu")
    packed = MatchingResult(result.assigned, mb_packed=result.packed(), L=cfg.L)
    no_bits = MatchingResult(result.assigned, mb=torch.zeros((0, 0), dtype=torch.bool))
    for other in (packed, no_bits):
        assert torch.equal(merge_device(stream, other, cfg, device="cpu"), want)


@pytest.mark.parametrize("name", ["rmat9_L13", "rmat10_L64", "zoo_star"])
def test_merge_order_is_the_host_merge_order(name):
    """Descending substream, then stream position: the order ``merge_host``
    walks (one stable argsort by ``L-1-assigned``)."""
    _, _, _, _, cfg, result = _case(name)
    assigned = result.assigned.numpy()
    recorded = np.nonzero(assigned >= 0)[0]
    want = recorded[np.argsort(cfg.L - 1 - assigned[recorded], kind="stable")]
    np.testing.assert_array_equal(merge_order(result, cfg).numpy(), want)


def test_merge_device_runs_the_per_edge_kernel_at_L1(monkeypatch):
    """The merge's Part 1 is the packed per-edge kernel's wrapper at L = 1:
    one lane, row width 8 words, the threshold 1 and +inf pads."""
    _, _, _, stream, cfg, result = _case("rmat10_L64")
    seen = []
    real = kernel.substream_match_packed

    def spy(edges, weights, thresholds, n_pad, mb_init=None):
        seen.append((edges.shape, thresholds.clone(), n_pad))
        return real(edges, weights, thresholds, n_pad, mb_init)

    monkeypatch.setattr(kernel, "substream_match_packed", spy)
    merge_device(stream, result, cfg, device="cpu")
    (shape, thr, n_pad), = seen
    recorded = int((result.assigned >= 0).sum())
    assert shape == (recorded, 2) and n_pad == -(-cfg.n // 8) * 8
    want = torch.full((8, 8), float("inf"))
    want[0, 0] = 1.0
    assert torch.equal(thr, want)
    assert build.launches[kernel.NAME] == 0  # the plain version ran on the CPU


def test_merge_device_empty_and_nothing_recorded():
    _, _, _, stream, cfg, result = _case("zoo_empty")
    assert merge_device(stream, result, cfg, device="cpu").numel() == 0
    _, _, _, stream, cfg, result = _case("rmat9_L13")
    none = result.with_assigned(torch.full_like(result.assigned, -1))
    assert not merge_device(stream, none, cfg, device="cpu").any()


@pytest.mark.parametrize("name", ["rmat9_L13", "zoo_empty", "zoo_star"])
def test_merge_telemetry_matches_reference(name):
    js, jcfg, jres, stream, cfg, result = _case(name)
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    merge_host(stream, result, cfg, telemetry=tel)
    jmerge.merge_host(js, jres, jcfg, telemetry=jtel)
    merge_device(stream, result, cfg, telemetry=tel, device="cpu")
    jmerge.merge_device(js, jres, jcfg, telemetry=jtel)
    assert tel.counters.asdict() == jtel.counters.asdict()
    events = tel.chrome_trace()["traceEvents"]

    def inside(e, f):
        return e is not f and f["ts"] <= e["ts"] and e["ts"] + e["dur"] <= f["ts"] + f["dur"]

    top = [e["name"] for e in events if not any(inside(e, f) for f in events)]
    assert top == [e["name"] for e in jtel.chrome_trace()["traceEvents"]]
    assert top == ["merge.host", "merge.device"]
    host = next(e for e in events if e["name"] == "merge.host")
    children = [e for e in events if inside(e, host)]
    assert [e["name"] for e in children] == ["merge.d2h", "merge.order", "merge.greedy"]
    recorded = tel.counters.get("merge.recorded_edges")
    assert [e["args"] for e in children] == [
        {"bytes": result.assigned.nbytes},
        {"recorded": recorded},
        {"recorded": recorded, "matched": tel.counters.get("merge.matched_edges")},
    ]


@pytest.mark.parametrize("via", ["session", "profiler"])
@pytest.mark.parametrize("name", ["rmat9_L13", "rmat10_L64", "zoo_star", "zoo_empty"])
def test_merge_device_runs_below_part1s_entry(name, via, monkeypatch):
    """The merge's one-substream run is launched below ``substream_match``:
    its spans are ``merge.device`` holding ``merge.order`` and
    ``merge.greedy`` (which holds the launch's ``merge.kernel`` where an
    edge was recorded, with the L = 1 block's size), and nothing of Part 1's entry (no ``kernel_edges.*``
    stage, no ``match_calls`` record, no backend event), whether the
    session is passed or is the profiler's; and it still equals
    ``merge_host``."""
    from repro_torch.kernels.substream_match import ops

    _, _, _, stream, cfg, result = _case(name)
    want = merge_host(stream, result, cfg)

    def refuse(*args, **kwargs):
        raise AssertionError("merge_device called substream_match")

    monkeypatch.setattr(ops, "substream_match", refuse)
    if via == "session":
        tel = obs.Telemetry()
        mask = merge_device(stream, result, cfg, telemetry=tel, device="cpu")
    else:
        monkeypatch.setattr(obs, "_PROFILER_SESSION", None)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            mask = merge_device(stream, result, cfg, device="cpu")
        tel = obs.profiler_session()
    np.testing.assert_array_equal(torch.nonzero(mask).flatten().numpy(), want)
    spans = {e["name"]: e for e in tel.tracer.events if e["ph"] == "X"}
    recorded = int((result.assigned >= 0).sum())
    kernel = ["merge.kernel"] if recorded else []
    assert sorted(spans) == ["merge.device", "merge.greedy", *kernel, "merge.order"]

    def within(inner, outer):
        return outer["ts"] <= inner["ts"] <= inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    for inner in ("merge.order", "merge.greedy"):
        assert within(spans[inner], spans["merge.device"])
    assert spans["merge.order"]["ts"] + spans["merge.order"]["dur"] <= spans["merge.greedy"]["ts"]
    if recorded:
        plan = device_plan(cfg.n, 1)
        assert within(spans["merge.kernel"], spans["merge.greedy"])
        assert spans["merge.kernel"]["args"] == {
            "recorded": recorded, "bit_block_bytes": plan.nbytes, "fits_l2": int(plan.fits_l2)}
    assert spans["merge.order"]["args"] == {"recorded": recorded}
    assert spans["merge.greedy"]["args"] == {"recorded": recorded, "matched": len(want)}
    assert tel.match_calls == [] and tel.events == []
    assert tel.counters.asdict() == {"merge.device.calls": 1, "merge.matched_edges": len(want),
                                     "merge.recorded_edges": recorded}


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("name", ["rmat9_L13", "rmat10_L64", "zoo_self_loops"])
def test_mwm_waves_record_matches_reference(name, precomputed):
    """The ``waves_xla`` record: the same engine name, stage keys and
    counters (bar the compile-cache labels), the same session counters and
    spans, and the same bits."""
    from repro.graph.waves import wave_schedule as jwave_schedule
    from repro_torch.convert import schedule_from_reference

    js, jcfg, _, stream, cfg, _ = _case(name)
    tel, jtel = obs.Telemetry(), jobs.Telemetry()
    jsch = sch = None
    if precomputed:
        jsch = jwave_schedule(np.asarray(js.src), np.asarray(js.dst), valid=np.asarray(js.valid))
        sch = schedule_from_reference(jsch.wave, jsch.order, jsch.offsets, jsch.slots,
                                      jsch.seg_offsets)
    got = mwm_waves(stream, cfg, schedule=sch, device="cpu", telemetry=tel)
    want = jmwm_waves(js, jcfg, schedule=jsch, telemetry=jtel)
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
    rec, jrec = tel.match_calls[-1], jtel.match_calls[-1]
    assert (rec.engine, rec.num_edges, rec.interpret) == (jrec.engine, jrec.num_edges, False)
    assert rec.backend == "cpu" and set(rec.stage_seconds) == set(jrec.stage_seconds)

    def plain(counters):
        return {k: v for k, v in counters.items() if "jit." not in k}

    assert plain(rec.counters) == plain(jrec.counters)
    assert plain(tel.counters.asdict()) == plain(jtel.counters.asdict())
    assert rec.counters["jit.variant_hit"] == 1  # plain torch builds nothing
    assert obs.consistency_problems(rec.stage_seconds, rec.wall_seconds) == []

    def spans(t):  # the device stage is "compile" on a cold jit call, "execute" here
        return sorted({e["name"].replace(".compile", ".execute") for e in t.tracer.events})

    assert spans(tel) == spans(jtel)


@pytest.mark.parametrize("ones", [False, True])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", sorted(WINDOW))
def test_per_edge_engine_at_L1_matches_reference(name, packed, ones):
    """Part 1 with one substream, the shape ``merge_device`` runs (with every
    weight 1 under ``ones``): the per-edge engine's plain versions equal the
    reference's ``mwm_scan`` on the WINDOW streams."""
    c = WINDOW[name](1)
    w = np.ones_like(c.w) if ones else c.w
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=1, eps=c.eps)
    want = jcore.mwm_scan(js, jcfg)
    stream = stream_from_arrays(*(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)),
                                device="cpu")
    cfg = config_from_reference(c.n, 1, c.eps, np.asarray(jax.jit(jcfg.thresholds)()))
    got = substream_match(stream, cfg, packed=packed, device="cpu")
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
