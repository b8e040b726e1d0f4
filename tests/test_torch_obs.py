"""Port parity of the telemetry (``repro_torch.obs``) with the JAX package's
``repro.obs``, and its records on the port's three entries.

* tracer and schema: spans nest by interval containment, the export is
  Chrome trace-event JSON, and the same calls give the same events and
  counters as the reference's tracer;
* the disabled path hands out the same shared no-op objects and retains
  nothing;
* the records of ``substream_match`` (both layouts, three schedules, on
  the CPU through the plain versions): disjoint stages inside the wall
  time, the reference's record keys, plan and schedule counters equal to a
  recomputed plan, and the same results with telemetry on and off.
"""
import json
import time
import tracemalloc

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.graph import waves as jwaves
from repro_torch import obs
from repro_torch.core import EdgeStream, SubstreamConfig
from repro_torch.graph.waves import block_aligned_layout, schedule_counters, wave_schedule
from repro_torch.kernels import build
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    MEGA_SEG_BLOCK,
    device_plan,
    mega_plan,
    plan_counters,
    substream_match,
    wave_plan,
)


def _workload(m=600, n=128, L=8, eps=0.1, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = (rng.random(m) * 10 + 1).astype(np.float32)
    return EdgeStream.from_numpy(src, dst, w, device="cpu"), SubstreamConfig(n=n, L=L, eps=eps)


def _host(stream):
    return stream.src.numpy(), stream.dst.numpy(), stream.valid.numpy()


# ---------------------------------------------------------------- tracer


def test_spans_nest_by_interval_containment():
    tel = obs.Telemetry()
    with tel.span("outer"):
        with tel.span("inner"):
            time.sleep(0.001)
    evs = tel.chrome_trace()["traceEvents"]
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["dur"] >= 1000  # slept 1 ms; ts/dur are microseconds


def _session(o):
    tel = o.Telemetry()
    with tel.span("a", detail=1):
        with tel.span("b"):
            pass
    tel.event("mark", backend="cpu")
    tel.count("some.counter", 3)
    tel.count("some.counter")
    tel.counters.put("gauge", 0.5)
    return tel


def test_chrome_trace_matches_reference():
    """The same calls give the reference's trace: events (bar timestamps),
    counters and metadata, and valid Chrome trace-event JSON."""
    trace = json.loads(json.dumps(_session(obs).chrome_trace()))
    jtrace = json.loads(json.dumps(_session(jobs).chrome_trace()))

    def shape(t):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in t["traceEvents"]]

    assert shape(trace) == shape(jtrace)
    assert trace["otherData"] == jtrace["otherData"] == {"counters": {"gauge": 0.5, "some.counter": 4}}
    assert trace["displayTimeUnit"] == "ms"
    for e in trace["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(e)
        assert e["dur"] >= 0 if e["ph"] == "X" else e["s"] == "t"
    assert _session(obs).events == _session(jobs).events


def test_write_chrome_trace_roundtrip(tmp_path):
    tel = obs.Telemetry()
    with tel.span("s"):
        pass
    path = tmp_path / "trace.json"
    tel.write_chrome_trace(path)
    assert [e["name"] for e in json.loads(path.read_text())["traceEvents"]] == ["s"]


def test_stopwatch_measures_even_when_disabled():
    with obs.stopwatch(obs.DISABLED, "x") as sw:
        time.sleep(0.001)
    assert sw.seconds >= 0.001
    tel = obs.Telemetry()
    with obs.stopwatch(tel, "x") as sw2:
        pass
    ev = tel.chrome_trace()["traceEvents"][0]
    assert ev["name"] == "x"
    assert ev["dur"] == pytest.approx(sw2.seconds * 1e6, rel=1e-9)


def test_counters_and_ledger_match_reference():
    c, jc = obs.Counters(), jobs.Counters()
    for reg in (c, jc):
        reg.add("a")
        reg.add("a", 2)
        reg.put("g", 1.5)
        reg.update({"x": 1, "y": 2}, prefix="p.")
    assert c.asdict() == jc.asdict() and len(c) == len(jc) == 4
    assert c.get("missing", 7) == 7 and obs.NULL_COUNTERS.get("a", 3) == 3
    key = ("test_torch_obs", time.perf_counter())
    assert obs.variant_seen(key) is False and obs.variant_seen(key) is True


# ------------------------------------------------------- disabled path


def test_disabled_path_is_identity_objects(tmp_path):
    assert obs.DISABLED.span("a") is obs.NULL_SPAN
    assert obs.DISABLED.span("b", k=1) is obs.NULL_SPAN
    assert obs.DISABLED.counters is obs.NULL_COUNTERS
    assert obs.recorder(obs.DISABLED, "e", 10) is obs.NULL_RECORDER
    assert obs.recorder(None, "e", 10) is obs.NULL_RECORDER
    assert obs.NULL_RECORDER.device_stage(kernel.EDGES_LIBRARY) is obs.NULL_SPAN
    assert obs.DISABLED.match_calls == () and obs.DISABLED.events == ()
    assert obs.DISABLED.chrome_trace() == jobs.DISABLED.chrome_trace()
    with pytest.raises(RuntimeError):
        obs.DISABLED.write_chrome_trace(tmp_path / "nope.json")


def test_disabled_hot_loop_does_not_accumulate_allocations():
    """The no-op path may allocate transient frames but retains nothing."""
    tel = obs.DISABLED
    rec = obs.recorder(tel, "hot", 1)
    with tel.span("hot"):
        pass
    tracemalloc.start()
    for _ in range(5000):
        with tel.span("hot"):
            pass
        tel.count("hot.counter")
        tel.event("hot.event", x=1)
        with rec.stage("layout"):
            pass
        with rec.device_stage(kernel.WAVES_LIBRARY):
            pass
        rec.put("gauge", 1)
    current, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert current < 16_384, f"disabled path retained {current} bytes"


# -------------------------------------------------- record consistency


def test_consistency_problems_match_reference():
    good = {"schedule": 0.1, "pack": 0.0, "layout": 0.1, "compile": 0.0, "execute": 0.2}
    cases = [(good, 0.5), ({"schedule": 0.1}, 0.5), ({**good, "execute": -1.0}, 0.5),
             (good, 0.1), ({}, 0.0)]
    for stages, wall in cases:
        assert obs.consistency_problems(stages, wall) == jobs.consistency_problems(stages, wall)
    assert obs.consistency_problems(good, 0.5) == []
    assert obs.STAGES == jobs.STAGES and obs.PLAN_COUNTERS == jobs.report.PLAN_COUNTERS


ENGINES = {"edges": "kernel_edges", "waves": "kernel_waves", "mega": "kernel_mega"}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("schedule", sorted(ENGINES))
def test_record_stages_and_keys(schedule, packed):
    stream, cfg = _workload(m=500, n=96, L=8, eps=0.12, seed=len(schedule))
    tel = obs.Telemetry()
    got = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu",
                          telemetry=tel)
    rec, = tel.match_calls
    assert (rec.engine, rec.backend, rec.interpret) == (ENGINES[schedule], "cpu", True)
    assert rec.num_edges == stream.num_edges
    assert obs.consistency_problems(rec.stage_seconds, rec.wall_seconds) == []
    assert set(rec.stage_seconds) == set(obs.STAGES)
    assert rec.stage_seconds["compile"] == 0 and rec.stage_seconds["execute"] > 0
    assert rec.counters["jit.variant_hit"] == 1  # the plain versions build nothing
    if schedule == "edges":
        assert rec.stage_seconds["schedule"] == rec.stage_seconds["pack"] == 0
    d = rec.asdict()
    json.dumps(d)
    assert list(d) == ["engine", "backend", "interpret", "num_edges", "wall_seconds",
                       "edges_per_sec", "stage_seconds", "counters"]
    assert list(d["stage_seconds"]) == list(obs.STAGES) and d["edges_per_sec"] > 0
    plain = substream_match(stream, cfg, schedule=schedule, packed=packed, device="cpu")
    assert torch.equal(got.assigned, plain.assigned) and torch.equal(got.mb, plain.mb)
    assert tel.counters.get("substream_match.calls") == 1
    assert tel.counters.get(f"{ENGINES[schedule]}.stream.num_edges") == stream.num_edges


@pytest.mark.parametrize("packed", [True, False])
def test_edges_counters_bit_exact_against_plan(packed):
    stream, cfg = _workload(m=700, n=160, L=13)
    tel = obs.Telemetry()
    substream_match(stream, cfg, packed=packed, device="cpu", telemetry=tel)
    rec = tel.match_calls[-1]
    plan = device_plan(cfg.n, cfg.L, packed=packed)
    for k, v in plan_counters(plan).items():
        assert rec.counters[k] == v, k
    assert rec.counters["plan.bit_block_bytes"] == plan.nbytes
    assert "plan.gather_bytes" not in rec.counters


@pytest.mark.parametrize("packed", [True, False])
def test_wave_counters_bit_exact_against_plan(packed):
    stream, cfg = _workload(m=700, n=160, L=8)
    tel = obs.Telemetry()
    substream_match(stream, cfg, schedule="waves", packed=packed, device="cpu", telemetry=tel)
    rec = tel.match_calls[-1]
    src, dst, valid = _host(stream)
    sch = wave_schedule(src, dst, valid=valid)
    plan = wave_plan(cfg.n, cfg.L, sch, packed=packed)
    for k in obs.PLAN_COUNTERS:
        assert k in rec.counters
    for k, v in {**plan_counters(plan), **schedule_counters(sch)}.items():
        assert rec.counters[k] == v, k
    assert rec.counters["plan.gather_bytes"] == sch.slots.size * 20
    # the schedule counters are the reference's, array for array
    jsch = jwaves.wave_schedule(src, dst, valid=valid)
    assert schedule_counters(sch) == jwaves.schedule_counters(jsch)


@pytest.mark.parametrize("seg_block", [None, 1, 4])
def test_mega_counters_bit_exact_against_plan(seg_block):
    stream, cfg = _workload(m=700, n=160, L=8)
    tel = obs.Telemetry()
    substream_match(stream, cfg, schedule="mega", seg_block=seg_block, device="cpu",
                    telemetry=tel)
    rec = tel.match_calls[-1]
    src, dst, valid = _host(stream)
    sch = wave_schedule(src, dst, valid=valid)
    sb = MEGA_SEG_BLOCK if seg_block is None else seg_block
    layout = block_aligned_layout(sch, sb)
    plan = mega_plan(cfg.n, cfg.L, layout)
    for k, v in plan_counters(plan).items():
        assert rec.counters[k] == v, k
    assert rec.counters["layout.num_tiles"] == layout.num_tiles
    assert rec.counters["layout.padding_rows"] == layout.num_segments - sch.num_segments
    assert rec.counters["plan.seg_block"] == sb
    jlayout = jwaves.block_aligned_layout(jwaves.wave_schedule(src, dst, valid=valid), sb)
    assert {k: rec.counters[k] for k in rec.counters if k.startswith("layout.")} == \
        jwaves.layout_counters(jlayout, jwaves.wave_schedule(src, dst, valid=valid))


def test_counters_deterministic_across_runs():
    stream, cfg = _workload(m=450, n=96, L=8)

    def counters_of(schedule):
        tel = obs.Telemetry()
        substream_match(stream, cfg, schedule=schedule, device="cpu", telemetry=tel)
        return tel.match_calls[-1].counters

    for schedule in ENGINES:
        first = counters_of(schedule)
        assert first and first == counters_of(schedule)


def test_backend_event_per_call():
    stream, cfg = _workload(m=200, n=64, L=8)
    tel = obs.Telemetry()
    substream_match(stream, cfg, schedule="edges", device="cpu", telemetry=tel)
    substream_match(stream, cfg, schedule="mega", device="cpu", telemetry=tel)
    substream_match(stream, SubstreamConfig(n=0, L=8), device="cpu", telemetry=tel)
    evs = [e for e in tel.events if e["name"] == "substream_match.backend"]
    assert [e["engine"] for e in evs] == ["edges", "mega", "edges"]
    assert all(e["backend"] == "cpu" and e["interpret"] is True for e in evs)
    assert len(tel.match_calls) == 2  # n == 0 runs no engine


def test_precomputed_schedule_is_a_schedule_stage():
    stream, cfg = _workload(m=800, n=128, L=8)
    tel = obs.Telemetry()
    sch = wave_schedule(*_host(stream)[:2], valid=stream.valid.numpy(), telemetry=tel)
    evs = tel.chrome_trace()["traceEvents"]
    assign = next(e for e in evs if e["name"] == "wave_schedule.assign")
    pack = next(e for e in evs if e["name"] == "wave_schedule.pack")
    assert assign["dur"] == pytest.approx(sch.schedule_seconds * 1e6, rel=1e-9)
    assert pack["dur"] == pytest.approx(sch.pack_seconds * 1e6, rel=1e-9)
    assert tel.counters.get("schedule.num_waves") == sch.num_waves
    substream_match(stream, cfg, schedule="waves", waves=sch, device="cpu", telemetry=tel)
    rec = tel.match_calls[-1]
    assert rec.stage_seconds["pack"] == 0 and rec.stage_seconds["schedule"] > 0
    assert "wave_schedule.validate" in {e["name"] for e in tel.tracer.events}


def test_device_stage_labels_the_library_load():
    """``compile`` on the call that loads a kernel library, ``execute`` on
    every later call and on the plain versions."""
    tel = obs.Telemetry()
    rec = obs.recorder(tel, "probe", 1, "cuda")
    with rec.device_stage("a library this process never loaded"):
        pass
    assert rec.counters == {"jit.variant_miss": 1}
    with rec.device_stage(None):
        pass
    rec.finish()
    assert tel.counters.get("jit.variant_misses") == tel.counters.get("jit.variant_hits") == 1
    assert {e["name"] for e in tel.tracer.events} == {"probe.compile", "probe.execute"}
    assert kernel.EDGES_LIBRARY not in build.loaded()  # no nvcc on the CPU
