"""The readers of the program's own spans (``h2d_ms``, ``merge_d2h_ms``,
``merge_order_ms``, ``merge_greedy_ms``): on a synthetic session, on a
tiny run of the pipeline under the profiler on the CPU, and with no
session to read."""
import json
import shutil
import time

import numpy as np
import pytest
import torch

from perfbench import harness, program_spans

READERS = ("h2d_ms", "merge_d2h_ms", "merge_order_ms", "merge_greedy_ms")
SPANS = {"h2d_ms": "stream.to", "merge_d2h_ms": "merge.d2h",
         "merge_order_ms": "merge.order", "merge_greedy_ms": "merge.greedy"}


def reader(name):
    return harness.load_module(harness.ROOT / "perfbench" / "metrics" / f"{name}.py", name)


@pytest.fixture
def session(monkeypatch):
    """A new process-wide profiler session of the program, for the test alone."""
    from repro_torch import obs

    monkeypatch.setattr(obs, "_PROFILER_SESSION", None)
    return obs.profiler_session()


def _x(name, ts, dur, **args):
    ev = {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": 0, "tid": 0}
    if args:
        ev["args"] = args
    return ev


def _jobs(k):
    return {"jobs": [{"graph": 0, "t0": 0.0, "t1": 1.0, "edges": 1}] * k}


def test_readers_on_a_synthetic_session(session):
    ev = session.tracer.events
    # an earlier run's pipeline (outside this run's last two jobs)
    ev += [_x("stream.to", 1, 5, source="cpu"), _x("merge.d2h", 7, 1), _x("pipeline", 0, 10)]
    for t0 in (100, 200):
        ev += [
            _x("stream.to", t0 + 1, 4000 if t0 == 100 else 2000, source="cpu", target="cuda"),
            _x("stream.to", t0 + 5, 1000, source="cuda:0", target="cuda"),  # not from the host
            _x("merge.d2h", t0 + 10, 3000, bytes=8),
            _x("merge.order", t0 + 20, 5000, recorded=3),
            _x("merge.greedy", t0 + 30, 7000 if t0 == 100 else 9000, recorded=3, matched=2),
            _x("pipeline", t0, 50000, call=t0 // 100, m=9, part1="kernel"),
        ]
    ev.append(_x("merge.greedy", 60000, 1e6))  # in no pipeline
    ev.append({"name": "substream_match.backend", "ph": "i", "ts": 150})
    r = _jobs(2)
    assert reader("h2d_ms").read(r) == pytest.approx((4000 + 2000) / 2 * 1e-3)
    assert reader("merge_d2h_ms").read(r) == pytest.approx(3.0)
    assert reader("merge_order_ms").read(r) == pytest.approx(5.0)
    assert reader("merge_greedy_ms").read(r) == pytest.approx(8.0)
    # every pipeline of the session when the run had more jobs than it holds
    assert reader("merge_d2h_ms").read(_jobs(5)) == pytest.approx((1 + 6000) / 3 * 1e-3)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_a_session_or_a_pipeline(name, session, monkeypatch):
    from repro_torch import obs

    assert reader(name).read(_jobs(3)) is None  # an empty session
    session.tracer.events.append(_x(SPANS[name], 1, 5, source="cpu"))
    assert reader(name).read(_jobs(3)) is None  # no pipeline span
    session.tracer.events.append(_x("pipeline", 0, 10))
    assert reader(name).read(_jobs(0)) is None  # no job
    assert reader(name).read(_jobs(1)) == pytest.approx(5e-3)
    monkeypatch.delattr(obs, "profiler_session")  # a program without the session
    assert program_spans.session_events() is None
    assert reader(name).read(_jobs(1)) is None


def test_readers_on_a_tiny_pipeline_under_the_profiler(session):
    from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline

    rng = np.random.default_rng(7)
    n, m = 64, 600
    stream = EdgeStream.from_numpy(rng.integers(0, n, m).astype(np.int32),
                                   rng.integers(0, n, m).astype(np.int32),
                                   (rng.random(m) * 10 + 1).astype(np.float32), device="cpu")
    cfg = SubstreamConfig(n=n, L=8, eps=0.1)
    mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu")  # not profiled: not read
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for device in ("cpu:0", "cpu:0", "cpu"):
            mwm_pipeline(stream, cfg, part1="kernel", K=8, device=device)
    events = program_spans.session_events()
    pipes = [e for e in events if e["name"] == "pipeline"]
    assert len(pipes) == 3
    r = _jobs(3)
    values = {name: reader(name).read(r) for name in READERS}
    assert all(v is not None and v >= 0 for v in values.values())
    # the host-to-device copies are mwm_blocked's, one a job on cpu:0 (the
    # second span of those jobs copies from cpu to cpu:0 as well)
    hosted = [e for e in events if e["name"] == "stream.to" and e["args"]["source"] == "cpu"]
    assert len(hosted) == 4
    assert values["h2d_ms"] == pytest.approx(sum(e["dur"] for e in hosted) / 3 * 1e-3)
    merge = sum(values[k] for k in ("merge_d2h_ms", "merge_order_ms", "merge_greedy_ms"))
    host = sum(e["dur"] for e in events if e["name"] == "merge.host") / 3 * 1e-3
    assert merge <= host
    assert values["merge_greedy_ms"] > 0


def test_a_traced_run_reports_the_readers_within_their_layers(tmp_path):
    """A whole traced run on the CPU at a tiny size: the four readers are
    reported, ``h2d_ms`` within ``blocking_ms`` and the merge's three parts
    within ``part2_ms``."""
    root = tmp_path
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((harness.ROOT / "perfbench/configs/kron48-L64.json").read_text())
    cfg.update(name="kron8-L16", edge_factor=8, L=16, K=4)
    (root / "perfbench/configs/kron8-L16.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(
        {"scale": 7, "pool": 2, "loop": "closed", "clients": 1, "check_graphs": 2}))
    spec["configs"].append({"name": "kron8-L16", "source": "https://arxiv.org/abs/2010.14684",
                            "file": "perfbench/configs/kron8-L16.json", "reduced": [],
                            "why": "a test size"})
    spec["workloads"].append({"name": "kron8.tiny", "config": "kron8-L16", "traffic": "tiny",
                              "chips": 1, "why": "a test size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).append("kron8.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell("kron8.tiny", root=root)
    res = harness.run(cell, 2**33 + 5, 2.0, True, "cpu", time.perf_counter())
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] is True
    assert set(READERS) <= set(got)
    assert got["h2d_ms"] == 0  # the stream is on the CPU already: nothing copied
    assert got["h2d_ms"] <= got["blocking_ms"]
    merge = got["merge_d2h_ms"] + got["merge_order_ms"] + got["merge_greedy_ms"]
    assert 0 < merge <= got["part2_ms"] * 1.02
