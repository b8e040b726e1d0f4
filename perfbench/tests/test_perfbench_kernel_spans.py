"""The readers of the program's kernel spans (``part1_ns_per_edge``,
``merge_kernel_ms``) on a synthetic session and with nothing to read, and a
traced run of a Graph500 cell at a tiny size on the CPU."""
import json
import shutil
import time

import pytest

from perfbench import harness, job_spans

READERS = ("part1_ns_per_edge", "merge_kernel_ms")


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
    block = {"bit_block_bytes": 64 << 20, "fits_l2": 0}
    # an earlier run's pipeline, outside this run's last two jobs
    ev += [_x("kernel_edges.execute", 1, 5, edges=10, **block), _x("merge.kernel", 7, 1),
           _x("pipeline", 0, 10)]
    for t0, (dur, edges) in ((100, (4000, 1000)), (200, (2000, 3000))):
        ev += [
            _x("kernel_edges.execute", t0 + 1, dur, edges=edges, **block),
            _x("merge.kernel", t0 + dur + 10, 300 if t0 == 100 else 500, recorded=5, **block),
            _x("pipeline", t0, 50000, call=t0 // 100, m=edges, part1="kernel"),
        ]
    ev.append(_x("kernel_edges.execute", 60000, 1e6, edges=1))  # in no pipeline
    ev.append(_x("merge.kernel", 60000, 1e6))
    r = _jobs(2)
    # (4000 + 2000) us over 4000 edges: 1.5 us, 1500 ns an edge
    assert reader("part1_ns_per_edge").read(r) == pytest.approx(1500.0)
    assert reader("merge_kernel_ms").read(r) == pytest.approx((300 + 500) / 2 * 1e-3)
    spans, jobs = job_spans.in_jobs(r, "merge.kernel")
    assert (len(spans), jobs) == (2, 2)


def test_a_job_with_no_merge_kernel_reads_none(session):
    ev = session.tracer.events
    # a job whose merge recorded nothing, and a program whose Part 1 span
    # has no edges argument (the spans of a program without them)
    ev += [_x("kernel_edges.execute", 1, 5), _x("merge.greedy", 7, 1), _x("pipeline", 0, 10)]
    for name in READERS:
        assert reader(name).read(_jobs(1)) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_a_session_or_a_pipeline(name, session, monkeypatch):
    from repro_torch import obs

    assert reader(name).read(_jobs(3)) is None  # an empty session
    session.tracer.events.append(_x({"part1_ns_per_edge": "kernel_edges.execute",
                                     "merge_kernel_ms": "merge.kernel"}[name], 1, 5, edges=5))
    assert reader(name).read(_jobs(3)) is None  # no pipeline span
    session.tracer.events.append(_x("pipeline", 0, 10))
    assert reader(name).read(_jobs(0)) is None  # no job
    assert reader(name).read(_jobs(1)) == pytest.approx(1000.0 if "ns" in name else 5e-3)
    monkeypatch.delattr(obs, "profiler_session")  # a program without the session
    assert reader(name).read(_jobs(1)) is None


def test_a_traced_run_of_a_tiny_graph500_cell(tmp_path):
    """The Graph500 configuration at scale 8 through the harness on the CPU:
    correct, ``part1_ns_per_edge`` reported; ``merge_kernel_ms`` finds
    nothing there (the CPU merges with ``merge_host``)."""
    root = tmp_path
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(
        {"scale": 8, "pool": 2, "loop": "closed", "clients": 1, "check_graphs": 2}))
    spec["workloads"].append({"name": "g500.tiny", "config": "graph500-L64", "traffic": "tiny",
                              "chips": 1, "why": "a test size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).append("g500.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell("g500.tiny", root=root)
    res = harness.run(cell, 2**33 + 5, 1.0, True, "cpu", time.perf_counter())
    assert res["correct"] is True
    assert res["checks"]["mismatched_edges"]["value"] == 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["part1_ns_per_edge"] > 0
    assert "merge_kernel_ms" not in got
