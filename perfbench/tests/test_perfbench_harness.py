"""Whole runs of the harness on the CPU at a tiny size: the look for a card
skipped, everything else as on the chip. A configuration, a traffic mix
and a metric added from a directory of their own; faults planted under the
timed path that ``correct`` has to catch; the command's refusals."""
import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(harness.ROOT)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with one more configuration, traffic mix,
    cell and per-layer metric, each a file of its own; no file edited."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/kron48-L64.json").read_text())
    cfg.update(name="kron8-L16", edge_factor=8, L=16, K=4)
    (root / "perfbench/configs/kron8-L16.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/tiny.json").write_text(json.dumps(
        {"scale": 7, "pool": 3, "loop": "closed", "clients": 1, "check_graphs": 2}))
    (root / "perfbench/metrics/jobs_seen.py").write_text(
        "def read(record):\n    return float(len(record['jobs']))\n")
    spec["configs"].append({"name": "kron8-L16", "source": "https://arxiv.org/abs/2010.14684",
                            "file": "perfbench/configs/kron8-L16.json", "reduced": [],
                            "why": "a test size"})
    spec["workloads"].append({"name": "kron8.tiny", "config": "kron8-L16", "traffic": "tiny",
                              "chips": 1, "why": "a test size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).append("kron8.tiny")
    spec["per_layer"].append({"name": "jobs_seen", "unit": "jobs", "better": "higher",
                              "source": "host_clock", "layer": "harness",
                              "moves": "edges_per_s", "workloads": ["kron8.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(root, traced=False, seed=2**31 + 3):
    cell = harness.Cell("kron8.tiny", root=root)
    return harness.run(cell, seed, 1.0, traced, "cpu", time.perf_counter())


def test_added_files_are_found_by_name(tiny_root):
    res = _run(tiny_root)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 3
    assert set(res["metrics"]) == {"edges_per_s", "job_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"]["mismatched_edges"] == {"value": 0, "limit": 0}
    traced = _run(tiny_root, traced=True)
    assert traced["correct"] is True
    assert traced["metrics"]["jobs_seen"]["value"] == traced["attempted"]
    assert {"blocking_ms", "part2_ms"} <= set(traced["metrics"])
    assert traced["device"]["window_s"] > 0


def test_cell_metrics_follow_their_workloads_lists():
    cell = harness.Cell("kron48.s20")
    assert [m["name"] for m in cell.metrics["end_to_end"]] == [
        "edges_per_s", "device_peak_gib", "setup_s"]
    assert "job_p95_ms" in [m["name"] for m in harness.Cell("kron48.s16-jobs").metrics["end_to_end"]]
    assert len(cell.metrics["per_layer"]) == 5


def _assigned_unchanged(orig):
    """Part 1 returns its state as it came in: nothing recorded."""
    def fault(stream, cfg, **kw):
        res = orig(stream, cfg, **kw)
        return res.with_assigned(torch.full_like(res.assigned, -1))
    return fault


def _half_left_out(orig):
    """Part 1 runs over the first half of the blocked stream only."""
    def fault(stream, cfg, **kw):
        from repro_torch.core import EdgeStream
        h = stream.num_edges // 2
        half = EdgeStream(stream.src, stream.dst, stream.weight,
                          stream.valid & (torch.arange(stream.num_edges) < h))
        return orig(half, cfg, **kw)
    return fault


def _edge_dropped(orig):
    """Part 2's answer altered where it is made: one matched edge dropped."""
    def fault(stream, res, cfg, **kw):
        return orig(stream, res, cfg, **kw)[1:]
    return fault


def _weight_off(orig):
    """The weight altered where it is summed, by one part in 10^4."""
    def fault(stream, idx):
        return orig(stream, idx) * (1 + 1e-4)
    return fault


@pytest.mark.parametrize("module,attr,plant", [
    ("repro_torch.kernels.substream_match.ops", "substream_match", _assigned_unchanged),
    ("repro_torch.kernels.substream_match.ops", "substream_match", _half_left_out),
    ("repro_torch.core", "merge_host", _edge_dropped),
    ("repro_torch.core", "matching_weight", _weight_off),
])
def test_a_fault_under_the_timed_path_is_not_correct(tiny_root, monkeypatch, module, attr, plant):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, attr, plant(getattr(mod, attr)))
    res = _run(tiny_root)
    assert res["correct"] is False
    assert any(v["value"] is None or v["value"] > v["limit"] for v in res["checks"].values())


def test_a_failing_job_ends_the_window_counted_and_not_correct(tiny_root, monkeypatch):
    import repro_torch.core as core

    orig, calls = core.mwm_pipeline, []

    def third_fails(stream, *a, **k):  # the warm-up job, one job, then a failure
        calls.append(stream.num_edges)
        if len(calls) == 3:
            raise RuntimeError("planted")
        return orig(stream, *a, **k)
    monkeypatch.setattr(core, "mwm_pipeline", third_fails)
    res = _run(tiny_root)
    assert res["correct"] is False and res["failed"] == 1 and res["attempted"] == 2
    cell = harness.Cell("kron8.tiny", root=tiny_root)
    sizes = [cell.draw(2**31 + 3, j, "cpu")[0].shape[0] for j in range(cell.pool)]
    assert calls[0] == max(sizes) and calls[1] == sizes[0]  # warmed on the largest


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "kron48.s20",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_command_refuses_beside_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "kron48.s20",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_graph_seeds_take_large_seeds_and_redraw_alone():
    cell = harness.Cell("kron48.s16-jobs")
    seeds = {cell.graph_seed(2**31 + 7, j) for j in range(cell.pool)}
    assert len(seeds) == cell.pool and all(0 <= s < 2**63 for s in seeds)
    assert cell.graph_seed(2**31 + 7, 3) == cell.graph_seed(2**31 + 7, 3)
    checked = cell.checked_graphs(2**31 + 7)
    assert len(checked) == 4 and checked == cell.checked_graphs(2**31 + 7)
    assert len({tuple(cell.checked_graphs(s)) for s in range(20)}) > 1
    assert 0 <= cell.graph_seed(-5, 0) < 2**63 and len(cell.checked_graphs(-5)) == 4


def test_finite_replaces_nan_for_json():
    assert harness.finite({"a": [float("nan"), 1.0], "b": float("inf")}) == {"a": [None, 1.0], "b": None}
    assert np.isfinite(1.0)
