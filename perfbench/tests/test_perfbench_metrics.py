"""The benchmark's arithmetic and every metric reader on synthetic records."""
import json
import pathlib

import numpy as np
import pytest

from perfbench import arith, harness, trace

METRICS = pathlib.Path(harness.ROOT) / "perfbench" / "metrics"


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", name)


@pytest.mark.parametrize("q", [0, 50, 90, 95, 99, 100])
def test_percentile_over_all_jobs_is_numpys(q):
    xs = np.random.default_rng(q).exponential(size=337)
    assert arith.percentile(xs.tolist(), q) == pytest.approx(np.percentile(xs, q))


def test_rate_is_over_the_whole_window():
    jobs = [{"edges": 10}, {"edges": 30}]
    assert arith.rate(jobs, 4.0) == 10.0


def test_roofline_bytes_from_shapes():
    # 16 B an edge, 4 B a threshold, ceil(L/8) B a vertex
    assert arith.part1_bytes(1000, 64, 64) == 16_000 + 256 + 64 * 8
    assert arith.part1_bytes(44_350_400, 1 << 20, 64) == 709_606_400 + 256 + 8 * 2**20
    assert arith.part1_bytes(0, 10, 9) == 36 + 20


def test_span_self_time():
    spans = [("p", 0.0, 10.0), ("c", 2.0, 5.0), ("p", 20.0, 24.0), ("c", 21.0, 22.0),
             ("c", 30.0, 31.0)]
    assert arith.self_time(spans, "p", "c") == pytest.approx((7 + 3) / 2)
    assert arith.self_time(spans, "x", "c") is None
    assert arith.self_time(spans + [("p", 40.0, 41.0)], "p", "c") is None


def test_union_gaps_and_timeline():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12)]
    assert arith.union(iv) == [[0, 3], [5, 6], [8, 12]]
    assert arith.gaps(iv, -1, 10) == [[-1, 0], [3, 5], [6, 8]]
    t = arith.Timeline(iv)
    assert t.busy(2, 9) == pytest.approx(1 + 1 + 1)
    assert t.busy(-5, 20) == pytest.approx(3 + 1 + 4)
    assert arith.covered(iv, 6, 8) == 0


def _chrome():
    """A synthetic profiler trace (times in microseconds): a 100 us window,
    two jobs, device busy 0-10, 12-20 and 55-70."""
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    p = trace.PREFIX
    return {"traceEvents": [
        x(p + "window", "user_annotation", 0, 100),
        x(p + "job", "user_annotation", 0, 45),
        x(p + "mwm_pipeline", "user_annotation", 0, 45),
        x(p + "mwm_blocked", "user_annotation", 0, 30),
        x(p + "substream_match", "user_annotation", 10, 15),
        x(p + "job", "user_annotation", 50, 50),
        x(p + "mwm_pipeline", "user_annotation", 50, 50),
        x(p + "mwm_blocked", "user_annotation", 50, 30),
        x(p + "substream_match", "user_annotation", 52, 20),
        x("copy_kernel", "kernel", 0, 10),
        x("Memcpy HtoD", "gpu_memcpy", 12, 8),
        x("edges_kernel", "kernel", 55, 15),
        x("aten::sort", "cpu_op", 0, 99),
        x("other/annotation", "user_annotation", 0, 99),
        {"ph": "i", "name": "instant", "ts": 3},
    ]}


def _record():
    tr = trace.parse(_chrome())
    return {"jobs": [{"graph": 0, "t0": 0.0, "t1": 0.045, "edges": 1000},
                     {"graph": 1, "t0": 0.05, "t1": 0.1, "edges": 3000}],
            "window_s": 0.1, "setup_s": 7.5, "peak_bytes": 3 * 2**30,
            "n": 64, "L": 64, "device_kind": "NVIDIA H100 80GB HBM3",
            "peaks": json.loads((METRICS.parent / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"],
            "trace": tr}


def test_parse_keeps_benchmark_spans_and_device_operations():
    tr = trace.parse(_chrome())
    assert [s[0] for s in tr["spans"]].count("job") == 2
    assert sorted(d[0] for d in tr["device"]) == ["Memcpy HtoD", "copy_kernel", "edges_kernel"]
    assert tr["device"][0][1] == 0 and tr["device"][0][2] == pytest.approx(10e-6)


def test_readers_on_a_synthetic_trace():
    r = _record()
    assert reader("edges_per_s").read(r) == pytest.approx(40_000)
    assert reader("job_p95_ms").read(r) == pytest.approx(45 + 0.95 * 5)
    assert reader("device_peak_gib").read(r) == 3
    assert reader("setup_s").read(r) == 7.5
    # idle: busy 10 + 8 + 15 of 100 us
    assert reader("device_idle_pct").read(r) == pytest.approx(67)
    # substream_match spans 10-25 (busy 12-20: 8 us) and 52-72 (busy 55-70: 15)
    assert reader("part1_kernel_ms").read(r) == pytest.approx((8 + 15) / 2 * 1e-3)
    # mwm_blocked 30 us less substream_match 15 / 20
    assert reader("blocking_ms").read(r) == pytest.approx((15 + 10) / 2 * 1e-3)
    # mwm_pipeline 45 / 50 less mwm_blocked 30 / 30
    assert reader("part2_ms").read(r) == pytest.approx((15 + 20) / 2 * 1e-3)
    least = (arith.part1_bytes(1000, 64, 64) + arith.part1_bytes(3000, 64, 64)) / 3.35e12
    assert reader("part1_roofline_pct").read(r) == pytest.approx(100 * least / 23e-6)


@pytest.mark.parametrize("name", ["blocking_ms", "part1_kernel_ms", "part1_roofline_pct",
                                  "part2_ms", "device_idle_pct", "device_peak_gib"])
def test_readers_find_nothing_without_a_trace_or_a_card(name):
    r = dict(_record(), trace=None, peak_bytes=None)
    assert reader(name).read(r) is None


def test_roofline_reads_nothing_for_an_unknown_card_or_an_idle_device():
    assert reader("part1_roofline_pct").read(dict(_record(), peaks=None)) is None
    r = _record()
    r["trace"] = dict(r["trace"], device=[])
    assert reader("part1_roofline_pct").read(r) is None
    assert reader("device_idle_pct").read(r) is None


def test_breakdown_names_gaps_by_the_innermost_span():
    out = harness.breakdown(trace.parse(_chrome()))
    assert out["device_ops"][0] == ["edges_kernel", pytest.approx(15e-6)]
    # longest first: 20-55 us (mostly job 1's mwm_pipeline after its
    # mwm_blocked, i.e. Part 2), 70-100 (job 2's), 10-12 (substream_match)
    assert out["idle_gaps"] == [["mwm_pipeline", pytest.approx(35e-6)],
                                ["mwm_pipeline", pytest.approx(30e-6)],
                                ["substream_match", pytest.approx(2e-6)]]


def test_dominant_span_prefers_inner_spans_over_job_frames():
    spans = [("job", 0, 10), ("a", 0, 6), ("b", 6, 9), ("job", 10, 20), ("c", 10, 20)]
    assert arith.dominant(spans, 5, 9, frames=("job",)) == "b"
    assert arith.dominant(spans, 9, 9.5, frames=("job",)) == "job"
    assert arith.dominant(spans, 7, 14, frames=("job",)) == "c"
    assert arith.dominant(spans, 30, 31) is None
