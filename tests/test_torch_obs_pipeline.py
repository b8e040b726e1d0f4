"""The telemetry of the port's main path (``mwm_pipeline`` → ``mwm_blocked``
→ ``substream_match`` → ``merge_host``), on the CPU through the kernels'
plain versions.

* with an explicit :class:`repro_torch.obs.Telemetry`: the exact span
  tree under one ``pipeline`` span, every span's args, and the same
  indices and weight with telemetry on and off;
* under ``torch.profiler``: the exported Chrome trace holds a
  ``repro_torch/<name>`` ``user_annotation`` range for every span, nested
  as the spans are, and the process-wide session fills only while the
  profiler records;
* with no profiler: :func:`repro_torch.obs.active` hands back the shared
  disabled facade, and the pipeline opens no profiler range, synchronises
  nothing and retains nothing.
"""
import json
import tempfile
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import EdgeStream, SubstreamConfig, merge_host, mwm_blocked, mwm_pipeline
from repro_torch.kernels.substream_match.ops import device_plan, merge_device, substream_match
from repro_torch.obs import trace as obs_trace

STREAM_BYTES_PER_EDGE = 4 + 4 + 4 + 1  # src, dst int32, weight float32, valid bool


def _case(m=500, n=96, L=8, eps=0.1, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = (rng.random(m) * 10 + 1).astype(np.float32)
    return EdgeStream.from_numpy(src, dst, w, device="cpu"), SubstreamConfig(n=n, L=L, eps=eps)


def _tree(events):
    """[(name, args, children)] of complete events, nested by interval
    containment (the trace's own rule)."""
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: (e["ts"], -e["dur"]))
    root, stack = [], []
    for e in spans:
        while stack and e["ts"] + e["dur"] > stack[-1][0]["ts"] + stack[-1][0]["dur"]:
            stack.pop()
        node = (e["name"], e.get("args"), [])
        (stack[-1][1][2] if stack else root).append(node)
        stack.append((e, node))
    return root


def _names(tree):
    return [(name, _names(kids)) for name, _, kids in tree]


def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler``; the exported trace's
    ``repro_torch/`` ranges (the prefix taken off) and ``fn``'s result."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            chrome = json.load(f)
    ranges = []
    for e in chrome["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith(obs_trace.PROFILER_PREFIX):
            assert e["cat"] == "user_annotation"
            ranges.append(dict(e, name=e["name"][len(obs_trace.PROFILER_PREFIX):]))
    return ranges, out


@pytest.fixture
def fresh_session(monkeypatch):
    """A new process-wide profiler session for the test alone."""
    monkeypatch.setattr(obs, "_PROFILER_SESSION", None)
    yield
    assert not obs.profiling()


KERNEL_TREE = [
    ("pipeline", [
        ("blocked", [
            ("stream.to", []),
            ("blocked.order", []),
            ("blocked.permute", []),
            ("stream.to", []),
            ("kernel_edges.layout", []),
            ("kernel_edges.execute", []),
            ("blocked.unpermute", []),
        ]),
        ("merge.host", [("merge.d2h", []), ("merge.order", []), ("merge.greedy", [])]),
        ("merge.weight", []),
    ]),
]


@pytest.mark.parametrize("packed", [True, False])
def test_pipeline_span_tree_and_args(packed):
    """``cpu:0`` is not ``cpu`` to ``EdgeStream.to``: both copies it asks
    for (``mwm_blocked``'s and ``substream_match``'s) are recorded. (On the
    card ``mwm_pipeline`` copies the stream once and hands its own device,
    ``cuda:0``, on, so Part 1 and the merge copy nothing.)"""
    stream, cfg = _case(seed=int(packed))
    tel = obs.Telemetry()
    idx, _ = mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu:0", packed=packed,
                          telemetry=tel)
    tree = _tree(tel.tracer.events)
    assert _names(tree) == KERNEL_TREE
    (_, pargs, (blocked, host, weight)), = tree
    assert pargs == {"call": 0, "m": stream.num_edges, "part1": "kernel"}
    to_args = {"bytes": stream.num_edges * STREAM_BYTES_PER_EDGE, "source": "cpu",
               "target": "cpu:0"}
    assert stream.nbytes == to_args["bytes"]
    assert [args for name, args, _ in blocked[2] if name == "stream.to"] == [to_args] * 2
    plan = device_plan(cfg.n, cfg.L, packed=packed)
    execute = {"edges": stream.num_edges, "bit_block_bytes": plan.nbytes,
               "fits_l2": int(plan.fits_l2)}
    assert [args for name, args, _ in blocked[2] if name == "kernel_edges.execute"] == [execute]
    assert all(args is None for name, args, _ in blocked[2]
               if name not in ("stream.to", "kernel_edges.execute"))
    assert blocked[1] is None and host[1] is None and weight[1] is None
    d2h, order, greedy = (args for _, args, _ in host[2])
    recorded = tel.counters.get("merge.recorded_edges")
    assert d2h == {"bytes": stream.num_edges * 4}
    assert order == {"recorded": recorded} and recorded > 0
    assert greedy == {"recorded": recorded, "matched": len(idx)}
    assert tel.counters.get("merge.matched_edges") == len(idx)
    rec, = tel.match_calls
    assert rec.engine == "kernel_edges" and rec.num_edges == stream.num_edges


def test_pipeline_calls_are_numbered_in_the_session():
    stream, cfg = _case(m=200, n=48)
    tel = obs.Telemetry()
    for part1 in ("kernel", "blocked", "scan"):
        mwm_pipeline(stream, cfg, part1=part1, K=4, device="cpu", telemetry=tel)
    pipes = [e["args"] for e in tel.tracer.events if e["name"] == "pipeline"]
    assert pipes == [{"call": k, "m": 200, "part1": p}
                     for k, p in enumerate(("kernel", "blocked", "scan"))]
    # on the stream's own device nothing is copied: no stream.to span
    assert "stream.to" not in {e["name"] for e in tel.tracer.events}
    assert _names(_tree(tel.tracer.events))[1] == (
        "pipeline", [("blocked", [("blocked.order", []), ("blocked.permute", []),
                                  ("blocked.unpermute", [])]),
                     ("merge.host", [("merge.d2h", []), ("merge.order", []),
                                     ("merge.greedy", [])]),
                     ("merge.weight", [])])


@pytest.mark.parametrize("part1,kw", [
    ("kernel", {}), ("kernel", {"packed": False}), ("kernel", {"schedule": "mega"}),
    ("blocked", {}), ("scan", {}), ("waves", {}), ("rounds", {}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_same_matching_with_telemetry_on_and_off(part1, kw, seed):
    stream, cfg = _case(m=450, n=80, L=13, seed=seed)
    tel = obs.Telemetry()
    on = mwm_pipeline(stream, cfg, part1=part1, K=8, device="cpu", telemetry=tel, **kw)
    off = mwm_pipeline(stream, cfg, part1=part1, K=8, device="cpu", **kw)
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1] == off[1]
    assert [e["name"] for e in tel.tracer.events][-1] == "pipeline"


@pytest.mark.parametrize("part1", ["scan", "waves", "blocked", "kernel", "rounds"])
def test_the_cpu_route_merges_on_the_host(part1):
    """Part 2 runs where Part 1's result lives: on the CPU every ``part1``
    merges with ``merge_host`` (the reference semantics), never with
    ``merge_device``, and copies nothing."""
    stream, cfg = _case(m=300, n=64, L=8, seed=5)
    tel = obs.Telemetry()
    idx, _ = mwm_pipeline(stream, cfg, part1=part1, K=8, device="cpu", telemetry=tel)
    names = {e["name"] for e in tel.tracer.events}
    assert "merge.host" in names and not names & {"merge.device", "stream.to"}
    assert tel.counters.get("merge.host.calls") == 1
    assert tel.counters.get("merge.device.calls", None) is None
    assert tel.counters.get("merge.matched_edges") == len(idx)


@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_card_routes_merge_on_the_cpu(seed, empty):
    """The card route's Part 2 (``merge_device``, then the matched indices
    to the host) run on the CPU: ``merge_host``'s indices, under
    ``merge.device`` (``merge.order``, ``merge.greedy`` holding
    ``merge.kernel`` where an edge was recorded) and ``merge.d2h`` of 8
    bytes a matched edge, with ``merge_host``'s counters."""
    from repro_torch.core import _merge_on_device

    stream, cfg = _case(m=400, n=72, L=8, seed=seed)
    res = mwm_blocked(stream, cfg, K=8, backend="kernel", device="cpu")
    if empty:
        res = res.with_assigned(torch.full_like(res.assigned, -1))
    host_tel, tel = obs.Telemetry(), obs.Telemetry()
    want = merge_host(stream, res, cfg, telemetry=host_tel)
    with tel.span("pipeline"):
        idx = _merge_on_device(stream, res, cfg, tel)
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, want)
    (_, _, (device, d2h)), = _tree(tel.tracer.events)
    recorded = host_tel.counters.get("merge.recorded_edges")
    kernel = [("merge.kernel", [])] if recorded else []
    assert _names([device]) == [("merge.device", [("merge.order", []), ("merge.greedy", kernel)])]
    assert [args for _, args, _ in device[2]] == [
        {"recorded": recorded}, {"recorded": recorded, "matched": len(want)}]
    assert (d2h[0], d2h[1]) == ("merge.d2h", {"bytes": 8 * len(want)})
    for name in ("merge.recorded_edges", "merge.matched_edges"):
        assert tel.counters.get(name) == host_tel.counters.get(name)
    assert tel.counters.get("merge.device.calls") == 1


def test_merge_host_spans_on_an_empty_matching():
    stream, cfg = _case(m=50, n=16)
    res = mwm_blocked(stream, cfg, K=4, device="cpu")
    tel = obs.Telemetry()
    got = merge_host(stream, res.with_assigned(torch.full_like(res.assigned, -1)), cfg,
                     telemetry=tel)
    assert got.dtype == np.int64 and got.size == 0
    (_, _, kids), = _tree(tel.tracer.events)
    assert [(name, args) for name, args, _ in kids] == [
        ("merge.d2h", {"bytes": 200}), ("merge.order", {"recorded": 0}),
        ("merge.greedy", {"recorded": 0, "matched": 0})]


def test_stream_to_records_only_a_copy():
    stream, _ = _case(m=64, n=16)
    tel = obs.Telemetry()
    assert stream.to("cpu", telemetry=tel) is stream
    assert tel.tracer.events == []
    moved = stream.to("meta", telemetry=tel)
    assert moved.device.type == "meta"
    (name, args, _), = _tree(tel.tracer.events)
    assert (name, args) == ("stream.to", {"bytes": 64 * STREAM_BYTES_PER_EDGE,
                                          "source": "cpu", "target": "meta"})
    assert stream.to("meta").device.type == "meta"  # disabled: no span, same copy
    assert len(tel.tracer.events) == 1


# ------------------------------------------------------ under the profiler


def test_profiler_trace_nests_like_the_session(fresh_session):
    stream, cfg = _case(seed=3)
    ranges, (idx, weight) = _profiled(
        lambda: mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu:0"))
    session = obs.profiler_session()
    assert _names(_tree(ranges)) == _names(_tree(session.tracer.events)) == KERNEL_TREE
    off = mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu:0")
    np.testing.assert_array_equal(idx, off[0])
    assert weight == off[1]
    # one range a span, and each range at least as long as its span
    spans = sorted((e for e in session.tracer.events if e["ph"] == "X"), key=lambda e: e["ts"])
    ranges = sorted(ranges, key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [e["name"] for e in spans]
    assert all(r["dur"] >= s["dur"] * (1 - 1e-6) - 1.0 for r, s in zip(ranges, spans))


def test_profiler_session_fills_only_while_recording(fresh_session):
    stream, cfg = _case(m=200, n=48)
    mwm_pipeline(stream, cfg, part1="kernel", K=4, device="cpu")
    assert obs._PROFILER_SESSION is None

    def twice():
        assert obs.active(obs.DISABLED) is obs.profiler_session()
        assert obs.active(None) is obs.profiler_session()
        mine = obs.Telemetry()
        assert obs.active(mine) is mine  # an explicit session wins
        for _ in range(2):
            mwm_pipeline(stream, cfg, part1="kernel", K=4, device="cpu")

    _profiled(twice)
    session = obs.profiler_session()
    n = len(session.tracer.events)
    assert [e["args"]["call"] for e in session.tracer.events if e["name"] == "pipeline"] == [0, 1]
    assert len(session.match_calls) == 2
    mwm_pipeline(stream, cfg, part1="kernel", K=4, device="cpu")
    assert len(session.tracer.events) == n and obs.profiler_session() is session
    assert obs.active(obs.DISABLED) is obs.DISABLED


def test_an_explicit_session_keeps_its_spans_under_the_profiler(fresh_session):
    stream, cfg = _case(m=200, n=48)
    tel = obs.Telemetry()
    ranges, _ = _profiled(
        lambda: mwm_pipeline(stream, cfg, part1="kernel", K=4, device="cpu", telemetry=tel))
    assert obs._PROFILER_SESSION is None
    assert _names(_tree(ranges)) == _names(_tree(tel.tracer.events))


def test_every_kind_of_span_opens_a_range(fresh_session):
    """``Tracer.span``, a recorder stage and ``stopwatch`` each open a
    range while the profiler records, and none while it does not."""
    tel = obs.Telemetry()

    def spans():
        with tel.span("outer", k=1):
            rec = obs.recorder(tel, "probe", 1)
            with rec.stage("layout"):
                pass
            with obs.stopwatch(tel, "watch"):
                pass
            with obs.stopwatch(obs.DISABLED, "unrecorded"):
                pass
            rec.finish()

    ranges, _ = _profiled(spans)
    assert _names(_tree(ranges)) == [("outer", [("probe.layout", []), ("watch", [])])]
    before = len(tel.tracer.events)
    spans()
    assert len(tel.tracer.events) == before + 3


def test_merge_device_records_into_the_profiler_session(fresh_session):
    stream, cfg = _case(m=300, n=64)
    res = mwm_blocked(stream, cfg, K=8, device="cpu")
    ranges, mask = _profiled(lambda: merge_device(stream, res, cfg, device="cpu"))
    names = [name for name, _ in _names(_tree(ranges))]
    assert names == ["merge.device"]
    assert obs.profiler_session().counters.get("merge.device.calls") == 1
    np.testing.assert_array_equal(torch.nonzero(mask).flatten().numpy(),
                                  merge_host(stream, res, cfg))


# ------------------------------------------------------- with no profiler


def test_untraced_pipeline_opens_no_range_syncs_nothing_and_retains_nothing(monkeypatch):
    assert obs.active(obs.DISABLED) is obs.DISABLED and obs.active(None) is obs.DISABLED
    opened, synced = [], []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: opened.append(a))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: synced.append(a))
    stream, cfg = _case(m=300, n=64)
    before = obs._PROFILER_SESSION
    idx, w = mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu")  # warm caches
    res = mwm_blocked(stream, cfg, K=8, device="cpu")
    tracemalloc.start()
    for _ in range(20):
        got = mwm_pipeline(stream, cfg, part1="kernel", K=8, device="cpu:0")
        merge_host(stream, res, cfg)
        substream_match(stream, cfg, device="cpu")
        merge_device(stream, res, cfg, device="cpu")
        del got
    current, _ = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert opened == [] and synced == []
    assert obs._PROFILER_SESSION is before
    assert current < 65_536, f"the untraced pipeline retained {current} bytes"


def test_span_sync_only_on_a_cuda_device_and_only_when_enabled(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: synced.append(d))
    tel = obs.Telemetry()
    with tel.span("host", sync=torch.device("cpu")):
        pass
    with tel.span("card", sync=torch.device("cuda", 0)):
        pass
    with obs.DISABLED.span("off", sync=torch.device("cuda", 0)):
        pass
    with pytest.raises(ValueError):
        with tel.span("failed", sync=torch.device("cuda", 0)):
            raise ValueError("no sync on the way out of a failure")
    assert synced == [torch.device("cuda", 0)]
    assert [e["name"] for e in tel.tracer.events] == ["host", "card", "failed"]


def test_note_adds_args_and_the_null_span_ignores_them():
    tel = obs.Telemetry()
    with tel.span("s", a=1) as span:
        span.note(b=2)
        span.note(a=3)
    assert tel.tracer.events[0]["args"] == {"a": 3, "b": 2}
    with obs.DISABLED.span("s") as span:
        assert span is obs.NULL_SPAN
        span.note(b=2)
