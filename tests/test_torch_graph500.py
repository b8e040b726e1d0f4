"""The main path on Graph500's Kronecker edge lists (scrambled labels,
self-loops and repeated edges kept), against the benchmark's plain
reference: ``mwm_pipeline(part1="kernel")`` and the card route's merge
(``merge_device``, run here on the CPU) give the reference's indices
exactly and its weight within the configuration's limit. Also the spans
and the counter that tell such a stream apart: Part 1's block and edges on
``kernel_edges.execute``, the merge's ``merge.kernel``, and
``stream.self_loops``."""
import json
import pathlib

import numpy as np
import pytest
import torch

from perfbench.gen import graph500
from perfbench.reference import matching as reference
from repro_torch import obs
from repro_torch.core import EdgeStream, SubstreamConfig, _merge_on_device, mwm_blocked, mwm_pipeline
from repro_torch.kernels.substream_match.ops import device_plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "graph500-L64.json").read_text())
LIMIT = CONFIG["limits"]["weight_rel_gap"]
L, EPS, K = CONFIG["L"], CONFIG["eps"], CONFIG["K"]


def _graph(scale, seed):
    g = torch.Generator().manual_seed(seed)
    return graph500.generate(CONFIG, scale, g)


def _plant(src, dst, w, loops, repeats, seed, n):
    """The stream with ``loops`` self-loops and ``repeats`` copies of its
    own edges other than loops (half of them turned round) put at random
    places."""
    rng = np.random.default_rng(seed)
    s, d, x = src.numpy(), dst.numpy(), w.numpy()
    v = rng.integers(0, n, loops)
    pick = rng.choice(np.flatnonzero(s != d), repeats)
    turn = rng.random(repeats) < 0.5
    add_s = np.concatenate([v, np.where(turn, d[pick], s[pick])]).astype(np.int32)
    add_d = np.concatenate([v, np.where(turn, s[pick], d[pick])]).astype(np.int32)
    hi = reference.thresholds(L, EPS)[-1] * 1.1
    add_w = rng.uniform(1.0, hi, loops + repeats).astype(np.float32)
    at = rng.integers(0, s.size + 1, loops + repeats)
    return (torch.from_numpy(np.insert(s, at, add_s)), torch.from_numpy(np.insert(d, at, add_d)),
            torch.from_numpy(np.insert(x, at, add_w)))


def _cfg(n):
    return SubstreamConfig(n=n, L=L, eps=EPS, thresholds=reference.thresholds(L, EPS))


def _stream(src, dst, w):
    return EdgeStream(src, dst, w, torch.ones(src.shape, dtype=torch.bool))


def _check(src, dst, w, n):
    """The pipeline and the card route's merge against the reference."""
    want_idx, want_w, _, _ = reference.mwm(src, dst, w, reference.thresholds(L, EPS), n, K)
    stream, cfg = _stream(src, dst, w), _cfg(n)
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", K=K, device="cpu")
    np.testing.assert_array_equal(idx, want_idx)
    assert abs(weight - want_w) <= LIMIT * abs(want_w)
    res = mwm_blocked(stream, cfg, K=K, backend="kernel", device="cpu")
    np.testing.assert_array_equal(_merge_on_device(stream, res, cfg, obs.DISABLED), want_idx)
    return want_idx


@pytest.mark.parametrize("scale,seed", [(8, 2**40 + 1), (10, 7), (12, 2**35 + 9)])
def test_pipeline_equals_the_reference_on_graph500_graphs(scale, seed):
    src, dst, w = _graph(scale, seed)
    assert src.shape[0] == 16 << scale
    idx = _check(src, dst, w, 1 << scale)
    assert idx.size and (src[idx] != dst[idx]).all()


@pytest.mark.parametrize("scale,seed", [(8, 3), (10, 2**33 + 4), (11, 5)])
def test_pipeline_equals_the_reference_with_planted_loops_and_repeats(scale, seed):
    n = 1 << scale
    src, dst, w = _plant(*_graph(scale, seed), loops=n // 4, repeats=n, seed=seed, n=n)
    idx = _check(src, dst, w, n)
    assert (src[idx] != dst[idx]).all()
    # repeated pairs are separate edges, of which at most one is matched
    a, b = src[idx].long(), dst[idx].long()
    assert torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b)).numel() == idx.size


def test_a_graph_of_self_loops_alone_matches_nothing():
    n = 256
    v = torch.arange(n, dtype=torch.int32).repeat(3)
    w = torch.linspace(1.0, 500.0, v.numel(), dtype=torch.float32)
    idx = _check(v, v.clone(), w, n)
    assert idx.size == 0


def _traced(scale, seed, loops, tel):
    n = 1 << scale
    src, dst, w = _graph(scale, seed)
    own = int((src == dst).sum())
    src, dst, w = _plant(src, dst, w, loops=loops, repeats=n // 2, seed=seed, n=n)
    stream, cfg = _stream(src, dst, w), _cfg(n)
    with tel.span("pipeline"):
        res = mwm_blocked(stream, cfg, K=K, backend="kernel", device="cpu", telemetry=tel)
        idx = _merge_on_device(stream, res, cfg, tel)
    return stream, cfg, own + loops, idx


def test_spans_and_counter_of_a_graph500_stream():
    tel = obs.Telemetry()
    stream, cfg, loops, idx = _traced(9, 2**36 + 3, 17, tel)
    spans = [e for e in tel.tracer.events if e["ph"] == "X"]
    by = {e["name"]: e for e in spans}
    plan, one = device_plan(cfg.n, cfg.L), device_plan(cfg.n, 1)
    assert by["kernel_edges.execute"]["args"] == {
        "edges": stream.num_edges, "bit_block_bytes": plan.nbytes, "fits_l2": 1}
    greedy, kernel = by["merge.greedy"], by["merge.kernel"]
    assert greedy["ts"] <= kernel["ts"]
    assert kernel["ts"] + kernel["dur"] <= greedy["ts"] + greedy["dur"]
    recorded = tel.counters.get("merge.recorded_edges")
    assert kernel["args"] == {"recorded": recorded, "bit_block_bytes": one.nbytes, "fits_l2": 1}
    rec, = tel.match_calls
    assert rec.counters["stream.self_loops"] == loops > 17
    assert tel.counters.get("kernel_edges.stream.self_loops") == loops
    assert rec.counters["stream.num_edges"] == stream.num_edges
    assert greedy["args"] == {"recorded": recorded, "matched": idx.size}


def test_the_bit_block_of_scale_23_leaves_the_l2():
    """The cell's sizes: 2^23 rows of 8 bytes at L = 64 and at the merge's
    L = 1 (the packed width rounded up to 8), past the H100's 50 MiB L2;
    at scale 22 both fit."""
    for L_ in (64, 1):
        plan = device_plan(1 << 23, L_)
        assert (plan.nbytes, plan.fits_l2) == (64 << 20, False)
        assert device_plan(1 << 22, L_).fits_l2


def test_disabled_telemetry_records_nothing():
    stream, cfg, _, idx = _traced(8, 11, 5, obs.DISABLED)
    assert idx.size
    assert obs.DISABLED.match_calls == () and obs.DISABLED.events == ()
    assert len(obs.DISABLED.counters) == 0
    assert obs.DISABLED.chrome_trace()["traceEvents"] == []
