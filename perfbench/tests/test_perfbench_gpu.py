"""Card-only checks of the benchmark (marker ``gpu``; they skip without a
CUDA device): the generator and the reference on the card, the program
held to the reference there, and a traced run reading the device trace."""
import time

import pytest
import torch

from perfbench import check, harness
from perfbench.gen import rmat
from perfbench.reference import matching as ref

pytestmark = pytest.mark.gpu
CFG = {"edge_factor": 48, "rmat_abc": [0.57, 0.19, 0.19], "L": 64, "eps": 0.1,
       "weight_low": 1.0}


def _draw(scale, seed, device):
    return rmat.generate(CFG, scale, torch.Generator(device=device).manual_seed(seed))


def test_generator_on_the_card(card):
    from repro_torch.graph import generators

    src, dst, w = _draw(12, 2**31 + 1, card)
    assert src.is_cuda and (src != dst).all()
    key = torch.minimum(src, dst).long() * 4096 + torch.maximum(src, dst)
    assert torch.unique(key).numel() == src.shape[0]
    # repeats are many at this scale: held to the numpy definition's count
    m_np = generators.kronecker_graph(12, edge_factor=48, seed=3)[0].shape[0]
    assert abs(src.shape[0] - m_np) / m_np < 0.02
    assert w.min().item() >= 1.0 and w.max().item() <= rmat.weight_high(64, 0.1)


def test_reference_on_the_card_equals_the_cpu(card):
    src, dst, w = _draw(11, 5, "cpu")
    thr = ref.thresholds(64, 0.1)
    on_cpu = ref.mwm(src, dst, w, thr, 2048, 32)
    on_card = ref.mwm(src.to(card), dst.to(card), w.to(card), thr, 2048, 32, chunk=999)
    assert on_card[0].tolist() == on_cpu[0].tolist()
    assert on_card[1] == pytest.approx(on_cpu[1], rel=1e-12)


def test_program_on_the_card_held_to_the_reference(card):
    from repro_torch.core import SubstreamConfig, mwm_pipeline

    thr = ref.thresholds(64, 0.1)
    for seed in (1, 2, 2**32 + 3):
        src, dst, w = _draw(14, seed, card)
        stream = harness.host_stream(src, dst, w, card)
        cfg = SubstreamConfig(n=1 << 14, L=64, eps=0.1, thresholds=thr)
        idx, wt = mwm_pipeline(stream, cfg, part1="kernel", K=32, device=card)
        r_idx, r_wt, _, _ = ref.mwm(src, dst, w, thr, 1 << 14, 32)
        assert check.mismatches(idx, r_idx) == 0
        assert abs(wt - r_wt) / r_wt < 1e-6


def test_traced_run_reads_the_device(card):
    cell = harness.Cell("kron48.s16-jobs")
    cell.pool = 2
    cell.traffic = dict(cell.traffic, check_graphs=1)
    res = harness.run(cell, 2**31 + 17, 1.0, True, card, time.perf_counter())
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert {"part1_kernel_ms", "part1_roofline_pct", "device_idle_pct", "blocking_ms",
            "part2_ms"} <= set(res["metrics"])
    assert 0 < res["metrics"]["part1_roofline_pct"]["value"] < 100
    assert res["breakdown"]["device_ops"] and res["breakdown"]["idle_gaps"]
