"""The plain reference: hand-worked streams, the rounds against the
sequential loops, the program held to it on the CPU, and its control."""
import numpy as np
import pytest
import torch

from perfbench import check
from perfbench.gen import rmat
from perfbench.reference import matching as ref
from perfbench.reference import sequential as seq


def _t(xs, dtype=torch.int32):
    return torch.tensor(xs, dtype=dtype)


def test_hand_worked_path():
    # path 0-1-2-3; thresholds 1, 2, 4 (L = 3), K = 4 (one epoch):
    # blocked order by (v, u): e1 (1,0) w=5, e0 (1,2) w=3, e2 (2,3) w=1.5
    src, dst = _t([1, 1, 2]), _t([2, 0, 3])
    w = _t([3.0, 5.0, 1.5], torch.float32)
    thr = np.array([1, 2, 4], np.float32)
    assigned, _ = ref.part1(src, dst, w, torch.from_numpy(thr), 4, 4)
    # e1 is admitted to lanes 0-2 and joins all three: recorded in 2;
    # e0 (lanes 0, 1) finds vertex 1 taken: -1; e2 (lane 0) finds 2 and 3
    # free: recorded in 0. The merge keeps e1 and e2.
    assert assigned.tolist() == [-1, 2, 0]
    idx, wt, _, recorded = ref.mwm(src, dst, w, thr, 4, 4)
    assert idx.tolist() == [1, 2] and wt == 6.5 and recorded == 2


def test_hand_worked_merge_prefers_higher_substream():
    # two epochs (K = 2): edge 0 = (2,3) w=1.1 is blocked after edge 1 = (0,3) w=9;
    # (0,3) takes 3 in every lane; (2,3) is left out everywhere
    src, dst = _t([2, 0, 1]), _t([3, 3, 2])
    w = _t([1.1, 9.0, 2.5], torch.float32)
    thr = np.array([1, 2, 8], np.float32)
    idx, wt, _, _ = ref.mwm(src, dst, w, thr, 4, 2)
    assert idx.tolist() == [1, 2]
    assert wt == pytest.approx(11.5)


def test_blocked_order_is_epoch_then_v_then_u():
    src, dst = _t([5, 0, 1, 4, 1]), _t([0, 7, 3, 2, 3])
    order = ref.blocked_order(src, dst, 8, 4)
    # epochs: u//4 -> 1, 0, 0, 1, 0; within epoch 0 by v: (1,3)#2, (1,3)#4, (0,7)#1
    assert order.tolist() == [2, 4, 1, 0, 3]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("K,L", [(1, 8), (4, 16), (32, 64)])
def test_rounds_equal_the_sequential_loops(seed, K, L):
    g = torch.Generator().manual_seed(seed)
    n = 64
    src, dst = (torch.randint(0, n, (300,), generator=g, dtype=torch.int32) for _ in range(2))
    w = rmat.uniform_weights(300, L, 0.1, 1.0, g)
    thr = ref.thresholds(L, 0.1)
    want = seq.part1(src.tolist(), dst.tolist(), w.tolist(), thr.tolist(), n, K)
    merged = seq.part2(src.tolist(), dst.tolist(), want, n, L)
    for chunk in (1, 37, 10_000):  # one edge at a time, several chunks, one chunk
        assigned, _ = ref.part1(src, dst, w, torch.from_numpy(thr), n, K, chunk=chunk)
        assert assigned.tolist() == want
        assert ref.mwm(src, dst, w, thr, n, K, chunk=chunk)[0].tolist() == merged


def test_thresholds_rounded_once_from_float64():
    thr = ref.thresholds(64, 0.1)
    assert thr.dtype == np.float32
    assert thr[63] == np.float32(1.1 ** 63)
    assert (np.diff(thr) > 0).all()


def _rmat(scale, ef, seed):
    g = torch.Generator().manual_seed(seed)
    cfg = {"edge_factor": ef, "rmat_abc": [0.57, 0.19, 0.19], "L": 64, "eps": 0.1,
           "weight_low": 1.0}
    return rmat.generate(cfg, scale, g)


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_program_held_to_the_reference_on_the_cpu(seed):
    from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline

    src, dst, w = _rmat(8, 8, seed)
    thr = ref.thresholds(64, 0.1)
    stream = EdgeStream(src, dst, w, torch.ones(src.shape, dtype=torch.bool))
    cfg = SubstreamConfig(n=256, L=64, eps=0.1, thresholds=thr)
    idx, wt = mwm_pipeline(stream, cfg, part1="kernel", K=32, device="cpu")
    r_idx, r_wt, _, _ = ref.mwm(src, dst, w, thr, 256, 32)
    assert check.mismatches(idx, r_idx) == 0
    assert abs(wt - r_wt) / r_wt < 1e-6


def test_control_in_bfloat16_is_not_correct():
    """The control, the reference one precision below the configuration's
    float32, fails the check the runs pass (kept at a size a test holds)."""
    limits = {"mismatched_edges": 0, "weight_rel_gap": 1e-5, "unchecked_graphs": 0}
    failed = 0
    for seed in (21, 22, 23):
        src, dst, w = _rmat(12, 8, seed)
        thr = ref.thresholds(64, 0.1)
        want = ref.mwm(src, dst, w, thr, 4096, 32)
        ctl = ref.mwm(src, dst, w, thr, 4096, 32, precision="bfloat16")
        numbers = check.compare({0: [ctl[:2]]}, {0: want[:2]}, limits)
        failed += not check.correct(numbers)
        assert numbers["mismatched_edges"]["value"] > 0
    assert failed == 3
