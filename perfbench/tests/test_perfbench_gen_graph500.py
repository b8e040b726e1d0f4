"""The Graph500 generator against a numpy transcription of the
specification's Octave listing ``kronecker_generator`` (Sec. 3), on the CPU."""
import numpy as np
import pytest
import torch

from perfbench.gen import graph500

ABC = (0.57, 0.19, 0.19)
CFG = {"edge_factor": 16, "rmat_abc": list(ABC), "L": 64, "eps": 0.1, "weight_low": 1.0}


def kronecker_generator(scale, edgefactor, rng, permute=True):
    """The listing, line by line (Octave's 1-based ids, then ``ij - 1``)."""
    N = 2**scale
    M = edgefactor * N
    A, B, C = ABC
    ij = np.ones((2, M), dtype=np.int64)
    ab = A + B
    c_norm = C / (1 - (A + B))
    a_norm = A / (A + B)
    for ib in range(1, scale + 1):
        ii_bit = rng.random(M) > ab
        jj_bit = rng.random(M) > (c_norm * ii_bit + a_norm * ~ii_bit)
        ij = ij + 2 ** (ib - 1) * np.stack([ii_bit, jj_bit])
    if permute:
        p = rng.permutation(N) + 1
        ij = p[ij - 1]
        p = rng.permutation(M)
        ij = ij[:, p]
    return ij - 1


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _quadrants(src, dst, scale):
    """[scale, 4]: the share of edges in each quadrant (ii, jj) per bit."""
    out = np.zeros((scale, 4))
    for bit in range(scale):
        q = ((src >> bit) & 1) * 2 + ((dst >> bit) & 1)
        out[bit] = np.bincount(q, minlength=4) / q.size
    return out


def _loops_and_repeats(src, dst, n):
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    key = np.minimum(src, dst) * n + np.maximum(src, dst)
    return int((src == dst).sum()), src.size - np.unique(key).size


def test_bit_marginals_match_the_listing_at_scale_12():
    """Per bit, the quadrant shares of the raw draw are the listing's within
    0.012 (at M = 65,536 a share's standard error is at most 0.002, so the
    bound is ~4 standard errors of a difference), and both are A/B/C/D's."""
    scale = 12
    src, dst = graph500.kronecker_bits(scale, 16, ABC, _gen(2**41 + 7))
    got = _quadrants(src.numpy().astype(np.int64), dst.numpy().astype(np.int64), scale)
    ij = kronecker_generator(scale, 16, np.random.default_rng(5), permute=False)
    want = _quadrants(ij[0], ij[1], scale)
    assert np.abs(got - want).max() < 0.012
    law = np.array([ABC[0], ABC[1], ABC[2], 1 - sum(ABC)])
    assert np.abs(got - law).max() < 0.01 and np.abs(want - law).max() < 0.01


@pytest.mark.parametrize("scale,seed", [(10, 3), (12, 2**40 + 2)])
def test_relabelling_is_a_permutation_and_nothing_is_dropped(scale, seed):
    n, m = 1 << scale, 16 << scale
    raw_s, raw_d = graph500.kronecker_bits(scale, 16, ABC, _gen(seed))
    src, dst, w = graph500.generate(CFG, scale, _gen(seed))
    assert src.shape == dst.shape == w.shape == (m,)
    assert (src.dtype, dst.dtype, w.dtype) == (torch.int32, torch.int32, torch.float32)
    assert 0 <= int(src.min()) and int(max(src.max(), dst.max())) < n

    def degrees(s, d):
        return np.sort(np.bincount(torch.cat([s, d]).long().numpy(), minlength=n))

    np.testing.assert_array_equal(degrees(src, dst), degrees(raw_s, raw_d))
    loops, repeats = _loops_and_repeats(src, dst, n)
    assert (loops, repeats) == _loops_and_repeats(raw_s, raw_d, n)
    assert loops > 0 and repeats > 0
    # the labels are scrambled: the raw draw's hubs sit at the lowest ids
    deg = np.bincount(torch.cat([src, dst]).long().numpy(), minlength=n)
    raw = np.bincount(torch.cat([raw_s, raw_d]).long().numpy(), minlength=n)
    assert raw.argmax() == 0 and deg.argmax() != 0
    # and the order: the raw draw's edge 0 is not the stream's
    assert not (torch.equal(src[:64], raw_s[:64]) and torch.equal(dst[:64], raw_d[:64]))


def test_self_loops_and_repeats_as_often_as_in_the_listing():
    """Shares of self-loops and repeated pairs at scale 12 within 25 % of
    the listing's (about 200 loops and 26 % repeats a draw)."""
    n = 1 << 12
    src, dst, _ = graph500.generate(CFG, 12, _gen(2**33 + 1))
    ij = kronecker_generator(12, 16, np.random.default_rng(9))
    got, want = _loops_and_repeats(src, dst, n), _loops_and_repeats(ij[0], ij[1], n)
    for g, w in zip(got, want):
        assert abs(g - w) < 0.25 * w


def test_same_seed_same_stream_other_seed_other():
    a = [graph500.generate(CFG, 9, _gen(2**35 + 1)) for _ in range(2)]
    b = graph500.generate(CFG, 9, _gen(2**35 + 2))
    assert all(torch.equal(x, y) for x, y in zip(*a))
    assert not torch.equal(a[0][0], b[0]) and not torch.equal(a[0][2], b[2])


@pytest.mark.gpu
def test_on_the_card_the_program_equals_the_reference(card):
    """Drawn on the card at scale 14 (self-loops and repeats kept): the main
    path from pinned memory, Part 2 on the card, gives the reference's
    indices, and its traced run names the self-loops it was handed."""
    from perfbench import check, harness
    from perfbench.reference import matching as ref
    from repro_torch import obs
    from repro_torch.core import SubstreamConfig, mwm_pipeline

    thr = ref.thresholds(64, 0.1)
    n = 1 << 14
    cfg = SubstreamConfig(n=n, L=64, eps=0.1, thresholds=thr)
    for seed in (3, 2**33 + 7):
        src, dst, w = graph500.generate(CFG, 14, torch.Generator(device=card).manual_seed(seed))
        assert src.is_cuda and src.shape[0] == 16 * n
        stream = harness.host_stream(src, dst, w, card)
        tel = obs.Telemetry()
        idx, wt = mwm_pipeline(stream, cfg, part1="kernel", K=32, device=card, telemetry=tel)
        r_idx, r_wt, _, _ = ref.mwm(src, dst, w, thr, n, 32)
        assert check.mismatches(idx, r_idx) == 0
        assert abs(wt - r_wt) / r_wt < 1e-6
        loops = int((src == dst).sum())
        assert loops > 0 and tel.match_calls[-1].counters["stream.self_loops"] == loops
