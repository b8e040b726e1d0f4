"""Port parity of the main path: lexicographic blocking, blocked Part 1,
the greedy merge and the postcondition guard, against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import guard as jguard
from repro_torch.convert import config_from_reference, result_to_numpy, stream_from_arrays
from repro_torch.core import (
    MatchingResult,
    check_matching,
    exact_mwm_weight,
    lexicographic_order,
    matching_problems,
    merge_host,
    mwm_blocked,
    mwm_pipeline,
)
from repro_torch.testing.cases import ZOO, rmat_case

CASES = {**ZOO,
         "rmat8": lambda: rmat_case(8, edge_factor=8, L=16, pad=7),
         "rmat10": lambda: rmat_case(10, edge_factor=4, L=64)}


def _pair(case):
    js = jcore.EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad)
    jcfg = jcore.SubstreamConfig(n=case.n, L=case.L, eps=case.eps)
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    return js, jcfg, stream_from_arrays(*arrays, device="cpu"), config_from_reference(
        case.n, case.L, case.eps, thr)


@pytest.mark.parametrize("K", [1, 4, 32])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "self_loops", "rmat8"])
def test_lexicographic_order_matches_reference(case, K):
    js, _, stream, _ = _pair(CASES[case]())
    want = np.asarray(jcore.lexicographic_order(js, K))
    got = lexicographic_order(stream, K).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["scan", "kernel"])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_L", "dense_small", "rmat8"])
def test_mwm_blocked_matches_reference(case, backend):
    js, jcfg, stream, cfg = _pair(CASES[case]())
    want = jcore.mwm_blocked(js, jcfg, backend="scan")
    got = mwm_blocked(stream, cfg, backend=backend, device="cpu")
    assert got.is_packed == (backend == "kernel")
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))


@pytest.mark.parametrize("part1, ref_part1", [("scan", "scan"), ("blocked", "blocked"),
                                              ("kernel", "blocked")])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pipeline_matches_reference(case, part1, ref_part1):
    js, jcfg, stream, cfg = _pair(CASES[case]())
    want_idx, want_w = jcore.mwm_pipeline(js, jcfg, part1=ref_part1)
    idx, weight = mwm_pipeline(stream, cfg, part1=part1, device="cpu")
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_w  # float32 sums over the same indices: rtol 0


@pytest.mark.parametrize("case", sorted(ZOO))
def test_merged_weight_within_bound(case):
    """The composed Crouch–Stubbs bound w(M*)/w(T) <= 4+eps against the
    exact blossom optimum, on the kernel path."""
    _, _, stream, cfg = _pair(CASES[case]())
    idx, weight = mwm_pipeline(stream, cfg, part1="kernel", device="cpu")
    exact = exact_mwm_weight(stream)
    if exact == 0:
        assert weight == 0
    else:
        assert weight > 0
        assert exact / weight <= 4 + cfg.eps + 1e-3
    res = mwm_blocked(stream, cfg, backend="kernel", device="cpu")
    check_matching(res, stream, cfg, merged=idx, exact_weight=exact)


def _corruptions(assigned, mb_packed, src, dst, L):
    """(name, assigned, mb_packed) variants a faulty engine could return."""
    rec = np.nonzero(assigned >= 0)[0]
    e = rec[0]
    out_of_range = assigned.copy()
    out_of_range[e] = L
    # re-record an unrecorded edge that shares an endpoint with e, in e's substream
    clash = [i for i in np.nonzero(assigned < 0)[0]
             if {src[i], dst[i]} & {src[e], dst[e]} and src[i] != dst[i]][0]
    double = assigned.copy()
    double[clash] = assigned[e]
    flipped = mb_packed.copy()
    flipped[src[e], assigned[e] // 8] ^= np.uint8(1 << (assigned[e] % 8))
    return [("out_of_range", out_of_range, mb_packed), ("double", double, mb_packed),
            ("flipped_bit", assigned, flipped)]


@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "rmat8"])
def test_matching_problems_agree_with_reference(case):
    js, jcfg, stream, cfg = _pair(CASES[case]())
    res = mwm_blocked(stream, cfg, backend="kernel", device="cpu")
    idx = merge_host(stream, res, cfg)
    assert matching_problems(res, stream, cfg, merged=idx) == []
    assigned, mb_packed = result_to_numpy(res)
    src, dst = stream.src.numpy(), stream.dst.numpy()
    for name, a, mbp in _corruptions(assigned, mb_packed, src, dst, cfg.L):
        got = matching_problems(
            MatchingResult(torch.from_numpy(a), mb_packed=torch.from_numpy(mbp), L=cfg.L),
            stream, cfg, merged=idx)
        want = jguard.matching_problems(
            jcore.MatchingResult(jnp.asarray(a), mb_packed=jnp.asarray(mbp), L=cfg.L),
            js, jcfg, merged=idx)
        assert got and got == want, name
