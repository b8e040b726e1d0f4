"""Port parity of the data types: guarded stream construction, the result
storage and the pinned threshold hazard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import guard as jguard
from repro_torch.convert import config_from_reference, stream_from_arrays
from repro_torch.core import EdgeStream, MatchingResult, SubstreamConfig, mwm_scan
from repro_torch.core import guard
from repro_torch.kernels.substream_match.ops import substream_match


def _dirty():
    src = np.array([0, 1, 2**33, 3, 4, 5], np.int64)
    dst = np.array([1, 2, 3, -(2**40), 5, 6], np.int64)
    w = np.array([1.5, np.nan, 2.0, 3.0, 1e40, 2.5], np.float64)
    return src, dst, w


def _arrays(stream):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in (stream.src, stream.dst, stream.weight, stream.valid)]


@pytest.mark.parametrize("policy", ["sanitize", "off"])
@pytest.mark.parametrize("n_pad", [None, 9])
def test_from_numpy_matches_reference(policy, n_pad):
    src, dst, w = _dirty()
    want = _arrays(jcore.EdgeStream.from_numpy(src, dst, w, n_pad=n_pad, policy=policy))
    got = _arrays(EdgeStream.from_numpy(src, dst, w, n_pad=n_pad, policy=policy, device="cpu"))
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_from_numpy_strict_reports_same_problems():
    src, dst, w = _dirty()
    with pytest.raises(jguard.StreamValidationError) as want:
        jcore.EdgeStream.from_numpy(src, dst, w)
    with pytest.raises(guard.StreamValidationError) as got:
        EdgeStream.from_numpy(src, dst, w, device="cpu")
    assert [(p.kind, p.count, p.indices) for p in got.value.problems] == [
        (p.kind, p.count, p.indices) for p in want.value.problems
    ]
    assert str(got.value) == str(want.value)


def test_from_numpy_rejects_bad_lengths_and_pad():
    with pytest.raises(ValueError, match="lengths differ"):
        EdgeStream.from_numpy([0, 1], [1], [1.0, 2.0], device="cpu")
    with pytest.raises(ValueError, match="pad"):
        EdgeStream.from_numpy([0, 1], [1, 2], [1.0, 2.0], n_pad=1, device="cpu")
    with pytest.raises(ValueError, match="policy"):
        EdgeStream.from_numpy([0], [1], [1.0], policy="lenient", device="cpu")


def test_matching_result_storage():
    bits = torch.from_numpy(np.random.default_rng(0).random((6, 13)) < 0.5)
    packed = torch.from_numpy(np.array(jcore.pack_bits(jnp.asarray(bits.numpy()))))
    with pytest.raises(ValueError, match="L is required"):
        MatchingResult(torch.zeros(3, dtype=torch.int32), mb_packed=packed)
    with pytest.raises(ValueError, match="needs mb or mb_packed"):
        MatchingResult(torch.zeros(3, dtype=torch.int32))
    r = MatchingResult(torch.zeros(3, dtype=torch.int32), mb_packed=packed, L=13)
    assert r.is_packed and r.L == 13
    assert torch.equal(r.mb, bits) and r.packed() is packed
    r2 = r.with_assigned(torch.ones(3, dtype=torch.int32))
    assert r2.mb_packed is packed and r2.L == 13 and int(r2.assigned[0]) == 1
    dense = MatchingResult(torch.zeros(3, dtype=torch.int32), mb=bits)
    assert dense.L == 13 and not dense.is_packed
    assert torch.equal(dense.packed(), packed)
    with pytest.raises(AttributeError):
        r.assigned = None


def test_config_thresholds():
    cfg = SubstreamConfig(n=4, L=8, eps=0.25)
    thr = cfg.thresholds()
    assert thr.dtype == np.float32 and thr.shape == (8,) and not thr.flags.writeable
    assert thr is cfg.thresholds()  # computed once
    with pytest.raises(ValueError, match="thresholds shape"):
        SubstreamConfig(n=4, L=8, thresholds=np.ones(7, np.float32))


@pytest.mark.parametrize("bad", [[1.0, 2.0, 1.5, 3.0], [1.0, np.nan, 2.0, 3.0]])
def test_config_rejects_decreasing_thresholds(bad):
    """Eligibility is the prefix of passing thresholds (the mega kernel
    counts them), so the vector must be non-decreasing; ties are fine."""
    SubstreamConfig(n=4, L=4, thresholds=np.array([1.0, 1.0, 2.0, np.inf], np.float32))
    with pytest.raises(ValueError, match="non-decreasing"):
        SubstreamConfig(n=4, L=4, thresholds=np.array(bad, np.float32))


#: lanes where PyTorch's float32 (1.1)**i differs from the JAX package's
#: jitted vector at L=64 (measured on the CPU; see ROADMAP.md §3 item 1)
DIVERGENT_LANES = {32, 56}


def test_threshold_hazard_pinned():
    """The port's own thresholds differ from the reference's jitted vector
    at lanes 32 and 56; weights exactly on the reference's values land in
    other substreams there; with the reference's vector carried over,
    every result is identical."""
    n, L, eps = 8, 64, 0.1
    jcfg = jcore.SubstreamConfig(n=n, L=L, eps=eps)
    ref_thr = np.asarray(jax.jit(jcfg.thresholds)())
    own = SubstreamConfig(n=n, L=L, eps=eps)
    assert set(np.nonzero(own.thresholds() != ref_thr)[0].tolist()) == DIVERGENT_LANES
    # one vertex-disjoint edge per divergent lane, weight exactly on the
    # reference's threshold (and one on the port's, which both admit)
    lanes = sorted(DIVERGENT_LANES)
    w = np.array([ref_thr[i] for i in lanes] + [own.thresholds()[i] for i in lanes], np.float32)
    src = np.array([0, 2, 4, 6], np.int32)
    dst = np.array([1, 3, 5, 7], np.int32)
    js = jcore.EdgeStream.from_numpy(src, dst, w)
    want = np.asarray(jcore.mwm_scan(js, jcfg).assigned)
    np.testing.assert_array_equal(want, lanes + lanes)
    stream = stream_from_arrays(*(np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)), device="cpu")
    for run in (lambda c: mwm_scan(stream, c, device="cpu"),
                lambda c: substream_match(stream, c, device="cpu")):
        own_assigned = run(own).assigned.numpy()
        assert (own_assigned[:2] != want[:2]).all()  # landed one substream lower
        np.testing.assert_array_equal(own_assigned[2:], want[2:])
        carried = config_from_reference(n, L, eps, ref_thr)
        np.testing.assert_array_equal(run(carried).assigned.numpy(), want)
