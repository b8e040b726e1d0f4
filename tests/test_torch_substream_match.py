"""Port parity of Part 1: the kernel's entry point (its plain version on the
CPU), the dense and packed oracles and the CS-SEQ scan, held bit for bit
against the JAX package's pure-JAX oracles on the adversarial zoo and on
RMAT graphs. No tolerance: ``assigned`` and the bits are array-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.substream_match.ref import (
    substream_match_ref as jref,
    substream_match_ref_packed as jref_packed,
)
from repro_torch.convert import (
    config_from_reference,
    mb0_from_reference,
    result_to_numpy,
    stream_from_arrays,
)
from repro_torch.core import EdgeStream, mwm_scan
from repro_torch.kernels.substream_match import ref
from repro_torch.kernels.substream_match.ops import substream_match
from repro_torch.testing.cases import ZOO, rmat_case

CASES = {**ZOO,
         "rmat8": lambda: rmat_case(8, edge_factor=8, L=16, pad=3),
         "rmat10": lambda: rmat_case(10, edge_factor=4, L=64)}


def _pair(case):
    """The same inputs for both packages: the reference's stream and its
    jitted thresholds, carried into the port."""
    js = jcore.EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad)
    jcfg = jcore.SubstreamConfig(n=case.n, L=case.L, eps=case.eps)
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    return js, jcfg, thr, stream_from_arrays(*arrays, device="cpu"), config_from_reference(
        case.n, case.L, case.eps, thr)


def _masked_w(js):
    return jnp.where(js.valid, js.weight, 0.0)


def test_zoo_is_the_reference_harness_zoo():
    """The port's zoo cases build the very streams of the JAX harness."""
    import test_engine_differential as harness

    assert sorted(harness.ZOO) == sorted(ZOO)
    for name, fn in ZOO.items():
        want_stream, want_cfg = harness.ZOO[name]()
        case = fn()
        got = EdgeStream.from_numpy(case.src, case.dst, case.w, n_pad=case.m_pad, device="cpu")
        assert (case.n, case.L, case.eps) == (want_cfg.n, want_cfg.L, want_cfg.eps)
        for g, w in zip((got.src, got.dst, got.weight, got.valid),
                        (want_stream.src, want_stream.dst, want_stream.weight, want_stream.valid)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_substream_match_matches_packed_oracle(case):
    js, jcfg, thr, stream, cfg = _pair(CASES[case]())
    want_a, want_mb = jref_packed(js.src, js.dst, _masked_w(js), jnp.asarray(thr), jcfg.n)
    got_a, got_mb = result_to_numpy(substream_match(stream, cfg, device="cpu"))
    assert got_a.dtype == np.int32 and got_mb.dtype == np.uint8
    np.testing.assert_array_equal(got_a, np.asarray(want_a))
    np.testing.assert_array_equal(got_mb, np.asarray(want_mb))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_oracle_matches_reference(case):
    js, jcfg, thr, stream, cfg = _pair(CASES[case]())
    want_a, want_mb = jref(js.src, js.dst, _masked_w(js), jnp.asarray(thr), jcfg.n)
    w = torch.where(stream.valid, stream.weight, 0.0)
    got_a, got_mb = ref.substream_match_ref(stream.src, stream.dst, w, torch.tensor(thr), cfg.n)
    assert got_mb.dtype == torch.int8
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_mb.numpy(), np.asarray(want_mb))


@pytest.mark.parametrize("case", sorted(CASES))
def test_mwm_scan_matches_reference(case):
    js, jcfg, thr, stream, cfg = _pair(CASES[case]())
    want = jcore.mwm_scan(js, jcfg)
    got = mwm_scan(stream, cfg, device="cpu")
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))


@pytest.mark.parametrize("case", ["rmat8", "unaligned_n"])
def test_mb0_split_run_matches_reference(case):
    """A run in two halves, the second seeded with the first's bits, equals
    the reference's seeded oracles and the one-shot run."""
    js, jcfg, thr, stream, cfg = _pair(CASES[case]())
    m = stream.num_edges
    h = m // 2
    w = _masked_w(js)
    a1, mb1 = jref_packed(js.src[:h], js.dst[:h], w[:h], jnp.asarray(thr), jcfg.n)
    a2, mb2 = jref_packed(js.src[h:], js.dst[h:], w[h:], jnp.asarray(thr), jcfg.n, mb0=mb1)
    first = stream_from_arrays(*(x.numpy()[:h] for x in (stream.src, stream.dst, stream.weight, stream.valid)), device="cpu")
    second = stream_from_arrays(*(x.numpy()[h:] for x in (stream.src, stream.dst, stream.weight, stream.valid)), device="cpu")
    got1 = substream_match(first, cfg, device="cpu")
    got2 = substream_match(second, cfg, device="cpu", mb0=mb0_from_reference(np.asarray(mb1), device="cpu"))
    np.testing.assert_array_equal(got1.mb_packed.numpy(), np.asarray(mb1))
    np.testing.assert_array_equal(got2.assigned.numpy(), np.asarray(a2))
    np.testing.assert_array_equal(got2.mb_packed.numpy(), np.asarray(mb2))
    whole = substream_match(stream, cfg, device="cpu")
    np.testing.assert_array_equal(
        np.concatenate([got1.assigned.numpy(), got2.assigned.numpy()]), whole.assigned.numpy())
    np.testing.assert_array_equal(got2.mb_packed.numpy(), whole.mb_packed.numpy())
    # the dense oracle and the scan take the carried bits too
    mb1_dense = np.array(jcore.unpack_bits(mb1, cfg.L))
    want_scan = jcore.mwm_scan(jcore.EdgeStream(js.src[h:], js.dst[h:], js.weight[h:], js.valid[h:]),
                               jcfg, mb0=jnp.asarray(mb1_dense))
    got_scan = mwm_scan(second, cfg, mb0=torch.from_numpy(mb1_dense), device="cpu")
    np.testing.assert_array_equal(got_scan.assigned.numpy(), np.asarray(want_scan.assigned))
    np.testing.assert_array_equal(got_scan.mb.numpy(), np.asarray(want_scan.mb))
    want_d = jref(js.src[h:], js.dst[h:], w[h:], jnp.asarray(thr), jcfg.n, mb0=jnp.asarray(mb1_dense))
    got_d = ref.substream_match_ref(second.src, second.dst, torch.where(second.valid, second.weight, 0.0),
                                    torch.tensor(thr), cfg.n, mb0=torch.from_numpy(mb1_dense))
    np.testing.assert_array_equal(got_d[0].numpy(), np.asarray(want_d[0]))
    np.testing.assert_array_equal(got_d[1].numpy(), np.asarray(want_d[1]))


def test_n_zero_gives_empty_result():
    js, jcfg, thr, stream, cfg = _pair(CASES["empty"]())
    empty_cfg = config_from_reference(0, cfg.L, cfg.eps, thr)
    r = substream_match(stream, empty_cfg, device="cpu")
    assert r.mb_packed.shape == (0, 2) and r.assigned.shape == (0,)
    r = mwm_scan(stream, empty_cfg, device="cpu")
    assert r.mb.shape == (0, cfg.L)
