"""Port parity of the unpacked int8 layout: ``substream_match(packed=False)``
through the three schedules (the kernels' plain versions on the CPU), held
bit for bit against the JAX package's dense oracle
(``repro.kernels.substream_match.ref.substream_match_ref``) and its CS-SEQ
scan, and against the port's packed layout, on the adversarial zoo and on
RMAT graphs at L in {8, 13, 64, 300}. No tolerance: ``assigned`` and the
dense bits ``mb`` are array-equal."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.kernels.substream_match.ref import substream_match_ref as jref
from repro_torch.convert import (
    config_from_reference,
    mb0_from_reference,
    result_to_numpy,
    stream_from_arrays,
)
from repro_torch.core import EdgeStream, SubstreamConfig, mwm_pipeline
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    L2_BYTES,
    device_plan,
    kernel_inputs,
    mega_inputs,
    resolve_stream_schedule,
    substream_match,
    waves_inputs,
)
from repro_torch.testing.cases import ZOO, rmat_case

CASES = {**ZOO}
for _scale, _ef in ((8, 8), (10, 4)):
    for _L, _eps in ((8, 0.1), (13, 0.1), (64, 0.1), (300, 0.01)):
        CASES[f"rmat{_scale}_L{_L}"] = functools.partial(
            rmat_case, _scale, edge_factor=_ef, L=_L, eps=_eps, pad=3, seed=_L)
SCHEDULES = ["edges", "waves", "mega"]


@functools.lru_cache(maxsize=None)
def _pair(case):
    """The same inputs for both packages: the reference's stream and its
    jitted thresholds, carried into the port (unpacked config)."""
    c = CASES[case]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=c.L, eps=c.eps, mb_layout="unpacked")
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    return js, jcfg, thr, stream_from_arrays(*arrays, device="cpu"), config_from_reference(
        c.n, c.L, c.eps, thr, mb_layout="unpacked")


def _masked_w(js):
    return jnp.where(js.valid, js.weight, 0.0)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(assigned, dense bits) of the dense oracle, and of the scan."""
    js, jcfg, thr, _, _ = _pair(case)
    a, mb = jref(js.src, js.dst, _masked_w(js), jnp.asarray(thr), jcfg.n)
    scan = jcore.mwm_scan(js, jcfg)
    return ((np.asarray(a), np.asarray(mb).astype(bool)),
            (np.asarray(scan.assigned), np.asarray(scan.mb)))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_unpacked_matches_dense_oracle_and_scan(case, schedule):
    _, _, _, stream, cfg = _pair(case)
    (ref_a, ref_mb), (scan_a, scan_mb) = _reference(case)
    got = substream_match(stream, cfg, device="cpu", schedule=schedule)
    assert not got.is_packed  # cfg.mb_layout="unpacked" picks the layout
    got_a, got_mb = result_to_numpy(got)
    assert got_a.dtype == np.int32 and got_mb.dtype == np.bool_
    np.testing.assert_array_equal(got_a, ref_a)
    np.testing.assert_array_equal(got_mb, ref_mb)
    np.testing.assert_array_equal(got_a, scan_a)
    np.testing.assert_array_equal(got_mb, scan_mb)
    packed = substream_match(stream, cfg, device="cpu", schedule=schedule, packed=True)
    assert packed.is_packed
    np.testing.assert_array_equal(packed.assigned.numpy(), got_a)
    np.testing.assert_array_equal(packed.mb.numpy(), got_mb)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("case", ["unaligned_n", "rmat8_L13", "rmat10_L300"])
def test_unpacked_split_run_carries_bool_mb0(case, schedule):
    """A run in two halves, the second seeded with the first's bool bits,
    equals the reference's seeded dense oracle and the one-shot run."""
    js, jcfg, thr, stream, cfg = _pair(case)
    h = stream.num_edges // 2
    w = _masked_w(js)
    a1, mb1 = jref(js.src[:h], js.dst[:h], w[:h], jnp.asarray(thr), jcfg.n)
    a2, mb2 = jref(js.src[h:], js.dst[h:], w[h:], jnp.asarray(thr), jcfg.n, mb0=mb1)
    halves = [stream_from_arrays(*(t.numpy()[sl] for t in (stream.src, stream.dst, stream.weight,
                                                             stream.valid)), device="cpu")
              for sl in (slice(0, h), slice(h, None))]
    mb0 = mb0_from_reference(np.asarray(mb1).astype(bool), device="cpu")
    assert mb0.dtype == torch.bool
    got1 = substream_match(halves[0], cfg, device="cpu", schedule=schedule)
    got2 = substream_match(halves[1], cfg, mb0=mb0, device="cpu", schedule=schedule)
    np.testing.assert_array_equal(got1.assigned.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(got1.mb.numpy(), np.asarray(mb1).astype(bool))
    np.testing.assert_array_equal(got2.assigned.numpy(), np.asarray(a2))
    np.testing.assert_array_equal(got2.mb.numpy(), np.asarray(mb2).astype(bool))
    whole = substream_match(stream, cfg, device="cpu", schedule=schedule)
    np.testing.assert_array_equal(
        np.concatenate([got1.assigned.numpy(), got2.assigned.numpy()]), whole.assigned.numpy())
    np.testing.assert_array_equal(got2.mb.numpy(), whole.mb.numpy())


@pytest.mark.parametrize("case", ["bipartite", "unaligned_L", "rmat8_L64"])
def test_unpacked_pipeline_matches_reference(case):
    """``mwm_pipeline(part1="kernel", packed=False)`` gives the JAX package's
    blocked-order pipeline, and the packed pipeline's matching."""
    js, jcfg, _, stream, cfg = _pair(case)
    want_idx, want_w = jcore.mwm_pipeline(js, jcfg, part1="blocked")
    for kw in ({"packed": False}, {"packed": False, "schedule": "mega"}, {"packed": True}):
        idx, weight = mwm_pipeline(stream, cfg, part1="kernel", device="cpu", **kw)
        np.testing.assert_array_equal(idx, np.asarray(want_idx))
        assert weight == float(want_w)


def test_unpacked_plans():
    plan = device_plan(2**20, 64, packed=False)  # the paper's configuration
    assert (plan.n_pad, plan.width, plan.words, plan.nbytes) == (2**20, 64, 64, 64 * 2**20)
    assert not plan.fits_l2 and plan.nbytes > L2_BYTES and not plan.packed
    assert device_plan(2**20, 64).fits_l2  # the packed block, 8 MiB
    for L, width in ((1, 16), (8, 16), (13, 16), (16, 16), (300, 304), (2048, 2048)):
        assert device_plan(257, L, packed=False).width == width
        assert device_plan(257, L, packed=False).words == L


@pytest.mark.parametrize("case", ["dense_small", "rmat8_L300"])
def test_unpacked_operands_follow_the_tpu_contracts(case):
    """[1, L_pad] threshold lanes (+inf pads) for the per-edge and segment
    kernels, the flat sorted [L_pad] vector for mega, int8 blocks."""
    _, _, thr, stream, cfg = _pair(case)
    L_pad = device_plan(cfg.n, cfg.L, packed=False).width
    mb0 = torch.zeros((cfg.n, cfg.L), dtype=torch.bool)
    mb0[0, 0] = True
    edges, w, t, n_pad, mb_init = kernel_inputs(stream, cfg, mb0, packed=False)
    assert t.shape == (1, L_pad) and torch.isinf(t[0, cfg.L:]).all()
    np.testing.assert_array_equal(t[0, : cfg.L].numpy(), thr)
    assert mb_init.dtype == torch.int8 and mb_init.shape == (n_pad, L_pad)
    assert int(mb_init.sum()) == 1
    sch = resolve_stream_schedule(stream)
    args, _ = waves_inputs(stream, cfg, sch, mb0, packed=False)
    assert args[2].shape == (1, L_pad)
    assert args[6].shape == (n_pad + kernel.SACRIFICIAL_ROWS, L_pad) and args[6].dtype == torch.int8
    args, _ = mega_inputs(stream, cfg, sch, None, mb0, packed=False)
    assert args[2].shape == (L_pad,) and args[7].dtype == torch.int8
    np.testing.assert_array_equal(args[2][: cfg.L].numpy(), thr)
    with pytest.raises(ValueError, match="mb0 shape"):
        kernel_inputs(stream, cfg, mb0[:, :-1], packed=False)


def test_unpacked_wrappers_check_operands():
    edges = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32)
    w = torch.tensor([2.0, 3.0])
    thr = torch.full((1, 16), float("inf"))
    thr[0, 0] = 1.0
    assigned, mb = kernel.substream_match_unpacked(edges, w, thr, 8)  # CPU: plain version
    assert assigned.tolist() == [0, -1] and mb.dtype == torch.int8 and mb.shape == (8, 16)
    assert mb[:3, 0].tolist() == [1, 1, 0]
    # a non-zero byte of the carried block is a set bit, and comes back as 1
    carried = torch.zeros((8, 16), dtype=torch.int8)
    carried[1, 0] = 5
    assigned, mb = kernel.substream_match_unpacked(edges, w, thr, 8, mb_init=carried)
    assert assigned.tolist() == [-1, -1] and mb[1, 0] == 1
    with pytest.raises(ValueError, match="thresholds"):
        kernel.substream_match_unpacked(edges, w, torch.ones((8, 2)), 8)
    with pytest.raises(ValueError, match="mb_init"):
        kernel.substream_match_unpacked(edges, w, thr, 8, mb_init=carried.to(torch.uint8))
    with pytest.raises(ValueError, match="outside"):
        kernel.substream_match_unpacked(edges, w, thr, 2)
    offs = torch.tensor([0, 1], dtype=torch.int32)
    slots = torch.tensor([[0, 1]] + [[8, 8]] * 7, dtype=torch.int32)
    sw = torch.tensor([2.0] + [0.0] * 7)
    with pytest.raises(ValueError, match="mb_init"):
        kernel.substream_match_waves(slots, sw, thr, offs, 8, 8,
                                     torch.zeros((8, 16), dtype=torch.int8), False)
    with pytest.raises(ValueError, match="thresholds"):
        kernel.substream_match_waves(slots, sw, thr, offs, 8, 8, None, True)
    a, mb = kernel.substream_match_waves(slots, sw, thr, offs, 8, 8, None, False)
    assert a.tolist() == [0] + [-1] * 7 and mb.shape == (8, 16) and mb.dtype == torch.int8
    uv = slots.T.reshape(-1).contiguous()
    a, mb = kernel.substream_match_mega(uv, sw, thr[0].contiguous(), offs, 8, 8, 1, None, False)
    assert a.tolist() == [0] + [-1] * 7 and mb.dtype == torch.int8


def test_unpacked_empty_vertex_space():
    _, _, thr, stream, cfg = _pair("empty")
    empty_cfg = config_from_reference(0, cfg.L, cfg.eps, thr, mb_layout="unpacked")
    for schedule in SCHEDULES:
        r = substream_match(stream, empty_cfg, device="cpu", schedule=schedule)
        assert not r.is_packed and r.mb.shape == (0, cfg.L) and r.mb.dtype == torch.bool
        assert r.assigned.shape == (0,)


def test_config_layout_is_checked():
    assert SubstreamConfig(n=3, L=8, mb_layout="unpacked").mb_layout == "unpacked"
    with pytest.raises(ValueError, match="mb_layout"):
        SubstreamConfig(n=3, L=8, mb_layout="dense")
    stream = EdgeStream.from_numpy([0], [1], [2.0], device="cpu")
    r = substream_match(stream, SubstreamConfig(n=2, L=8), device="cpu", packed=False)
    assert not r.is_packed and r.assigned.tolist() == [7]
