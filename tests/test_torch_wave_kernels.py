"""Port parity of the wave path: ``substream_match(schedule="waves"|"mega")``
(the kernels' plain versions on the CPU), the plain wave engine
``mwm_waves`` and the pipeline routes through them, held bit for bit
against the JAX package's oracles (``mwm_scan``, ``mwm_waves``, the packed
reference) on the adversarial zoo and on RMAT graphs. No tolerance:
``assigned`` and the bits are array-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.graph import waves as jwaves
from repro.kernels.substream_match.ref import substream_match_ref_packed as jref_packed
from repro_torch.convert import (
    config_from_reference,
    mb0_from_reference,
    result_to_numpy,
    schedule_from_reference,
    stream_from_arrays,
)
from repro_torch.core import mwm_pipeline, mwm_waves
from repro_torch.graph import waves
from repro_torch.kernels.substream_match import kernel
from repro_torch.kernels.substream_match.ops import (
    MEGA_SEG_BLOCK,
    mega_inputs,
    mega_plan,
    substream_match,
    wave_plan,
    waves_inputs,
)
from repro_torch.testing.cases import ZOO, rmat_case

CASES = {**ZOO,
         "rmat10_L13": lambda: rmat_case(10, edge_factor=4, L=13, pad=3),
         "rmat10_L64": lambda: rmat_case(10, edge_factor=4, L=64),
         "rmat10_L300": lambda: rmat_case(10, edge_factor=4, L=300, eps=0.01, seed=1),
         "rmat12_L64": lambda: rmat_case(12, edge_factor=4, L=64, seed=2),
         "rmat8_L2048": lambda: rmat_case(8, edge_factor=4, L=2048, eps=0.002, seed=3)}
ENGINES = [("waves", None), ("mega", 1), ("mega", 2), ("mega", 4)]
FIELDS = ("wave", "order", "offsets", "slots", "seg_offsets")


def _pair(case):
    """The same inputs for both packages: the reference's stream and its
    jitted thresholds, carried into the port."""
    c = CASES[case]()
    js = jcore.EdgeStream.from_numpy(c.src, c.dst, c.w, n_pad=c.m_pad)
    jcfg = jcore.SubstreamConfig(n=c.n, L=c.L, eps=c.eps)
    thr = np.asarray(jax.jit(jcfg.thresholds)())
    arrays = [np.asarray(x) for x in (js.src, js.dst, js.weight, js.valid)]
    return js, jcfg, thr, stream_from_arrays(*arrays, device="cpu"), config_from_reference(
        c.n, c.L, c.eps, thr)


def _reference_packed(js, jcfg):
    want = jcore.mwm_scan(js, jcfg)
    return np.asarray(want.assigned), np.asarray(jcore.pack_bits(want.mb))


@pytest.mark.parametrize("schedule, seg_block", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_wave_engines_match_scan(case, schedule, seg_block):
    js, jcfg, _, stream, cfg = _pair(case)
    want_a, want_mb = _reference_packed(js, jcfg)
    got = substream_match(stream, cfg, device="cpu", schedule=schedule, seg_block=seg_block)
    got_a, got_mb = result_to_numpy(got)
    assert got_a.dtype == np.int32 and got_mb.dtype == np.uint8
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_array_equal(got_mb, want_mb)


@pytest.mark.parametrize("schedule", ["waves", "mega"])
@pytest.mark.parametrize("case", ["dense_small", "unaligned_L", "rmat10_L13"])
def test_wave_engines_on_a_reference_schedule(case, schedule):
    """Both packages on one schedule (capped width, built by the reference):
    the port's engines match the reference's waves_xla engine on it."""
    js, jcfg, _, stream, cfg = _pair(case)
    src, dst, valid = (np.asarray(x) for x in (js.src, js.dst, js.valid))
    jsch = jwaves.wave_schedule(src, dst, valid=valid, max_width=5)
    sch = schedule_from_reference(*(getattr(jsch, f) for f in FIELDS))
    want = jcore.mwm_waves(js, jcfg, schedule=jsch)
    got = substream_match(stream, cfg, device="cpu", schedule=schedule, waves=sch)
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
    capped = substream_match(stream, cfg, device="cpu", schedule=schedule, max_width=5)
    np.testing.assert_array_equal(capped.assigned.numpy(), np.asarray(want.assigned))


@pytest.mark.parametrize("schedule, seg_block", ENGINES)
@pytest.mark.parametrize("case", ["unaligned_n", "rmat10_L64"])
def test_mb0_split_run_matches_reference(case, schedule, seg_block):
    """A run in two halves, the second seeded with the reference's bits
    after the first, equals the reference's seeded packed oracle."""
    js, jcfg, thr, stream, cfg = _pair(case)
    h = stream.num_edges // 2
    w = jnp.where(js.valid, js.weight, 0.0)
    _, mb1 = jref_packed(js.src[:h], js.dst[:h], w[:h], jnp.asarray(thr), jcfg.n)
    a2, mb2 = jref_packed(js.src[h:], js.dst[h:], w[h:], jnp.asarray(thr), jcfg.n, mb0=mb1)
    parts = [x.numpy() for x in (stream.src, stream.dst, stream.weight, stream.valid)]
    first = stream_from_arrays(*(p[:h] for p in parts), device="cpu")
    second = stream_from_arrays(*(p[h:] for p in parts), device="cpu")
    kw = dict(device="cpu", schedule=schedule, seg_block=seg_block)
    got1 = substream_match(first, cfg, **kw)
    np.testing.assert_array_equal(got1.mb_packed.numpy(), np.asarray(mb1))
    got2 = substream_match(second, cfg, mb0=mb0_from_reference(np.asarray(mb1), device="cpu"), **kw)
    np.testing.assert_array_equal(got2.assigned.numpy(), np.asarray(a2))
    np.testing.assert_array_equal(got2.mb_packed.numpy(), np.asarray(mb2))


@pytest.mark.parametrize("max_width", [None, 4])
@pytest.mark.parametrize("case", ["self_loops", "star", "bipartite", "rmat10_L64"])
def test_mwm_waves_matches_reference(case, max_width):
    js, jcfg, _, stream, cfg = _pair(case)
    want = jcore.mwm_waves(js, jcfg, max_width=max_width)
    got = mwm_waves(stream, cfg, max_width=max_width, device="cpu")
    np.testing.assert_array_equal(got.assigned.numpy(), np.asarray(want.assigned))
    np.testing.assert_array_equal(got.mb.numpy(), np.asarray(want.mb))
    # seeded with the first run's bits: the reference's seeded scan
    want2 = jcore.mwm_scan(js, jcfg, mb0=want.mb)
    got2 = mwm_waves(stream, cfg, mb0=got.mb, device="cpu")
    np.testing.assert_array_equal(got2.assigned.numpy(), np.asarray(want2.assigned))
    np.testing.assert_array_equal(got2.mb.numpy(), np.asarray(want2.mb))


@pytest.mark.parametrize("part1, kw, ref_part1", [
    ("waves", {}, "waves"),
    ("kernel", {"schedule": "waves"}, "blocked"),
    ("kernel", {"schedule": "mega"}, "blocked"),
    ("kernel", {"schedule": "mega", "seg_block": 4}, "blocked"),
])
@pytest.mark.parametrize("case", ["bipartite", "unaligned_n", "dense_small", "rmat10_L64"])
def test_pipeline_wave_routes_match_reference(case, part1, kw, ref_part1):
    js, jcfg, _, stream, cfg = _pair(case)
    want_idx, want_w = jcore.mwm_pipeline(js, jcfg, part1=ref_part1)
    idx, weight = mwm_pipeline(stream, cfg, part1=part1, device="cpu", **kw)
    np.testing.assert_array_equal(idx, want_idx)
    assert weight == want_w  # float32 sums over the same indices: rtol 0


def test_plans_keep_the_reference_geometry():
    """The H100 plans keep the TPU plans' schedule geometry (and drop the
    VMEM grid picks); errors name the knob that must change."""
    c = rmat_case(10, edge_factor=4, L=64)
    sch = waves.wave_schedule(c.src, c.dst)
    plan = wave_plan(c.n, c.L, sch)
    assert (plan.seg, plan.num_waves, plan.num_segments) == (8, sch.num_waves, sch.num_segments)
    assert (plan.n_pad, plan.width, plan.words, plan.rows) == (1024, 8, 8, 1024 + 8)
    assert plan.fill == sch.fill and plan.fits_l2 and plan.seg_block == 0
    layout = waves.block_aligned_layout(sch, MEGA_SEG_BLOCK)
    mplan = mega_plan(c.n, c.L, layout)
    assert (mplan.seg_block, mplan.num_tiles, mplan.num_segments) == (
        2, layout.num_tiles, layout.num_segments)
    assert mplan.fill == layout.fill <= plan.fill
    with pytest.raises(ValueError, match="mb0"):
        wave_plan(c.n, c.L, sch, free_bytes=2**10)


def test_wave_kernel_wrappers_check_operands():
    c = CASES["dense_small"]()
    stream = stream_from_arrays(c.src.astype(np.int32), c.dst.astype(np.int32),
                                c.w.astype(np.float32), np.ones(c.src.size, bool), device="cpu")
    cfg = config_from_reference(c.n, c.L, c.eps, (1.0 + c.eps) ** np.arange(c.L, dtype=np.float32))
    sch = waves.wave_schedule(c.src, c.dst)
    (uv, w, thr, offs, n_pad, seg, sb, mb_init), _ = mega_inputs(stream, cfg, sch, 2)
    kernel.substream_match_mega(uv, w, thr, offs, n_pad, seg, sb)  # CPU: plain version
    with pytest.raises(ValueError, match="non-decreasing"):
        kernel.substream_match_mega(uv, w, thr.flip(0).contiguous(), offs, n_pad, seg, sb)
    with pytest.raises(ValueError, match="multiples of 4"):
        kernel.substream_match_mega(uv, w, thr, offs, n_pad, seg, 4)
    with pytest.raises(ValueError, match="outside"):
        kernel.substream_match_mega(uv + 1, w, thr, offs, n_pad, seg, sb)
    with pytest.raises(ValueError, match="mb_init"):
        kernel.substream_match_mega(uv, w, thr, offs, n_pad, seg, sb,
                                    mb_init=torch.zeros((n_pad, 8), dtype=torch.uint8))
    (edges, w, thr, offs, n_pad, seg, _), _ = waves_inputs(stream, cfg, sch)
    kernel.substream_match_waves(edges, w, thr, offs, n_pad, seg)
    with pytest.raises(ValueError, match="start at 0"):
        kernel.substream_match_waves(edges, w, thr, offs[1:].contiguous(), n_pad, seg)
    with pytest.raises(ValueError, match="slots"):
        kernel.substream_match_waves(edges, w, thr, torch.cat([offs[:-1], offs[-1:] + 1]), n_pad, seg)
    with pytest.raises(ValueError, match="edges"):
        kernel.substream_match_waves(edges.long(), w, thr, offs, n_pad, seg)
