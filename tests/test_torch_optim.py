"""Port parity of the optimizer (``repro_torch.optim``): AdamW over three
steps on identical gradients, with clipping active and inactive, against
``repro.optim.adamw_update``; the state layout carried to and from the
reference's ``{m, v, count}``; the step's walk in slices of each leaf's
leading axis, bit-equal to one pass over the leaf; the LR schedules at
their phase boundaries; int8 compression, values on .5 included (both round half to
even), and error feedback.

Tolerances: parameters, moments and norms rtol 1e-4, atol 1e-6 (float32
updates; ``sqrt`` and ``pow`` may round differently); schedules rtol 1e-6
(one float32 ``exp``/``cos``); compression exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
from repro.models import gin as jgin
from repro_torch import convert, optim
from repro_torch.models import gin as tgin
from repro_torch.models.gin import GIN, GINConfig
from repro_torch.models.param import ArraySpec
from repro_torch.optim import adamw

STATE = dict(rtol=1e-4, atol=1e-6)


def _tree(rng):
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  rng.normal(size=(2, 2, 2)).astype(np.float32)]}


class _Params(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(tree["a"].copy()))
        self.b = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in tree["b"]])


@pytest.mark.parametrize("grad_scale, clip", [(0.01, 1.0), (10.0, 1.0), (10.0, 0.0), (1.0, 0.5)],
                         ids=["clip_inactive", "clip_active", "no_clip", "clip_half"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_three_steps_match_reference(grad_scale, clip, wd):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    cfg = jopt.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    tcfg = optim.AdamWConfig(lr=1e-2, weight_decay=wd, grad_clip=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.adamw_init(jp, cfg)
    module = _Params(params)
    opt = optim.AdamW(module.parameters(), tcfg)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda x: x * grad_scale, _tree(rng))
        jp, jstate, jnorm = jopt.adamw_update(jp, grads, jstate, cfg.lr, cfg)
        for (name, p), g in zip(module.named_parameters(), convert._flatten(grads).values()):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(jnorm), **STATE)
        got = convert.opt_state_to_reference(opt, module)
        assert int(got["count"]) == int(jstate["count"]) == step + 1
        assert got["count"].dtype == np.int32
        for key in ("m", "v"):
            want = convert._flatten(jax.tree_util.tree_map(np.asarray, jstate[key]))
            for k, v in convert._flatten(got[key]).items():
                np.testing.assert_allclose(v, want[k], err_msg=f"{key}.{k}", **STATE)
        want_p = convert._flatten(jax.tree_util.tree_map(np.asarray, jp))
        for k, v in convert._flatten(convert.params_to_reference(module)).items():
            np.testing.assert_allclose(v, want_p[k], err_msg=k, **STATE)


def test_opt_state_round_trip_through_the_reference():
    """A reference state loaded into the port comes back unchanged, and the
    next step from it equals the reference's next step."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    cfg = jopt.AdamWConfig(lr=3e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.adamw_init(jp, cfg)
    for _ in range(2):
        jp, jstate, _ = jopt.adamw_update(jp, _tree(rng), jstate, cfg.lr, cfg)
    module = _Params(jax.tree_util.tree_map(np.asarray, jp))
    opt = optim.AdamW(module.parameters(), optim.AdamWConfig(lr=3e-3))
    ref_state = jax.tree_util.tree_map(np.asarray, jstate)
    convert.opt_state_from_reference(opt, module, ref_state)
    back = convert.opt_state_to_reference(opt, module)
    for key in ("m", "v"):
        for k, v in convert._flatten(back[key]).items():
            np.testing.assert_array_equal(v, convert._flatten(ref_state[key])[k])
    assert int(back["count"]) == 2
    grads = _tree(rng)
    jp, jstate, jnorm = jopt.adamw_update(jp, grads, jstate, cfg.lr, cfg)
    for p, g in zip(module.parameters(), convert._flatten(grads).values()):
        p.grad = torch.from_numpy(g.copy())
    np.testing.assert_allclose(float(opt.step()), float(jnorm), **STATE)
    want_p = convert._flatten(jax.tree_util.tree_map(np.asarray, jp))
    for k, v in convert._flatten(convert.params_to_reference(module)).items():
        np.testing.assert_allclose(v, want_p[k], err_msg=k, **STATE)


def test_opt_state_from_reference_checks_shapes():
    module = _Params(_tree(np.random.default_rng(2)))
    opt = optim.AdamW(module.parameters())
    state = {"m": _tree(np.random.default_rng(3)), "v": _tree(np.random.default_rng(4)),
             "count": np.int32(1)}
    state["v"]["a"] = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.opt_state_from_reference(opt, module, state)


def test_adamw_first_step_matches_formula():
    """Bias-corrected first step without decay or clipping: -lr * g / |g|."""
    module = _Params({"a": np.asarray([[1.0, -2.0]], np.float32), "b": []})
    opt = optim.AdamW(module.parameters(), optim.AdamWConfig(
        lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, grad_clip=0.0))
    module.a.grad = torch.tensor([[0.5, 0.5]])
    assert float(opt.step()) == 0.0  # no clipping: no norm
    np.testing.assert_allclose(module.a.detach().numpy(),
                               [[1.0 - 0.1 * 0.5 / (0.5 + 1e-8), -2.0 - 0.1 * 0.5 / (0.5 + 1e-8)]],
                               rtol=1e-6)
    assert int(opt.count) == 1 and opt.count.dtype == torch.int32


def test_adamw_reduces_quadratic():
    w = torch.nn.Parameter(torch.ones(8) * 3)
    opt = optim.AdamW([w], optim.AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0))
    for _ in range(200):
        opt.zero_grad()
        (w ** 2).sum().backward()
        opt.step()
    assert float((w.detach() ** 2).sum()) < 0.05


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    g = _tree(np.random.default_rng(5))
    flat = [x * scale for x in convert._flatten(g).values()]
    want, wnorm = jopt.clip_by_global_norm([jnp.asarray(x) for x in flat], 1.0)
    got, norm = optim.clip_by_global_norm([torch.from_numpy(x) for x in flat], 1.0)
    np.testing.assert_allclose(float(norm), float(wnorm), **STATE)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **STATE)


def test_adamw_init_and_specs_match_reference():
    model = GIN(GINConfig(n_layers=2, d_hidden=4, d_in=3, n_classes=2), device="cpu")
    state = optim.adamw_init(dict(model.named_parameters()), optim.AdamWConfig())
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 0
    assert all(not m.any() and m.dtype == torch.float32 for m in state["m"].values())
    jspecs = jopt.adamw_init_specs(jgin.param_specs(jgin.GINConfig(
        n_layers=2, d_hidden=4, d_in=3, n_classes=2)), jopt.AdamWConfig())
    specs = optim.adamw_init_specs(tgin.param_specs(model.cfg), optim.AdamWConfig())
    flat = lambda t: {k: (v.shape, v.logical, v.init) for k, v in convert._flatten(t).items()}
    assert flat(specs) == flat(jspecs)
    assert isinstance(specs["count"], ArraySpec) and specs["count"].dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 40, 59, 60, 61, 62, 80, 99, 100, 101, 150])
def test_wsd_schedule_matches_reference(step):
    got = optim.wsd_schedule(step, 1.0, warmup=10, stable=50, decay=40)
    want = jopt.wsd_schedule(step, 1.0, warmup=10, stable=50, decay=40)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [0, 5, 9, 10, 11, 500, 999, 1000, 1001])
def test_cosine_schedule_matches_reference(step):
    got = optim.cosine_schedule(step, 2.0, 10, 1000, final_frac=0.05)
    want = jopt.cosine_schedule(step, 2.0, 10, 1000, final_frac=0.05)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def test_schedule_phases():
    lr = lambda s: float(optim.wsd_schedule(s, 1.0, warmup=10, stable=50, decay=40))
    assert lr(0) == 0 and abs(lr(10) - 1) < 1e-6 and abs(lr(40) - 1) < 1e-6
    assert lr(80) < lr(62) < 1.0 and abs(lr(100) - 0.1) < 1e-2
    assert float(optim.cosine_schedule(1000, 1.0, 10, 1000)) <= 0.11


@pytest.mark.parametrize("shape", [(33, 7), (256,), (1,), (3, 300)])
def test_compress_int8_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    q, scale, sh = optim.compress_int8(torch.from_numpy(x))
    jq, jscale, jsh = jopt.compress_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and sh == tuple(jsh)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = optim.decompress_int8(q, scale, sh)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jopt.decompress_int8(jq, jscale, jsh)))


def test_compress_int8_rounds_half_to_even():
    """A block whose largest magnitude is 127 has scale 1, so its values
    quantize to themselves rounded: .5 goes to the even neighbour."""
    x = np.zeros(256, np.float32)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]
    q, scale, _ = optim.compress_int8(torch.from_numpy(x))
    jq, jscale, _ = jopt.compress_int8(jnp.asarray(x))
    assert float(scale[0]) == 1.0
    assert q.numpy()[0, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, 127]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(7)
    grads = [rng.normal(size=(40, 9)).astype(np.float32) for _ in range(4)]
    res = optim.ErrorFeedback.init({"g": torch.zeros(40, 9)})["g"]
    jres = jopt.ErrorFeedback.init({"g": jnp.zeros((40, 9))})["g"]
    total = np.zeros((40, 9), np.float32)
    for g in grads:
        q, scale, shape, res = optim.ErrorFeedback.compress_with_feedback(torch.from_numpy(g), res)
        jq, jscale, jshape, jres = jopt.ErrorFeedback.compress_with_feedback(jnp.asarray(g), jres)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
        total += optim.decompress_int8(q, scale, shape).numpy()
    # the running sum of what was sent stays within one residual of the truth
    np.testing.assert_allclose(total + res.numpy(), np.sum(grads, axis=0), atol=1e-4)


def one_pass_step(params, state, count, lr, cfg):
    """``AdamW.step`` as one pass over each whole leaf (the port's step
    before it walked slices): clipped copies of every gradient, then each
    leaf's update. Returns the norm; updates ``params`` and ``state``."""
    grads = [p.grad for p in params]
    if cfg.grad_clip:
        sq = sum(torch.sum(torch.square(g.float())) for g in grads)
        gnorm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = [(g * scale).to(g.dtype) for g in grads]
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), count)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), count)
    with torch.no_grad():
        for p, g, st in zip(params, grads, state):
            g32, m32, v32, p32 = g.float(), st["m"].float(), st["v"].float(), p.float()
            m_new = cfg.b1 * m32 + (1 - cfg.b1) * g32
            v_new = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
            upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
            p.copy_((p32 - lr * (upd + cfg.weight_decay * p32)).to(p.dtype))
            st["m"] = m_new.to(cfg.moment_dtype)
            st["v"] = v_new.to(cfg.moment_dtype)
    return gnorm


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [0.5, 0.0], ids=["clip", "no_clip"])
def test_sliced_step_is_bit_equal_to_one_pass(monkeypatch, dtype, moments, clip):
    """Stacked leaves walked a few rows at a time (``SLICE_ELEMS`` 7: slices
    of one row, of several, a 1-d leaf in pieces) give the same bits as one
    pass over each leaf: parameters, moments and the norm, over three
    steps; the gradients in ``.grad`` are not changed."""
    monkeypatch.setattr(adamw, "SLICE_ELEMS", 7)
    cfg = optim.AdamWConfig(lr=1e-2, grad_clip=clip, moment_dtype=moments)
    g = torch.Generator().manual_seed(3)
    shapes = [(5, 4, 3), (9, 2), (13,), (3, 8)]
    ours = [torch.nn.Parameter(torch.randn(s, generator=g).to(dtype)) for s in shapes]
    ref = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    opt = optim.AdamW(ours, cfg)
    state = [{"m": torch.zeros(s, dtype=moments), "v": torch.zeros(s, dtype=moments)}
             for s in shapes]
    for step in range(1, 4):
        for a, b in zip(ours, ref):
            a.grad = (torch.randn(a.shape, generator=g) * 3).to(dtype)
            b.grad = a.grad.clone()
        norm = opt.step()
        want = one_pass_step(ref, state, torch.tensor(float(step)), cfg.lr, cfg)
        assert torch.equal(norm, want)
        for a, b, st in zip(ours, ref, state):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
            assert torch.equal(opt.state[a]["m"], st["m"])
            assert torch.equal(opt.state[a]["v"], st["v"])
