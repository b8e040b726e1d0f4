"""Port parity of the LM training path (``repro_torch.models.transformer``'s
``loss_fn`` and backward, the LM half of ``launch/steps.py``'s training and
``launch/train_lm.py``): on the JAX package's weights at each smoke config
in float32 (carried across with ``convert.params_from_reference``, the RoPE
frequencies as the reference's jitted vector), ``loss_fn`` and every
gradient equal ``jtfm.loss_fn`` and ``jax.grad``'s, and one
``make_lm_train_step`` step equals the reference's (loss, gradient norm,
parameters and moments); chunked loss and remat change nothing; serving
records no graph; the MoE routing breaks ties as ``jax.lax.top_k`` does.

Tolerances: loss rtol 1e-5; gradients within 1e-4 of each leaf's largest
magnitude; the gradient norm rtol 1e-4. In the train step (another batch,
the shape's loss chunk and MoE groups) the first moment within 2e-4 of its
leaf's largest and the second (quadratic in the gradient) within 4e-4: at
internlm2's smoke config (a residual stream near 60) both packages'
float32 gradients are up to ~1e-4 from a float64 run, so they differ from
each other by about that much
(``test_train_step_moment_tolerance_is_float32_noise`` prints the three
errors). Parameters after the step: the first AdamW update is about lr *
sign(g), so an entry whose gradient is rounding noise may move the other
way: within 2 * lr of the reference, and equal where the gradient is
clear of the noise (|g| above 1e-2 of the leaf's largest, where its
error is under 1 %).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
import repro.launch.steps as jsteps
from repro.configs import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro.models.param import init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init
from repro_torch import convert
from repro_torch.configs import get_arch, registry
from repro_torch.launch import steps, train_lm
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamW, AdamWConfig

LM_IDS = ["internlm2-20b", "minicpm-2b", "gemma-7b", "moonshot-v1-16b-a3b", "grok-1-314b"]
B, S = 2, 32
LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def reference_freqs(d_head: int, theta: float) -> np.ndarray:
    half = d_head // 2
    return np.asarray(jax.jit(
        lambda: jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))())


@functools.lru_cache(maxsize=None)
def _reference(arch_id, overrides=()):
    jcfg = dataclasses.replace(jget_arch(arch_id).smoke_config,
                               **{"param_dtype": jnp.float32, **dict(overrides)})
    return jcfg, init_params(jtfm.param_specs(jcfg), jax.random.key(0))


def _port(jcfg, params):
    model = tfm.Transformer(convert.transformer_config_from_reference(jcfg), device="cpu")
    return convert.params_from_reference(
        model, _np(params), buffers={"rope_freqs": reference_freqs(jcfg.d_head, jcfg.rope_theta)})


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _grads(model) -> dict:
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assert_leaves_close(got: dict, want_tree, rel=GRAD_REL):
    want = convert._flatten(_np(want_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max()) / scale
        assert err <= rel, (k, err)


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch_id, tokens_seed=1):
    jcfg, params = _reference(arch_id)
    tokens = _tokens(jcfg.vocab, (B, S), tokens_seed)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jtfm.loss_fn(p, tokens, jcfg)))(params)
    return float(loss), _np(grads)


# --------------------------------------------------------------- loss, gradients


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_loss_matches_reference(arch_id):
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    want, _ = _reference_loss_and_grads(arch_id)
    with torch.no_grad():
        got = tfm.loss_fn(model, _t(_tokens(jcfg.vocab, (B, S))))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **LOSS)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_gradients_match_reference(arch_id):
    """Every leaf's gradient (the stacked layers written row by row, the
    router through the gate values only) against ``jax.grad``, remat on."""
    jcfg, params = _reference(arch_id)
    assert jcfg.remat
    model = _port(jcfg, params)
    want_loss, want = _reference_loss_and_grads(arch_id)
    loss = tfm.loss_fn(model, _t(_tokens(jcfg.vocab, (B, S))))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS)
    _assert_leaves_close(_grads(model), want)


@pytest.mark.parametrize("arch_id", ["minicpm-2b", "moonshot-v1-16b-a3b"])
def test_chunked_loss_and_remat_change_nothing(arch_id):
    """The counterparts of ``test_loss_unroll_equals_scan``: ``loss_chunk`` 8
    equals one chunk of S, and remat off equals remat on, loss and every
    gradient."""
    jcfg, params = _reference(arch_id)
    tokens = _t(_tokens(jcfg.vocab, (B, S)))
    runs = {}
    for name, kw in {"chunk8_remat": dict(loss_chunk=8, remat=True),
                     "one_chunk_remat": dict(loss_chunk=S, remat=True),
                     "chunk8_no_remat": dict(loss_chunk=8, remat=False)}.items():
        model = _port(jcfg, params)
        loss = tfm.loss_fn(model, tokens, dataclasses.replace(model.cfg, **kw))
        loss.backward()
        runs[name] = (loss.item(), _grads(model))
    base_loss, base = runs["chunk8_remat"]
    for name, (loss, grads) in runs.items():
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6, err_msg=name)
        for k, g in grads.items():
            np.testing.assert_allclose(g, base[k], rtol=1e-5, atol=1e-6 * np.abs(base[k]).max(),
                                       err_msg=f"{name} {k}")
    # remat does not change the values of the forward: bit for bit
    assert runs["chunk8_no_remat"][0] == base_loss


def test_loss_chunk_must_divide_the_sequence():
    jcfg, params = _reference("minicpm-2b")
    model = _port(jcfg, params)
    with pytest.raises(ValueError, match="loss_chunk"):
        tfm.loss_fn(model, _t(_tokens(jcfg.vocab, (B, 30))),
                    dataclasses.replace(model.cfg, loss_chunk=8))


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_backbone_backward_runs_and_keeps_the_forward(arch_id):
    """Fault B: ``backbone``'s backward runs (it raised on an in-place
    softmax), and its forward under autograd equals the in-place one under
    ``no_grad`` bit for bit, with remat and without."""
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    tokens = _t(_tokens(jcfg.vocab, (B, S + 5)))  # a ragged last attention chunk
    with torch.no_grad():
        want = tfm.backbone(model, tokens)
    for remat in (True, False):
        model.zero_grad(set_to_none=True)
        got = tfm.backbone(model, tokens, dataclasses.replace(model.cfg, remat=remat))
        assert got.requires_grad
        got.float().sum().backward()
        assert torch.equal(got.detach(), want)
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters() if p is not model.lm_head)


@pytest.mark.parametrize("arch_id", ["gemma-7b", "moonshot-v1-16b-a3b"])
def test_serving_records_no_graph(arch_id):
    """``prefill`` and ``decode_step`` are ``no_grad`` even where grad mode is
    on: nothing requires grad, and no parameter receives one."""
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    tokens = _t(_tokens(jcfg.vocab, (B, S + 1)))
    assert torch.is_grad_enabled()
    cache, last = tfm.prefill(model, tokens[:, :S], max_len=S + 1)
    logits, (k, v) = tfm.decode_step(model, cache, tokens[:, S], S)
    for t in (last, logits, k, v, cache["k"], cache["v"]):
        assert not t.requires_grad and t.grad_fn is None
    assert all(p.grad is None for p in model.parameters())


def test_matmul_f32_backward(monkeypatch):
    """The card's bf16 GEMM with float32 output records through
    ``_MatmulF32`` (its ``out_dtype`` form has no derivative). Its backward
    on the CPU, the forward GEMM replaced by the float32 product of the same
    bf16 values (it has no CPU kernel): each operand's gradient is the bf16
    product of the cotangent rounded to bf16, in bf16, and within bf16's
    rounding of float32 autograd's."""
    monkeypatch.setattr(tfm, "_bmm_f32", lambda a, b: torch.matmul(a.float(), b.float()))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 2, 5, 8, generator=g).to(torch.bfloat16).requires_grad_()
    b = torch.randn(3, 2, 8, 6, generator=g).to(torch.bfloat16).requires_grad_()
    cot = torch.randn(3, 2, 5, 6, generator=g)
    out = tfm._MatmulF32.apply(a, b)
    assert out.dtype == torch.float32
    (out * cot).sum().backward()
    c16 = cot.to(torch.bfloat16)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, torch.matmul(c16, b.detach().mT))
    assert torch.equal(b.grad, torch.matmul(a.detach().mT, c16))
    a32, b32 = a.detach().float().requires_grad_(), b.detach().float().requires_grad_()
    (torch.matmul(a32, b32) * cot).sum().backward()
    for got, want in ((a.grad, a32.grad), (b.grad, b32.grad)):
        assert float((got.float() - want).abs().max() / want.abs().max()) <= 2e-2


# --------------------------------------------------------------- MoE ties


def _moe_cfgs(**kw):
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
                vocab=257, attn_chunk=8, loss_chunk=16)
    jcfg = jtfm.TransformerConfig(**{**base, **kw}, param_dtype=jnp.float32)
    return jcfg, convert.transformer_config_from_reference(jcfg)


@pytest.mark.parametrize("kw", [
    dict(n_experts=4, top_k=2, moe_groups=1, capacity_factor=1.25),
    dict(n_experts=8, top_k=3, moe_groups=2, capacity_factor=1.25, act="geglu"),
], ids=["e4_top2", "e8_top3_groups2_geglu"])
def test_moe_ffn_breaks_router_ties_as_the_reference(kw):
    """Fault A: two equal router columns make every token's probabilities tie
    between those experts; ``jax.lax.top_k`` takes the lower expert first,
    which moves the capacity slots and the dropped pairs. Output and the
    gradients of x and of the router (through the gate values) equal the
    reference's."""
    jcfg, cfg = _moe_cfgs(**kw)
    p = init_params(jtfm.param_specs(jcfg), jax.random.key(5))
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), p["layers"])
    router = lp["router"].copy()
    router[:, 2] = router[:, 1]
    router[:, 0] = router[:, 1] * 1.0  # three tied columns: ties straddle the k-th place
    x = np.random.default_rng(5).normal(size=(64, jcfg.d_model)).astype(np.float32)

    def jfn(x, r):
        return jtfm._moe_ffn(x, r, lp["w1"], lp["w2"], jcfg)

    want = jfn(x, router)
    cot = np.random.default_rng(6).normal(size=want.shape).astype(np.float32)
    gx, gr = jax.grad(lambda x, r: jnp.sum(jfn(x, r) * cot), argnums=(0, 1))(x, router)
    tx, tr = _t(x).requires_grad_(), _t(router).requires_grad_()
    got = tfm._moe_ffn(tx, tr, _t(lp["w1"]), _t(lp["w2"]), cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    (got * _t(cot)).sum().backward()
    for name, g, w in (("x", tx.grad, gx), ("router", tr.grad, gr)):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max())
        assert err <= GRAD_REL, (name, err)
    # the tie is real: torch.topk's choice would route these tokens elsewhere
    probs = torch.softmax(tx.detach() @ tr.detach(), -1)
    assert (probs[:, 0] == probs[:, 1]).all()


# --------------------------------------------------------------- steps


def _small_train(arch_id, opt_cfg):
    jcfg, params = _reference(arch_id)
    jarch = dataclasses.replace(jget_arch(arch_id), config=jcfg)
    arch = dataclasses.replace(get_arch(arch_id),
                               config=convert.transformer_config_from_reference(jcfg))
    jshape = jregistry.ShapeSpec("small", "train", seq_len=S, global_batch=B)
    shape = registry.ShapeSpec("small", "train", seq_len=S, global_batch=B)
    return arch, jarch, shape, jshape, params


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_train_step_matches_reference(arch_id):
    """One ``make_lm_train_step`` step against the reference's at the shape's
    overrides (loss chunk 256, MoE groups = the batch) with the same
    ``AdamWConfig``, from the same weights and zero moments: loss, gradient
    norm, the moments and the parameters."""
    jopt, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    arch, jarch, shape, jshape, params = _small_train(arch_id, opt_cfg)
    tokens = _tokens(jarch.config.vocab, (B, S), seed=3)
    jstep = jax.jit(jsteps.make_lm_train_step(jarch, jshape, jopt))
    new_params, state, out = jstep(params, adamw_init(params, jopt), {"tokens": tokens})
    model = _port(jarch.config, params)
    opt = AdamW(model.parameters(), opt_cfg)
    got = steps.make_lm_train_step(arch, shape, opt_cfg, device="cpu")(
        model, opt, {"tokens": _t(tokens)})
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]), **LOSS)
    np.testing.assert_allclose(float(got["grad_norm"]), float(out["grad_norm"]), rtol=1e-4)
    ours = convert.opt_state_to_reference(opt, model)
    assert int(ours["count"]) == int(state["count"]) == 1
    for key, rel in (("m", 2 * GRAD_REL), ("v", 4 * GRAD_REL)):
        _assert_leaves_close(convert._flatten(ours[key]), state[key], rel=rel)
    m = convert._flatten(_np(state["m"]))
    before = convert._flatten(_np(params))
    for k, want in convert._flatten(_np(new_params)).items():
        got_p = dict(model.named_parameters())[k].detach().numpy()
        np.testing.assert_array_less(np.abs(got_p - want), 2 * opt_cfg.lr + 1e-6, err_msg=k)
        clear = np.abs(m[k]) > 1e-2 * np.abs(m[k]).max()
        np.testing.assert_allclose(got_p[clear], want[clear], rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.array_equal(got_p, before[k]) or not clear.any()


def test_train_step_moment_tolerance_is_float32_noise(monkeypatch, capsys):
    """The train-step test's moment tolerance (2e-4 of a leaf's largest) at
    internlm2's smoke config (a residual stream near 60), where the two
    packages' gradients differ the most: both float32 gradients are within
    1.5e-4 of the port's float64 gradient on the same inputs, so their gap
    is float32 rounding on either side, not a fault. Prints the largest
    errors (``-s``)."""
    jopt, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    arch, jarch, shape, jshape, params = _small_train("internlm2-20b", opt_cfg)
    tokens = _tokens(jarch.config.vocab, (B, S), seed=3)
    jcfg = jsteps._lm_shape_overrides(jarch.config, jshape)
    want = convert._flatten(_np(jax.jit(jax.grad(lambda p: jtfm.loss_fn(p, tokens, jcfg)))(params)))
    cfg = steps.lm_shape_config(arch, shape)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = _port(jarch.config, params).to(dtype)
        if dtype == torch.float64:  # float64 products throughout
            monkeypatch.setattr(tfm, "_matmul_f32", lambda a, b: torch.matmul(*tfm._promote(a, b)))
        tfm.loss_fn(model, _t(tokens), cfg).backward()
        grads[dtype] = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    rel = lambda a, b: max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in b)
    f64 = grads[torch.float64]
    port, ref = rel(grads[torch.float32], f64), rel({k: np.float64(v) for k, v in want.items()}, f64)
    gap = rel(grads[torch.float32], {k: np.float64(v) for k, v in want.items()})
    with capsys.disabled():
        print(f"internlm2 smoke gradients, largest error over the leaf's largest: port float32 "
              f"vs float64 {port:.3g}, reference float32 vs float64 {ref:.3g}, port vs reference {gap:.3g}")
    assert port <= 1.5e-4 and ref <= 1.5e-4 and gap <= port + ref


def test_lm_state_specs_match_reference():
    arch, ref = get_arch("minicpm-2b"), jget_arch("minicpm-2b")
    spec = lambda s: (tuple(s.shape), tuple(s.logical), str(s.dtype).split(".")[-1].strip("'>"))
    for ours, theirs in zip(steps.lm_state_specs(arch, AdamWConfig()),
                            jsteps.lm_state_specs(ref, JAdamWConfig())):
        assert {k: spec(v) for k, v in convert._flatten(ours).items()} == {
            k: spec(v) for k, v in convert._flatten(theirs).items()}


@pytest.mark.parametrize("arch_id", LM_IDS + ["bert4rec", "gin-tu"])
def test_default_opt_cfg_matches_reference(arch_id):
    """bf16 moments above 100 B parameters: grok-1-314b only."""
    got = steps.default_opt_cfg(get_arch(arch_id))
    want = jsteps.default_opt_cfg(jget_arch(arch_id))
    assert got.moment_dtype == (torch.bfloat16 if arch_id == "grok-1-314b" else torch.float32)
    assert str(want.moment_dtype).split(".")[-1].strip("'>") == str(got.moment_dtype).split(".")[-1]
    assert dataclasses.replace(got, moment_dtype=None) == dataclasses.replace(
        AdamWConfig(), moment_dtype=None)


# --------------------------------------------------------------- trainer


def test_train_lm_runs_saves_and_restores(tmp_path, capsys):
    """``python -m repro_torch.launch.train_lm`` on the CPU: 3 steps with a
    checkpoint every step (two kept), then a longer run that restarts from
    the newest one (step 2, taken again, as the reference example does)."""
    ckpt = str(tmp_path / "ck")
    assert train_lm.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", ckpt,
                          "--ckpt-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "step    0" in out and "step    2" in out and "[1, 2]" in out
    assert train_lm.main(["--steps", "4", "--device", "cpu", "--ckpt-dir", ckpt,
                          "--ckpt-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out and "step    3" in out and "[3, 4]" not in out
    assert "[2, 3]" in out
