"""Port parity of the BERT4Rec training path (``models/bert4rec.py``'s
``loss_fn``, the recsys train kind of ``launch/steps.py::make_recsys_step``
and ``recsys_state_specs``): on the JAX package's weights at the smoke
config (``init_params(..., jax.random.key(0))``, carried across with
``convert.params_from_reference``) and the same ``RecsysPipeline`` batch,
the cloze loss under the sampled softmax, every gradient and one train step
(loss, gradient norm, moments, parameters) equal the reference's; rows read
outside the table (a label, a negative, a masked position) read NaN as
``jnp.take`` does, and the NaN pattern of every gradient is
``jax.grad``'s, its finite entries equal.

Tolerances: loss rtol 1e-5; gradients and moments within 1e-4 of each
leaf's largest magnitude (the second moment, quadratic, 2e-4); the gradient
norm rtol 1e-4; parameters within 2 * lr, and rtol 1e-5 where the gradient
is above 1e-2 of its leaf's largest (the first AdamW step is about lr *
sign(g)).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
import repro.launch.steps as jsteps
from repro.configs import get_arch as jget_arch
from repro.models import bert4rec as jb4r
from repro.models.param import init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init
from repro_torch import convert
from repro_torch.configs import get_arch, registry
from repro_torch.data import RecsysPipeline
from repro_torch.launch import steps
from repro_torch.models import bert4rec as b4r
from repro_torch.optim import AdamW, AdamWConfig

LOSS = dict(rtol=1e-5, atol=0)
GRAD_REL = 1e-4
B = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _reference():
    jcfg = jget_arch("bert4rec").smoke_config
    return jcfg, init_params(jb4r.param_specs(jcfg), jax.random.key(0))


def _port():
    jcfg, params = _reference()
    model = b4r.Bert4Rec(convert.bert4rec_config_from_reference(jcfg), device="cpu")
    return convert.params_from_reference(model, _np(params))


def _batch(seed=1, step=0, fault=None):
    """A ``RecsysPipeline`` batch as numpy; ``fault`` puts one id outside its
    table: a label, a negative or a masked position (and a -1 label, which
    wraps to the last row)."""
    jcfg, _ = _reference()
    pipe = RecsysPipeline(jcfg.item_vocab, B, jcfg.seq_len, jcfg.n_mask, jcfg.n_negatives,
                          jcfg.n_context, seed=seed, device="cpu")
    b = {k: v.numpy() for k, v in pipe.batch_at(step).items()}
    if fault == "label":
        b["labels"][1, 2] = jcfg.item_vocab + 3
        b["labels"][2, 0] = -1
    elif fault == "negative":
        b["negatives"][5] = jcfg.item_vocab
    elif fault == "mask_pos":
        b["mask_pos"][3, 1] = jcfg.seq_len
    return b


def _grads(model) -> dict:
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


def _assert_leaves_close(got: dict, want_tree, rel=GRAD_REL):
    """Each leaf: the same NaN entries, and the finite ones within ``rel`` of
    the leaf's largest finite magnitude."""
    want = convert._flatten(_np(want_tree))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(w), err_msg=k)
        fin = ~np.isnan(w)
        if fin.any():
            scale = max(float(np.abs(w[fin]).max()), 1e-30)
            err = float(np.abs(got[k][fin] - w[fin]).max()) / scale
            assert err <= rel, (k, err)


def test_loss_matches_reference():
    jcfg, params = _reference()
    b = _batch()
    want = jax.jit(lambda p, b: jb4r.loss_fn(p, b, jcfg))(params, b)
    with torch.no_grad():
        got = b4r.loss_fn(_port(), {k: _t(v) for k, v in b.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **LOSS)


@pytest.mark.parametrize("fault", [None, "label", "negative", "mask_pos"])
def test_gradients_match_reference(fault):
    """Every leaf's gradient against ``jax.grad``; with an id outside its
    table the loss is NaN on both sides, and each gradient has the
    reference's NaN entries (the row read outside takes no gradient)."""
    jcfg, params = _reference()
    b = _batch(fault=fault)
    loss, want = jax.jit(jax.value_and_grad(lambda p, b: jb4r.loss_fn(p, b, jcfg)))(params, b)
    model = _port()
    got = b4r.loss_fn(model, {k: _t(v) for k, v in b.items()})
    got.backward()
    if fault is None:
        np.testing.assert_allclose(got.item(), float(loss), **LOSS)
    else:
        assert np.isnan(got.item()) and np.isnan(float(loss))
    grads = _grads(model)
    _assert_leaves_close(grads, want)
    if fault == "label":  # one masked position of user 1 is NaN: its whole sequence
        assert np.isnan(grads["layers.0.wqkv"]).any() and not np.isnan(grads["items"]).all()


def test_take_along_positions_is_take_along_axis():
    """A negative position counts from the end, one outside [-S, S) reads NaN."""
    h = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    pos = np.array([[0, -1, 5], [-6, 4, 2]], np.int32)
    want = np.asarray(jax.numpy.take_along_axis(h, pos[..., None], axis=1))
    got = b4r.take_along_positions(_t(h), _t(pos)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _small_train():
    jcfg, params = _reference()
    jarch = dataclasses.replace(jget_arch("bert4rec"), config=jcfg)
    arch = dataclasses.replace(get_arch("bert4rec"), config=convert.bert4rec_config_from_reference(jcfg))
    return (arch, jarch, registry.ShapeSpec("small", "train", batch=B),
            jregistry.ShapeSpec("small", "train", batch=B), params)


def test_train_step_matches_reference():
    """One ``make_recsys_step`` train step against the reference's with the
    same ``AdamWConfig``, from the same weights and zero moments."""
    jopt, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    arch, jarch, shape, jshape, params = _small_train()
    b = _batch(seed=2)
    jstep = jax.jit(jsteps.make_recsys_step(jarch, jshape, jopt))
    new_params, state, out = jstep(params, adamw_init(params, jopt), b)
    model = _port()
    opt = AdamW(model.parameters(), AdamWConfig(lr=5.0))  # the step's opt_cfg.lr wins
    got = steps.make_recsys_step(arch, shape, opt_cfg, device="cpu")(
        model, opt, {k: _t(v) for k, v in b.items()})
    np.testing.assert_allclose(float(got["loss"]), float(out["loss"]), **LOSS)
    np.testing.assert_allclose(float(got["grad_norm"]), float(out["grad_norm"]), rtol=1e-4)
    ours = convert.opt_state_to_reference(opt, model)
    assert int(ours["count"]) == int(state["count"]) == 1
    for key, rel in (("m", GRAD_REL), ("v", 2 * GRAD_REL)):
        _assert_leaves_close(convert._flatten(ours[key]), state[key], rel=rel)
    m = convert._flatten(_np(state["m"]))
    for k, want in convert._flatten(_np(new_params)).items():
        got_p = dict(model.named_parameters())[k].detach().numpy()
        np.testing.assert_array_less(np.abs(got_p - want), 2 * opt_cfg.lr + 1e-6, err_msg=k)
        clear = np.abs(m[k]) > 1e-2 * np.abs(m[k]).max()
        np.testing.assert_allclose(got_p[clear], want[clear], rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_step_without_opt_cfg_takes_the_optimizer_lr():
    arch, _, shape, _, _ = _small_train()
    b = {k: _t(v) for k, v in _batch(seed=2).items()}
    runs = []
    for opt_cfg, opt_lr in ((AdamWConfig(lr=1e-3), 5.0), (None, 1e-3)):
        model = _port()
        step = steps.make_recsys_step(arch, shape, opt_cfg, device="cpu")
        step(model, AdamW(model.parameters(), AdamWConfig(lr=opt_lr)), b)
        runs.append(convert._flatten(convert.params_to_reference(model)))
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k])


def test_recsys_state_specs_match_reference():
    arch, ref = get_arch("bert4rec"), jget_arch("bert4rec")
    spec = lambda s: (tuple(s.shape), tuple(s.logical), str(s.dtype).split(".")[-1].strip("'>"))
    for ours, theirs in zip(steps.recsys_state_specs(arch, AdamWConfig()),
                            jsteps.recsys_state_specs(ref, JAdamWConfig())):
        assert {k: spec(v) for k, v in convert._flatten(ours).items()} == {
            k: spec(v) for k, v in convert._flatten(theirs).items()}
