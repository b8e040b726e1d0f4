"""Port parity of the LM serving path (``repro_torch.models.transformer``,
the five LM configs and the LM half of ``launch/steps.py``): on the JAX
package's weights (``init_params(..., jax.random.key(0))`` at each smoke
config in float32, carried across with ``convert.params_from_reference``,
the RoPE frequencies as the reference's jitted vector), ``backbone``,
``prefill`` (cache and last hidden), ``decode_step`` (logits and new k/v),
the attention variants, the MoE dispatch and the prefill and decode steps
equal the reference's; configs, parameter counts, shape overrides and spec
trees are exact.

Tolerance: rtol 1e-5, atol 1e-4. The smoke weights are random: the residual
stream of grok's and internlm2's smoke configs reaches |x| ~ 60 and their
attention scores ~1e2, where one float32 ulp of a score moves the softmax
by ~1e-5 relative; their hidden states (|h| <= 5) differ from the
reference's by up to 7.3e-5, and the reference's own jitted and eager
layer differ by 3.6e-5 on the same input. bfloat16: gemma's stream is
float32 in the reference (its embedding scale is a numpy float64), and the
port's is too: within 1e-4 of the largest magnitude; the other archs stay
bfloat16, within 5e-2 of it (a few bf16 roundings, eps 3.9e-3, through two
layers).
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
from repro.models.param import count_params as jcount_params
from repro.models.param import init_params
from repro_torch import convert
from repro_torch.configs import get_arch, registry
from repro_torch.launch import steps
from repro_torch.models import param
from repro_torch.models import transformer as tfm

TOL = dict(rtol=1e-5, atol=1e-4)
LM_IDS = ["internlm2-20b", "minicpm-2b", "gemma-7b", "moonshot-v1-16b-a3b", "grok-1-314b"]
B, S = 2, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(a):
    return np.asarray(a).astype(np.float32)


def reference_freqs(d_head: int, theta: float) -> np.ndarray:
    """The reference's RoPE frequencies (``transformer.py:168``) as its
    jitted functions compute them."""
    half = d_head // 2
    return np.asarray(jax.jit(
        lambda: jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))())


@functools.lru_cache(maxsize=None)
def _reference(arch_id, overrides=()):
    """(reference config, params) at the smoke config in float32."""
    jcfg = dataclasses.replace(jget_arch(arch_id).smoke_config,
                               **{"param_dtype": jnp.float32, **dict(overrides)})
    return jcfg, init_params(jtfm.param_specs(jcfg), jax.random.key(0))


def _port(jcfg, params):
    cfg = convert.transformer_config_from_reference(jcfg)
    model = tfm.Transformer(cfg, device="cpu")
    return convert.params_from_reference(
        model, _np(params), buffers={"rope_freqs": reference_freqs(jcfg.d_head, jcfg.rope_theta)})


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- models


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_backbone_matches_reference(arch_id):
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    tokens = _tokens(jcfg.vocab, (B, S + 5))  # 37 tokens: a ragged last chunk of 5
    want = jax.jit(lambda p, t: jtfm.backbone(p, t, jcfg))(params, tokens)
    with torch.no_grad():
        got = tfm.backbone(model, _t(tokens))
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_prefill_matches_reference(arch_id):
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    tokens = _tokens(jcfg.vocab, (B, S))
    jcache, jlast = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(params, tokens)
    cache, last = tfm.prefill(model, _t(tokens))
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), _f32(jcache[name]), **TOL)
    np.testing.assert_allclose(last.numpy(), _f32(jlast), **TOL)


@pytest.mark.parametrize("cache_len", [S, S - 5])
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_decode_step_matches_reference(arch_id, cache_len):
    """On the reference's cache of S slots: logits and the new k/v, with every
    slot filled and with the last five masked."""
    jcfg, params = _reference(arch_id)
    model = _port(jcfg, params)
    tokens = _tokens(jcfg.vocab, (B, S + 1))
    jcache, _ = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(params, tokens[:, :S])
    jlogits, (jk, jv) = jax.jit(lambda p, c, t: jtfm.decode_step(
        p, c, t, jnp.int32(cache_len), jcfg))(params, jcache, tokens[:, S])
    cache = {k: _t(v) for k, v in _np(jcache).items()}
    logits, (k, v) = tfm.decode_step(model, cache, _t(tokens[:, S]), cache_len)
    assert logits.dtype == torch.float32 and logits.shape == (B, jcfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), _f32(jlogits), **TOL)
    np.testing.assert_allclose(k.numpy(), _f32(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), _f32(jv), **TOL)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_prefill_then_decode_equals_backbone(arch_id):
    """The reference's own contract (``test_arch_smoke.py``), on the port:
    prefill + one decode step == the full forward at the next position
    (capacity 8: no MoE token dropped either way)."""
    jcfg, params = _reference(arch_id, (("capacity_factor", 8.0),))
    model = _port(jcfg, params)
    cfg = model.cfg
    tokens = _t(_tokens(jcfg.vocab, (B, S + 1)))
    cache, _ = tfm.prefill(model, tokens[:, :S])
    logits_d, _ = tfm.decode_step(model, cache, tokens[:, S], S)
    with torch.no_grad():
        logits_f = tfm.lm_logits(model, tfm.backbone(model, tokens)[:, S], cfg)
    np.testing.assert_allclose(logits_d.numpy(), logits_f.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("max_len", [S + 1, S + 16])
def test_prefill_max_len_pads_with_zeros(max_len):
    """A longer cache holds the reference's cache in slots [0, S) and zeros past it."""
    jcfg, params = _reference("internlm2-20b")
    model = _port(jcfg, params)
    tokens = _tokens(jcfg.vocab, (B, S))
    jcache, jlast = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(params, tokens)
    cache, last = tfm.prefill(model, _t(tokens), max_len=max_len)
    for name in ("k", "v"):
        want = np.pad(_f32(jcache[name]), ((0, 0), (0, 0), (0, max_len - S), (0, 0), (0, 0)))
        assert cache[name].shape == want.shape
        np.testing.assert_allclose(cache[name].numpy(), want, **TOL)
        assert not cache[name][:, :, S:].any()
    np.testing.assert_allclose(last.numpy(), _f32(jlast), **TOL)
    with pytest.raises(ValueError, match="max_len"):
        tfm.prefill(model, _t(tokens), max_len=S - 1)


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_bfloat16_follows_the_reference_promotion(arch_id):
    """At ``param_dtype`` bfloat16: gemma's stream is float32 (its numpy
    float64 embedding scale promotes it in the reference), so its logits
    agree to float32 rounding; the other archs compute in bfloat16."""
    jcfg, params = _reference(arch_id, (("param_dtype", jnp.bfloat16),))
    model = _port(jcfg, params)
    assert model.embed.dtype == torch.bfloat16
    tokens = _tokens(jcfg.vocab, (B, S + 1))
    jcache, _ = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg))(params, tokens[:, :S])
    jlogits, _ = jax.jit(lambda p, c, t: jtfm.decode_step(
        p, c, t, jnp.int32(S), jcfg))(params, jcache, tokens[:, S])
    cache, _ = tfm.prefill(model, _t(tokens[:, :S]))
    logits, _ = tfm.decode_step(model, cache, _t(tokens[:, S]), S)
    want = _f32(jlogits)
    err = np.abs(logits.numpy() - want).max() / np.abs(want).max()
    assert err <= (1e-4 if jcfg.embed_scale else 5e-2), err


# --------------------------------------------------------------- internals

BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
            vocab=257, attn_chunk=8, loss_chunk=16)


def _base(**kw):
    jcfg = jtfm.TransformerConfig(**{**BASE, **kw}, param_dtype=jnp.float32)
    return jcfg, convert.transformer_config_from_reference(jcfg)


@pytest.mark.parametrize("seq,par,chunk,unroll", [
    (32, 1, 8, False), (32, 1, 8, True), (32, 2, 4, False), (32, 4, 8, True), (32, 8, 4, False),
    (37, 1, 8, False), (37, 2, 4, False), (13, 4, 4, False), (5, 1, 8, False),
])
def test_attention_variants_match_reference(seq, par, chunk, unroll):
    """The variants of ``test_transformer_internals.py`` and ragged lengths
    (the reference runs those as one chunk; the port as a short last one)."""
    jcfg, cfg = _base(attn_chunk=chunk, attn_par=par, unroll=unroll)
    Hq, Hk, D = 4, 2, 16
    rng = np.random.default_rng(seq * 100 + par * 10 + chunk)
    q, k, v = (rng.normal(size=(2, seq, h, D)).astype(np.float32) for h in (Hq, Hk, Hk))
    want = jtfm.attention(q, k, v, jcfg)
    got = tfm.attention(_t(q), _t(k), _t(v), cfg)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5, atol=1e-5)


def _moe_inputs(jcfg, seed, T=64):
    params = init_params(jtfm.param_specs(jcfg), jax.random.key(seed))
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), params["layers"])
    x = np.random.default_rng(seed).normal(size=(T, jcfg.d_model)).astype(np.float32)
    return x, lp


@pytest.mark.parametrize("kw", [
    dict(n_experts=4, top_k=2, moe_groups=4, capacity_factor=1.0),
    dict(n_experts=4, top_k=2, moe_groups=1, capacity_factor=1.25),
    dict(n_experts=2, top_k=2, moe_groups=1, capacity_factor=0.25),
    dict(n_experts=8, top_k=3, moe_groups=2, capacity_factor=1.25, act="geglu"),
    dict(n_experts=4, top_k=2, moe_groups=2, capacity_factor=1.25, expert_fold=2, act="geglu"),
], ids=["groups4", "groups1", "drops", "top3_geglu", "fold2"])
def test_moe_ffn_matches_reference(kw):
    """Capacity dispatch in token order, the overflow row, groups and folds
    (routing ties: none occur at these random float32 probabilities; a tie
    would show as a large mismatch here)."""
    jcfg, cfg = _base(**kw)
    x, lp = _moe_inputs(jcfg, seed=5)
    want = jtfm._moe_ffn(x, lp["router"], lp["w1"], lp["w2"], jcfg)
    got = tfm._moe_ffn(_t(x), _t(lp["router"]), _t(lp["w1"]), _t(lp["w2"]), cfg)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-5, atol=1e-5)
    if kw["capacity_factor"] < 1:  # tiny capacity: some token rows are exactly zero
        assert (got.abs().sum(1) == 0).any()


def test_moe_expert_fold_equivalence():
    """fold=2 with block-partitioned weights == fold=1 (the reference's test, on the port)."""
    E, d, ff = 4, 32, 48
    _, cfg1 = _base(d_model=d, d_ff=ff, n_experts=E, top_k=2, act="swiglu", moe_groups=2)
    cfg2 = dataclasses.replace(cfg1, expert_fold=2)
    g = torch.Generator().manual_seed(4)
    router = torch.randn(d, E, generator=g)
    w1 = torch.randn(E, d, 2 * ff, generator=g) * 0.1
    w2 = torch.randn(E, ff, d, generator=g) * 0.1
    x = torch.randn(16, d, generator=g)
    out1 = tfm._moe_ffn(x, router, w1, w2, cfg1)
    gate, up = torch.chunk(w1, 2, dim=-1)
    gs, us = torch.chunk(gate, 2, dim=-1), torch.chunk(up, 2, dim=-1)
    w1f = torch.stack([torch.cat([gs[f], us[f]], -1) for f in range(2)], dim=1).reshape(E * 2, d, ff)
    w2f = torch.stack(torch.chunk(w2, 2, dim=1), dim=1).reshape(E * 2, ff // 2, d)
    out2 = tfm._moe_ffn(x, router, w1f, w2f, cfg2)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


@pytest.mark.parametrize("fn", ["rmsnorm", "rope", "swiglu", "geglu", "gelu"])
def test_layer_functions_match_reference(fn):
    """rmsnorm, rope (on the reference's jitted frequencies) and the three
    activations (jax's ``gelu`` is the tanh approximation)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    if fn == "rmsnorm":
        scale = rng.normal(size=16).astype(np.float32)
        want, got = jtfm.rmsnorm(x, scale, 1e-5), tfm.rmsnorm(_t(x), _t(scale), 1e-5)
    elif fn == "rope":
        pos = np.arange(7)[None] * 5
        want = jtfm.rope(x, pos, 10000.0)
        got = tfm.rope(_t(x), _t(pos), _t(reference_freqs(16, 10000.0)))
    else:
        want, got = jtfm._activate(x, fn), tfm._activate(_t(x), fn)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- RoPE hazard

#: lanes where torch's float32 ``exp`` differs from the reference's jitted
#: vector (jax 0.9.0 on the CPU), and where the reference's eager vector does
RAW_LANES = {
    (1e4, 256): [14, 26, 33, 56, 70, 84, 89, 91, 92, 101, 108, 112, 122],
    (1e6, 128): [11, 28, 36, 49, 53, 63],
    (1e4, 64): [11],
}
EAGER_LANES = {(1e4, 256): [119], (1e6, 128): [], (1e4, 64): [11, 14, 21, 23, 27, 28]}


@pytest.mark.parametrize("theta,d_head", sorted(RAW_LANES))
def test_rope_hazard_pinned(theta, d_head):
    """The port's own frequencies differ from the reference's jitted vector
    in the recorded lanes (one ulp each; at position 32,768 an ulp moves the
    angle by up to ~1e-3 rad); the reference's eager vector differs from its
    jitted one too. Given the jitted vector, the port holds it bit for bit."""
    half = d_head // 2
    jitted = reference_freqs(d_head, theta)
    eager = np.asarray(jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))
    own = tfm.rope_freqs(d_head, theta).numpy()
    assert np.nonzero(own != jitted)[0].tolist() == RAW_LANES[(theta, d_head)]
    assert np.nonzero(eager != jitted)[0].tolist() == EAGER_LANES[(theta, d_head)]
    ulps = np.abs(own.view(np.int32) - jitted.view(np.int32))
    assert ulps.max() == 1
    jcfg = jtfm.TransformerConfig(name="r", n_layers=1, d_model=16, n_heads=1, n_kv=1,
                                  d_head=d_head, d_ff=16, vocab=256, rope_theta=theta,
                                  param_dtype=jnp.float32)
    model = tfm.Transformer(convert.transformer_config_from_reference(jcfg), device="cpu")
    assert np.array_equal(model.rope_freqs.numpy(), own)
    convert.params_from_reference(model, _np(init_params(jtfm.param_specs(jcfg), jax.random.key(0))),
                                  buffers={"rope_freqs": jitted})
    assert model.rope_freqs.numpy().view(np.int32).tolist() == jitted.view(np.int32).tolist()


def test_params_from_reference_refuses_a_wrong_buffer():
    jcfg, params = _reference("gemma-7b")
    model = tfm.Transformer(convert.transformer_config_from_reference(jcfg), device="cpu")
    with pytest.raises(ValueError, match="no buffer"):
        convert.params_from_reference(model, _np(params), buffers={"freqs": np.zeros(8, np.float32)})
    with pytest.raises(ValueError, match="float32"):
        convert.params_from_reference(model, _np(params), buffers={"rope_freqs": np.zeros(8)})
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_reference(model, _np(params),
                                      buffers={"rope_freqs": np.zeros(3, np.float32)})


# --------------------------------------------------------------- configs, steps


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for k in ("param_dtype", "dtype"):
        if k in out:
            out[k] = str(out[k]).split(".")[-1].strip("'>")
    return out


def _spec(s):
    return (tuple(s.shape), tuple(s.logical), str(s.dtype).split(".")[-1].strip("'>"),
            s.init, s.scale)


def _flat_specs(tree):
    return {k: _spec(v) for k, v in convert._flatten(tree).items()}


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_config_matches_reference(arch_id):
    """The arch's fields, published and smoke configs field by field,
    parameter counts, the parameter spec tree and its count."""
    arch, ref = get_arch(arch_id), jget_arch(arch_id)
    for f in dataclasses.fields(ref):
        got, want = getattr(arch, f.name), getattr(ref, f.name)
        if f.name in ("config", "smoke_config"):
            assert _fields(got) == _fields(want), f.name
            assert got == convert.transformer_config_from_reference(want)
            assert got.param_count() == want.param_count()
            assert got.active_param_count() == want.active_param_count()
            assert (got.vocab_padded, got.is_moe, got.ff_mult) == (
                want.vocab_padded, want.is_moe, want.ff_mult)
            ours, theirs = _flat_specs(tfm.param_specs(got)), _flat_specs(jtfm.param_specs(want))
            assert {k: v[:4] for k, v in ours.items()} == {k: v[:4] for k, v in theirs.items()}
            assert {k for k in ours if ours[k] != theirs[k]} == ATTN_LEAVES
            assert param.count_params(tfm.param_specs(got)) == jcount_params(jtfm.param_specs(want))
        elif f.name == "shapes":
            assert got is registry.LM_SHAPES
        else:
            assert got == want, f.name
    assert _fields(arch.config)["param_dtype"] == "bfloat16"


@pytest.mark.parametrize("shape_name", sorted(registry.LM_SHAPES))
@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_shape_config_and_inputs_match_reference(arch_id, shape_name):
    arch, ref = get_arch(arch_id), jget_arch(arch_id)
    shape, jshape = arch.shapes[shape_name], ref.shapes[shape_name]
    got = steps.lm_shape_config(arch, shape)
    want = jsteps._lm_shape_overrides(ref.config, jshape)
    assert _fields(got) == _fields(want)
    assert _flat_specs(steps.lm_input_specs(arch, shape)) == _flat_specs(
        jsteps.lm_input_specs(ref, jshape))
    cache = _flat_specs(tfm.kv_cache_specs(arch.config, 3, 17))
    assert cache == _flat_specs(jtfm.kv_cache_specs(ref.config, 3, 17))


ATTN_LEAVES = {"layers.wq", "layers.wk", "layers.wv", "layers.wo"}


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_attention_init_uses_the_true_fan_in(arch_id):
    """A fault of the reference's init, not copied (ROADMAP.md §3): its
    default fan-in is ``shape[-2]``, for the head-major ``wq``/``wk``/``wv``
    [L, d, H, Dh] the head count and for ``wo`` [L, H, Dh, d] the head width,
    so q and k come out sqrt(d / H) too wide (13.9x at gemma-7b's width) and
    the scores' standard deviation near 190 there. The port draws the four
    at fan-in d and H * Dh; every other leaf as the reference."""
    cfg = get_arch(arch_id).config
    d, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    specs = convert._flatten(tfm.param_specs(cfg))
    jspecs = convert._flatten(jtfm.param_specs(jget_arch(arch_id).config))
    want = {"layers.wq": d, "layers.wk": d, "layers.wv": d, "layers.wo": H * Dh}
    ref_fan_in = {"layers.wq": H, "layers.wk": Kv, "layers.wv": Kv, "layers.wo": Dh}
    for name, fan_in in want.items():
        assert specs[name].scale == pytest.approx(1 / np.sqrt(fan_in))
        assert jspecs[name].scale is None and jspecs[name].shape[-2] == ref_fan_in[name]
    # on the smoke config: the reference's wq draws are wider by sqrt(d / H)
    jcfg, params = _reference(arch_id)
    model = tfm.Transformer(convert.transformer_config_from_reference(jcfg), device="cpu", seed=0)
    ratio = float(np.std(np.asarray(params["layers"]["wq"]))) / float(model.layers.wq.detach().std())
    assert ratio == pytest.approx(np.sqrt(jcfg.d_model / jcfg.n_heads), rel=0.1)


def test_full_config_param_counts():
    """The reference's published scales (``test_arch_smoke.py``), and gemma-7b's
    KV cache bytes per token (28 layers x 16 kv heads x 256 x k, v x 2 B)."""
    expect = {"internlm2-20b": (17e9, 23e9), "minicpm-2b": (2.2e9, 3.3e9),
              "gemma-7b": (8e9, 10e9), "grok-1-314b": (290e9, 340e9)}
    for arch_id, (lo, hi) in expect.items():
        assert lo < get_arch(arch_id).config.param_count() < hi
    moon = get_arch("moonshot-v1-16b-a3b").config
    assert moon.active_param_count() < 0.25 * moon.param_count()
    g = get_arch("gemma-7b").config
    assert g.param_count() == 9_324_112_896
    assert 2 * g.n_layers * g.n_kv * g.d_head * 2 == 458_752


def _small(arch_id, kind, seq_len):
    """(port arch, reference arch, port shape, reference shape) at the smoke
    config in float32 and a shape of ``seq_len`` tokens, batch B."""
    jcfg, params = _reference(arch_id)
    jarch = dataclasses.replace(jget_arch(arch_id), config=jcfg)
    arch = dataclasses.replace(get_arch(arch_id), config=convert.transformer_config_from_reference(jcfg))
    jshape = jregistry.ShapeSpec("small", kind, seq_len=seq_len, global_batch=B)
    shape = registry.ShapeSpec("small", kind, seq_len=seq_len, global_batch=B)
    return arch, jarch, shape, jshape, params


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_prefill_and_decode_steps_match_reference(arch_id):
    """``make_lm_prefill`` (cache, last logits) and ``make_lm_decode`` (logits,
    the cache with the new k/v committed at S - 1) against the reference's
    steps, at the shape's overrides (MoE groups = the batch)."""
    arch, jarch, shape, jshape, params = _small(arch_id, "prefill", S)
    model = _port(jarch.config, params)
    tokens = _tokens(jarch.config.vocab, (B, S))
    jcache, jlogits = jax.jit(jsteps.make_lm_prefill(jarch, jshape))(params, {"tokens": tokens})
    cache, logits = steps.make_lm_prefill(arch, shape, device="cpu")(model, {"tokens": _t(tokens)})
    np.testing.assert_allclose(logits.numpy(), _f32(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), _f32(jcache[name]), **TOL)

    arch, jarch, shape, jshape, _ = _small(arch_id, "decode", S)
    token = _tokens(jarch.config.vocab, (B,), seed=2)
    jcache = {k: v for k, v in _np(jcache).items()}
    jlogits, jnew = jax.jit(jsteps.make_lm_decode(jarch, jshape))(
        params, {"cache": jcache, "token": token})
    cache = {k: _t(v) for k, v in jcache.items()}
    k_before = cache["k"]
    logits, new = steps.make_lm_decode(arch, shape, device="cpu")(
        model, {"cache": cache, "token": _t(token)})
    assert new is cache and new["k"] is k_before  # committed in place
    np.testing.assert_allclose(logits.numpy(), _f32(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(new[name].numpy(), _f32(jnew[name]), **TOL)


def test_transformer_state_dict_is_the_reference_tree():
    jcfg, params = _reference("moonshot-v1-16b-a3b")
    model = _port(jcfg, params)
    assert set(dict(model.named_parameters())) == set(convert._flatten(_np(params)))
    back = convert.params_to_reference(model)
    for k, v in convert._flatten(_np(params)).items():
        np.testing.assert_array_equal(convert._flatten(back)[k], v)
    assert model.layers.wq.shape[0] == jcfg.n_layers  # stacked leaves
