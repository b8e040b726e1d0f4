"""Port parity of the four GNNs (``repro_torch.models``): on the JAX
package's weights (``init_params(..., jax.random.key(0))``, carried across
with ``convert.params_from_reference``) and the same batch
(``make_gnn_batch``, the batch of ``test_arch_smoke.py``), the forward
pass, the loss and every gradient equal ``jax.value_and_grad`` of the
reference; the invariances of ``test_models_equivariance.py``; and the
Equiformer-v2 chunked and ``src_blocked`` modes, with the reference's
``src_blocked`` fault pinned.

Tolerances: forward and loss rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
atol 1e-6 (float32 through a few layers, summed in another order; a
gradient adds a backward pass of rounding). The invariance tests keep the
reference's tolerances.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn_common as jcommon
from repro.configs import get_arch as jget_arch
from repro.data.pipeline import make_gnn_batch as jmake_gnn_batch
from repro.models import equiformer_v2 as jeqv2
from repro.models.param import count_params as jcount_params
from repro.models.param import init_params
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import make_gnn_batch
from repro_torch.models import egnn, equiformer_v2, gin, gnn_common, param

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
GNN_IDS = ["gin-tu", "egnn", "meshgraphnet", "equiformer-v2"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _modules(arch_id):
    arch = get_arch(arch_id)
    return (importlib.import_module(f"repro.models.{arch.gnn_model}"),
            importlib.import_module(f"repro_torch.models.{arch.gnn_model}"))


def _batch_kwargs(arch_id, cfg, **kw):
    return dict(n_classes=cfg.n_classes if arch_id == "gin-tu" else 0,
                d_out=getattr(cfg, "d_out", 1), coords=True, seed=1, **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch_id, overrides=()):
    """The reference's params, loss, grads and forward at the smoke config
    (with ``overrides``) on the smoke batch, as numpy."""
    jmod, _ = _modules(arch_id)
    cfg = dataclasses.replace(jget_arch(arch_id).smoke_config, **dict(overrides))
    params = init_params(jmod.param_specs(cfg), jax.random.key(0))
    batch = jmake_gnn_batch(48, 160, cfg.d_in, **_batch_kwargs(arch_id, cfg))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jmod.loss_fn(p, batch, cfg)))(params)
    out = jax.jit(lambda p: jmod.forward(p, batch, cfg))(params)
    return _np(params), float(loss), convert._flatten(_np(grads)), _np(out)


def _port(arch_id, overrides=(), params=None):
    _, tmod = _modules(arch_id)
    cfg = dataclasses.replace(get_arch(arch_id).smoke_config, **dict(overrides))
    model = tmod.MODEL(cfg, device="cpu")
    if params is not None:
        convert.params_from_reference(model, params)
    batch = make_gnn_batch(48, 160, cfg.d_in, **_batch_kwargs(arch_id, cfg), device="cpu")
    return model, batch


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
            for n, p in model.named_parameters()}


def _assert_loss_and_grads(arch_id, overrides=()):
    params, loss, grads, _ = _reference(arch_id, overrides)
    model, batch = _port(arch_id, overrides, params)
    got = model.loss_fn(batch)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, **FWD)
    mine = _grads(model)
    assert set(mine) == set(grads)
    for name in sorted(grads):
        np.testing.assert_allclose(mine[name], grads[name], err_msg=name, **GRAD)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_forward_matches_reference(arch_id):
    params, _, _, out = _reference(arch_id)
    model, batch = _port(arch_id, params=params)
    with torch.no_grad():
        got = model(batch)
    if arch_id == "egnn":  # (node outputs, updated coordinates)
        for g, w in zip(got, out):
            np.testing.assert_allclose(g.numpy(), w, **FWD)
    else:
        assert got.shape == out.shape == (48, out.shape[1])
        np.testing.assert_allclose(got.numpy(), out, **FWD)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_loss_and_grads_match_reference(arch_id):
    _assert_loss_and_grads(arch_id)


@pytest.mark.parametrize("arch_id", ["gin-tu", "egnn", "meshgraphnet"])
def test_edge_chunked_matches_reference(arch_id):
    """Chunked message passing (160 edges in 5 chunks of 32)."""
    _assert_loss_and_grads(arch_id, (("edge_chunk", 32),))


@pytest.mark.parametrize("overrides", [
    (("edge_chunk", 32),),
    (("edge_chunk", 40), ("src_blocked", True)),  # 4 chunks, N = 48: blocks of 12
    (("edge_chunk", 80), ("src_blocked", True)),  # 2 chunks: blocks of 24
    (("edge_chunk", 32), ("n_heads", 3), ("m_max", 1)),
], ids=["chunked", "src_blocked_4", "src_blocked_2", "heads3_mmax1"])
def test_equiformer_modes_match_reference(overrides):
    """Equiformer-v2 with ``edge_chunk`` > 0, and ``src_blocked`` where N is
    a multiple of the number of chunks (the modes agree there)."""
    _assert_loss_and_grads("equiformer-v2", overrides)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_state_dict_keys_are_the_reference_tree(arch_id):
    """The module's parameters are the reference's leaves under their tree
    paths, with their shapes; the round trip gives the tree back."""
    params, _, _, _ = _reference(arch_id)
    model, _ = _port(arch_id, params=params)
    flat = convert._flatten(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = [".".join(str(k.key if hasattr(k, "key") else k.idx) for k in path)
             for path, _ in leaves]
    assert sorted(name for name, _ in model.named_parameters()) == sorted(paths)
    back = convert._flatten(convert.params_to_reference(model))
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    jmod, tmod = _modules(arch_id)
    cfg = get_arch(arch_id).smoke_config
    assert param.count_params(tmod.param_specs(cfg)) == jcount_params(
        jmod.param_specs(jget_arch(arch_id).smoke_config))


def test_params_from_reference_checks_keys_and_shapes():
    params, _, _, _ = _reference("gin-tu")
    model, _ = _port("gin-tu")
    missing = {k: v for k, v in params.items() if k != "eps"}
    with pytest.raises(ValueError, match="eps"):
        convert.params_from_reference(model, missing)
    bad = dict(params, eps=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_reference(model, bad)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_init_follows_the_reference_distributions(arch_id):
    """zeros, ones, and N(0, 1) / sqrt(fan_in); one seed gives one model."""
    _, tmod = _modules(arch_id)
    cfg = get_arch(arch_id).config  # the published width: enough draws for the moments
    specs = tmod.param_specs(cfg)
    model = tmod.MODEL(cfg, device="cpu", seed=3)
    again = tmod.MODEL(cfg, device="cpu", seed=3)
    for path, spec in param.iter_specs(specs):
        p = model.get_parameter(path).detach()
        assert p.dtype == spec.dtype and tuple(p.shape) == spec.shape
        assert torch.equal(p, again.get_parameter(path))
        if spec.init == "zeros":
            assert not p.any()
        elif spec.init == "ones":
            assert bool((p == 1).all())
        elif p.numel() >= 4096:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            z = p.double() * np.sqrt(fan_in)
            assert abs(float(z.mean())) < 5 / np.sqrt(p.numel())
            assert abs(float(z.std()) - 1) < 0.05


@pytest.mark.parametrize("layernorm", [False, True])
@pytest.mark.parametrize("dims", [(5, 7), (5, 7, 3), (6, 4, 4, 2)])
def test_mlp_apply_matches_reference(dims, layernorm):
    rng = np.random.default_rng(len(dims))
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32)
        p[f"b{i}"] = rng.normal(size=(dims[i + 1],)).astype(np.float32)
    x = rng.normal(size=(9, dims[0])).astype(np.float32)
    want = jcommon.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                             layernorm=layernorm)
    mlp = param.materialize(torch.nn.Module(), gnn_common.mlp_specs(dims), "cpu")
    convert.params_from_reference(mlp, p)
    with torch.no_grad():
        got = gnn_common.mlp_apply(mlp, torch.from_numpy(x), layernorm=layernorm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    specs = gnn_common.mlp_specs(dims, final_zeros=True)
    want_specs = jcommon.mlp_specs(dims, final_zeros=True)
    assert {k: (s.shape, s.init) for k, s in specs.items()} == {
        k: (s.shape, s.init) for k, s in want_specs.items()}


@pytest.mark.parametrize("chunk", [0, 16, 64])
def test_chunked_edge_aggregate_matches_reference(chunk):
    rng = np.random.default_rng(chunk)
    n, e, d = 20, 64, 5
    h = rng.normal(size=(n, d)).astype(np.float32)
    src, dst = rng.integers(0, n, e).astype(np.int32), rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) > 0.3
    want = jcommon.chunked_edge_aggregate(
        lambda s, d_, m: jnp.asarray(h)[s], jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(mask), n, d, chunk)
    th = torch.from_numpy(h)
    got = gnn_common.chunked_edge_aggregate(
        lambda s, d_, m: th.index_select(0, s), torch.from_numpy(src), torch.from_numpy(dst),
        torch.from_numpy(mask), n, d, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_graph_batch_to_moves_every_tensor():
    b = make_gnn_batch(6, 9, 3, coords=True, n_graphs=2, device="cpu")
    moved = b.to("cpu")
    assert moved.n == 6 and moved.e == 9 and moved.edge_feats is None
    assert all(getattr(moved, f.name) is None or getattr(moved, f.name).device.type == "cpu"
               for f in dataclasses.fields(moved))


def test_gin_graph_logits_matches_reference():
    """GIN's graph readout on a batched molecule batch (3 graphs of 10)."""
    jcfg = jget_arch("gin-tu").smoke_config
    params = _np(init_params(importlib.import_module("repro.models.gin").param_specs(jcfg),
                             jax.random.key(2)))
    jbatch = jmake_gnn_batch(30, 90, 8, n_classes=4, n_graphs=3, seed=4)
    want = importlib.import_module("repro.models.gin").graph_logits(params, jbatch, jcfg, 3)
    model = gin.GIN(get_arch("gin-tu").smoke_config, device="cpu")
    convert.params_from_reference(model, params)
    batch = make_gnn_batch(30, 90, 8, n_classes=4, n_graphs=3, seed=4, device="cpu")
    with torch.no_grad():
        got = model.graph_logits(batch, n_graphs=3)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _rot(angles):
    a, b, c = angles
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])
    return torch.from_numpy((Rz @ Ry @ Rx).astype(np.float32))


@pytest.mark.parametrize("seed", range(5))
def test_egnn_en_equivariance(seed):
    """h is invariant and x equivariant under rotations and translations
    (atol 2e-3, as the reference's test)."""
    rng = np.random.default_rng(seed)
    R = _rot(rng.uniform(-3.1, 3.1, 3))
    t = torch.from_numpy(rng.uniform(-5, 5, 3).astype(np.float32))
    model = egnn.EGNN(egnn.EGNNConfig(n_layers=2, d_hidden=16, d_in=8), device="cpu")
    with torch.no_grad():  # phi_x's last layer starts at 0: give x something to move by
        for lp in model.layers:
            lp.phi_x.w1.normal_(generator=torch.Generator().manual_seed(seed))
    batch = make_gnn_batch(24, 80, 8, d_out=1, coords=True, seed=2, device="cpu")
    with torch.no_grad():
        h1, x1 = model(batch)
        h2, x2 = model(dataclasses.replace(batch, coords=batch.coords @ R.T + t))
    torch.testing.assert_close(h1, h2, atol=2e-3, rtol=0)
    torch.testing.assert_close(x1 @ R.T + t, x2, atol=2e-3, rtol=0)
    assert not torch.allclose(x1, batch.coords)


def test_equiformer_scalar_z_rotation_invariance():
    """The l=0 output is invariant under rotations about z (the exactly
    implemented part of the eSCN alignment), atol 2e-3 as the reference."""
    cfg = equiformer_v2.EqV2Config(n_layers=2, d_hidden=16, l_max=3, d_in=8)
    model = equiformer_v2.EquiformerV2(cfg, device="cpu", seed=1)
    batch = make_gnn_batch(20, 60, 8, d_out=1, coords=True, seed=3, device="cpu")
    Rz = _rot((1.1, 0, 0))
    with torch.no_grad():
        out1 = model(batch)
        out2 = model(dataclasses.replace(batch, coords=batch.coords @ Rz.T))
    torch.testing.assert_close(out1, out2, atol=2e-3, rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_gin_graph_readout_permutation_invariance(seed):
    model = gin.GIN(gin.GINConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=4),
                    device="cpu", seed=2)
    batch = make_gnn_batch(30, 90, 8, n_classes=4, n_graphs=3, seed=4, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(5 + seed).permutation(30))
    inv = torch.argsort(perm).to(torch.int32)
    pb = dataclasses.replace(
        batch,
        node_feats=batch.node_feats[perm], node_mask=batch.node_mask[perm],
        graph_ids=batch.graph_ids[perm], labels=batch.labels[perm],
        label_mask=batch.label_mask[perm],
        src=inv[batch.src.long()], dst=inv[batch.dst.long()],
    )
    with torch.no_grad():
        torch.testing.assert_close(model.graph_logits(batch, 3), model.graph_logits(pb, 3),
                                   atol=1e-4, rtol=0)


def test_equiformer_tables_match_reference():
    for l_max in (0, 2, 6):
        cfg = equiformer_v2.EqV2Config(l_max=l_max)
        for a, b in zip(equiformer_v2._zrot_tables(cfg), jeqv2._zrot_tables(
                jeqv2.EqV2Config(l_max=l_max))):
            np.testing.assert_array_equal(a, b)
    # the radial centres: jnp.linspace's formula in IEEE float32; XLA's CPU
    # division of the iota rounds 7 of the 16 default centres one ulp away
    for num in (2, 7, 16):
        got = equiformer_v2._linspace(0.0, 6.0, num)
        div = np.float32(num - 1)
        np.testing.assert_array_equal(got[:-1], np.float32(6) * (np.arange(num - 1, dtype=np.float32) / div))
        np.testing.assert_allclose(got, np.asarray(jnp.linspace(0.0, 6.0, num)), rtol=2.4e-7, atol=0)


# ---- the reference's src_blocked fault -------------------------------------

def _blocked_batch(n, e, n_chunks, seed=6):
    """A batch on the pipeline contract: chunk i's sources lie in node
    block i (blocks of ceil(n / n_chunks))."""
    rng = np.random.default_rng(seed)
    nb = -(-n // n_chunks)
    c = e // n_chunks
    src = np.concatenate([rng.integers(i * nb, min((i + 1) * nb, n), c) for i in range(n_chunks)])
    dst = rng.integers(0, n, e)
    return dict(
        node_feats=rng.normal(size=(n, 8)).astype(np.float32),
        src=src.astype(np.int32), dst=dst.astype(np.int32), edge_mask=src != dst,
        node_mask=np.ones(n, bool), coords=rng.normal(size=(n, 3)).astype(np.float32),
        labels=rng.normal(size=(n, 1)).astype(np.float32), label_mask=np.ones(n, bool),
    )


def _both_modes(n, e, n_chunks):
    """forward outputs {(package, src_blocked): [n, 1]} on one batch."""
    arrays = _blocked_batch(n, e, n_chunks)
    jcfg = dataclasses.replace(jget_arch("equiformer-v2").smoke_config, edge_chunk=e // n_chunks)
    params = _np(init_params(jeqv2.param_specs(jcfg), jax.random.key(0)))
    jbatch = jcommon.GraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tbatch = gnn_common.GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    out = {}
    for blocked in (False, True):
        out["jax", blocked] = np.asarray(jeqv2.forward(
            params, jbatch, dataclasses.replace(jcfg, src_blocked=blocked)))
        model = equiformer_v2.EquiformerV2(dataclasses.replace(
            get_arch("equiformer-v2").smoke_config, edge_chunk=e // n_chunks,
            src_blocked=blocked), device="cpu")
        convert.params_from_reference(model, params)
        with torch.no_grad():
            out["torch", blocked] = model(tbatch).numpy()
    return out


def test_src_blocked_agrees_where_n_divides():
    """N = 48 over 4 chunks: both packages' blocked mode reads X[s], so it
    equals the unblocked mode, in each package and across them."""
    out = _both_modes(48, 160, 4)
    for key in out:
        np.testing.assert_allclose(out[key], out["jax", False], **FWD)


def test_src_blocked_reference_fault_where_n_does_not_divide():
    """N = 50 over 4 chunks (blocks of 13, the last of 11): the reference
    clamps the last block's start to N - Nb = 37 but indexes it from 39, so
    its last chunk reads rows other than X[s] and its blocked mode departs
    from its unblocked one; the port's does not."""
    out = _both_modes(50, 160, 4)
    np.testing.assert_allclose(out["torch", False], out["jax", False], **FWD)
    np.testing.assert_allclose(out["torch", True], out["torch", False], **FWD)
    assert np.abs(out["jax", True] - out["jax", False]).max() > 1e-3


def test_src_blocked_refuses_an_empty_node_block():
    """N = 10 over 6 chunks: blocks of 2 leave chunk 5 no node."""
    cfg = equiformer_v2.EqV2Config(n_layers=1, d_hidden=4, l_max=1, d_in=3, edge_chunk=2,
                                   src_blocked=True)
    model = equiformer_v2.EquiformerV2(cfg, device="cpu")
    batch = make_gnn_batch(10, 12, 3, d_out=1, coords=True, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        model(batch)


def test_message_passing_saves_no_edge_sized_activation():
    """The backward of a GIN layer keeps [N, d] activations and the [E]
    index vectors, never an [E, d] message tensor (15.8 GB a layer at
    ogb_products): the segment sum saves only its ids."""
    n, e, d = 40, 4096, 16
    model = gin.GIN(gin.GINConfig(n_layers=3, d_hidden=d, d_in=5, n_classes=3), device="cpu")
    batch = make_gnn_batch(n, e, 5, n_classes=3, seed=8, device="cpu")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        loss = model.loss_fn(batch)
    loss.backward()
    assert saved and max(saved) < e * d
