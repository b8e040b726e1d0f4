"""Port parity of the GNN training path around the models: the registry
(``repro_torch.configs``), the GNN half of ``launch/steps.py``, the data
pipelines, the train step and the sampled trainer
(``repro_torch.launch.gnn_train``) against the JAX package's registry,
steps, pipelines and ``examples/gnn_train.py``'s loop.

Registry fields, shape configs, batch dimensions and pipeline arrays are
exact. Train steps: loss rtol 1e-5, atol 1e-6 at the first step; the
gradient norm rtol 1e-4. Later steps compare losses, not parameters: the
first AdamW update is about lr * sign(g), so a near-zero gradient whose
sign differs between the packages moves a parameter by about 2 * lr;
their losses are held to rtol 1e-3 (one such parameter moves a loss of
~2 by well under 1e-3).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
import repro.data.pipeline as jpipeline
import repro.launch.steps as jsteps
from repro.configs import all_arch_ids as jall_arch_ids
from repro.configs import get_arch as jget_arch
from repro.graph import CSRGraph as JCSRGraph
from repro.graph import NeighborSampler as JNeighborSampler
from repro.graph.generators import kronecker_graph, uniform_weights
from repro.models import gin as jgin
from repro.models.gnn_common import GraphBatch as JGraphBatch
from repro.models.param import init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init, adamw_update
from repro_torch import convert
from repro_torch.configs import all_arch_ids, get_arch, registry
from repro_torch.data import pipeline
from repro_torch.graph import CSRGraph, NeighborSampler
from repro_torch.launch import gnn_train, steps
from repro_torch.optim import AdamW, AdamWConfig

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
LATER = dict(rtol=1e-3, atol=1e-6)
GNN_IDS = ["gin-tu", "egnn", "meshgraphnet", "equiformer-v2"]
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def _fields(cfg):
    """A config's fields, its dtype by name (jnp.float32 / torch.float32),
    without the reference's ``unroll`` (a dry-run switch the port has no
    counterpart of: its chunk loops are Python loops)."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).split(".")[-1].strip("'>")
    out.pop("unroll", None)
    return out


def _spec(s):
    return (tuple(s.shape), tuple(s.logical), str(s.dtype).split(".")[-1].strip("'>"),
            s.init, s.scale)


def test_registry_holds_the_four_gnns():
    """The four GNNs, among all ten ids of the reference's registry (the LMs
    and BERT4Rec are held in ``test_torch_lm.py`` / ``test_torch_recsys.py``);
    an unknown id raises."""
    assert set(GNN_IDS) <= set(all_arch_ids())
    assert all_arch_ids() == jall_arch_ids() and len(all_arch_ids()) == 10
    assert {get_arch(a).family for a in GNN_IDS} == {"gnn"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_arch_spec_fields_match_reference(arch_id):
    arch, ref = get_arch(arch_id), jget_arch(arch_id)
    for f in dataclasses.fields(ref):
        got, want = getattr(arch, f.name), getattr(ref, f.name)
        if f.name in ("config", "smoke_config"):
            assert _fields(got) == _fields(want), f.name
        elif f.name == "shapes":
            assert got is registry.GNN_SHAPES and {
                k: dataclasses.asdict(v) for k, v in got.items()} == {
                k: dataclasses.asdict(v) for k, v in want.items()}
        else:
            assert got == want, f.name
    assert _fields(arch.config)["dtype"] == "float32"


def test_shape_sets_match_reference():
    for name in ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES"):
        got, want = getattr(registry, name), getattr(jregistry, name)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()}
    for pad in (256, 8192):
        shape = registry.GNN_SHAPES["minibatch_lg"]
        assert registry.sampled_subgraph_sizes(shape, pad) == jregistry.sampled_subgraph_sizes(
            jregistry.GNN_SHAPES["minibatch_lg"], pad)
    assert registry.sampled_subgraph_sizes(registry.GNN_SHAPES["minibatch_lg"]) == (
        180_224, 180_224)


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_step_shapes_match_reference(arch_id, shape_name):
    """gnn_edge_chunk, gnn_shape_config, gnn_batch_dims, gnn_input_specs and
    gnn_state_specs of every (arch, shape)."""
    arch, ref = get_arch(arch_id), jget_arch(arch_id)
    shape, jshape = arch.shapes[shape_name], ref.shapes[shape_name]
    assert steps.gnn_edge_chunk(arch, shape) == jsteps.gnn_edge_chunk(ref, jshape)
    cfg = steps.gnn_shape_config(arch, shape)
    assert _fields(cfg) == _fields(jsteps.gnn_shape_config(ref, jshape))
    assert steps.gnn_batch_dims(shape, cfg.edge_chunk) == jsteps.gnn_batch_dims(
        jshape, cfg.edge_chunk)
    got = {k: _spec(v) for k, v in steps.gnn_input_specs(arch, shape).items()}
    want = {k: _spec(v) for k, v in jsteps.gnn_input_specs(ref, jshape).items()}
    assert got == want
    (pspecs, ospecs) = steps.gnn_state_specs(arch, shape, AdamWConfig())
    (jp, jo) = jsteps.gnn_state_specs(ref, jshape, JAdamWConfig())
    flat = lambda t: {k: _spec(v) for k, v in convert._flatten(t).items()}
    assert flat(pspecs) == flat(jp) and flat(ospecs) == flat(jo)


def test_ogb_products_dimensions():
    """gin-tu on ogb_products: 2,449,152 x 61,859,328 after padding, no chunks."""
    arch = get_arch("gin-tu")
    shape = arch.shapes["ogb_products"]
    assert steps.gnn_edge_chunk(arch, shape) == 0
    assert steps.gnn_batch_dims(shape) == (2_449_152, 61_859_328)
    eq = get_arch("equiformer-v2")
    cfg = steps.gnn_shape_config(eq, shape)
    assert cfg.src_blocked and steps.gnn_batch_dims(shape, cfg.edge_chunk)[1] % 16 == 0


@pytest.mark.parametrize("kw", [
    dict(n_classes=4, coords=True, seed=1),
    dict(d_out=3, coords=True, seed=2),
    dict(d_out=0, seed=3),
    dict(n_classes=5, n_graphs=4, seed=4),
    dict(d_out=1, n_graphs=3, coords=True, seed=5),
], ids=["classes", "regression", "default_out", "graphs", "graphs_coords"])
def test_make_gnn_batch_matches_reference(kw):
    got = pipeline.make_gnn_batch(48, 160, 8, device="cpu", **kw)
    want = jpipeline.make_gnn_batch(48, 160, 8, **kw)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if w is None:
            assert g is None, f.name
            continue
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, f.name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


@pytest.mark.parametrize("step", [0, 3])
def test_token_and_recsys_pipelines_match_reference(step):
    got = pipeline.TokenPipeline(100, 4, 16, seed=2, device="cpu").batch_at(step)
    want = jpipeline.TokenPipeline(100, 4, 16, seed=2).batch_at(step)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    got = pipeline.RecsysPipeline(500, 3, 12, 2, 7, n_context=5, seed=1,
                                  device="cpu").batch_at(step)
    want = jpipeline.RecsysPipeline(500, 3, 12, 2, 7, n_context=5, seed=1).batch_at(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_graph_stream_pipeline_matches_reference():
    got = pipeline.GraphStreamPipeline(8, 4, 16, 0.1, seed=3)
    want = jpipeline.GraphStreamPipeline(8, 4, 16, 0.1, seed=3)
    for g, w in zip(got.stream(), want.stream()):
        np.testing.assert_array_equal(g, w)
    assert got.build().m == want.build().m


def _smoke_arch(mod_get, arch_id):
    arch = mod_get(arch_id)
    return dataclasses.replace(arch, config=arch.smoke_config)


@pytest.mark.parametrize("arch_id", GNN_IDS)
def test_train_step_matches_reference(arch_id):
    """Two steps of ``make_gnn_train_step`` at the smoke config on the
    molecule shape's config (d_in 16), from the reference's weights."""
    arch, ref = _smoke_arch(get_arch, arch_id), _smoke_arch(jget_arch, arch_id)
    shape, jshape = arch.shapes["molecule"], ref.shapes["molecule"]
    jcfg = jsteps.gnn_shape_config(ref, jshape)
    jmod = importlib.import_module(f"repro.models.{ref.gnn_model}")
    params = init_params(jmod.param_specs(jcfg), jax.random.key(0))
    jopt_cfg, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstate = adamw_init(params, jopt_cfg)
    jstep = jax.jit(jsteps.make_gnn_train_step(ref, jshape, jopt_cfg))
    model = steps.make_gnn_model(arch, shape, device="cpu")
    convert.params_from_reference(model, jax.tree_util.tree_map(np.asarray, params))
    opt = AdamW(model.parameters(), opt_cfg)
    step = steps.make_gnn_train_step(arch, shape, opt_cfg, device="cpu")
    kw = dict(n_classes=jcfg.n_classes if arch_id == "gin-tu" else 0,
              d_out=getattr(jcfg, "d_out", 1), coords=True)
    for i in range(2):
        jb = jpipeline.make_gnn_batch(48, 160, 16, seed=10 + i, **kw)
        tb = pipeline.make_gnn_batch(48, 160, 16, seed=10 + i, device="cpu", **kw)
        batch = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)
                 if getattr(jb, f.name) is not None}
        params, jstate, jout = jstep(params, jstate, batch)
        out = step(model, opt, {k: getattr(tb, k) for k in batch})
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]), **(FWD if i == 0 else LATER))
        np.testing.assert_allclose(float(out["grad_norm"]), float(jout["grad_norm"]),
                                   **(GRAD if i == 0 else LATER))
    assert int(opt.count) == 2


def _reference_merge(blocks, seeds, feats, labels, n_pad, e_pad):
    """``examples/gnn_train.py``'s merge of the sampled blocks, as numpy."""
    nodes = blocks[-1].nodes[blocks[-1].node_mask]
    remap = {g: i for i, g in enumerate(nodes)}
    b0 = blocks[0]
    sel = np.nonzero(b0.edge_mask)[0]
    src_g = b0.nodes[b0.src_index[sel]]
    dst_g = seeds[b0.dst_index[sel]]
    keep = np.array([g in remap for g in src_g])
    src_l = np.array([remap[g] for g in src_g[keep]], np.int32)
    dst_l = np.array([remap.get(g, 0) for g in dst_g[keep]], np.int32)
    ne, nn = len(src_l), len(nodes)
    return dict(
        node_feats=np.pad(feats[nodes], ((0, n_pad - nn), (0, 0))),
        src=np.pad(src_l, (0, e_pad - ne)),
        dst=np.pad(dst_l, (0, e_pad - ne)),
        edge_mask=np.arange(e_pad) < ne,
        node_mask=np.arange(n_pad) < nn,
        labels=np.pad(labels[nodes], (0, n_pad - nn)).astype(np.int32),
        label_mask=np.arange(n_pad) < nn,
    ), nn, ne


@pytest.mark.parametrize("fanouts", [(10, 5), (3,), (4, 2, 2)])
def test_merge_hop0_matches_the_example(fanouts):
    src, dst = kronecker_graph(9, edge_factor=4, seed=1)
    w = uniform_weights(len(src), 16, 0.1, seed=1)
    csr = CSRGraph.from_edges(src, dst, w, n=512, symmetrize=True)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(512, 5)).astype(np.float32)
    labels = rng.integers(0, 6, 512)
    sampler = NeighborSampler(csr, fanouts=list(fanouts), seed=0)
    for _ in range(3):
        seeds = rng.integers(0, 512, 32)
        blocks = sampler.sample(seeds)
        got, nn, ne = gnn_train.merge_hop0(blocks, seeds, feats, labels, 4096, 4096, "cpu")
        want, wnn, wne = _reference_merge(blocks, seeds, feats, labels, 4096, 4096)
        assert (nn, ne) == (wnn, wne) and ne > 0
        for k, v in want.items():
            g = getattr(got, k).numpy()
            assert g.dtype == v.dtype, k
            np.testing.assert_array_equal(g, v, err_msg=k)


def test_merge_hop0_refuses_a_short_pad():
    src, dst = kronecker_graph(8, edge_factor=4, seed=0)
    csr = CSRGraph.from_edges(src, dst, np.ones(len(src), np.float32), n=256, symmetrize=True)
    seeds = np.arange(16)
    blocks = NeighborSampler(csr, fanouts=[5], seed=0).sample(seeds)
    feats, labels = np.zeros((256, 2), np.float32), np.zeros(256, np.int64)
    with pytest.raises(ValueError, match="do not fit"):
        gnn_train.merge_hop0(blocks, seeds, feats, labels, 8, 4096, "cpu")


def _reference_loop(steps_n):
    """``examples/gnn_train.py``'s loop with the JAX package's functions:
    its batches and losses."""
    src, dst = kronecker_graph(10, edge_factor=8, seed=0)
    w = uniform_weights(len(src), 16, 0.1, seed=0)
    n = 1024
    csr = JCSRGraph.from_edges(src, dst, w, n=n, symmetrize=True)
    sampler = JNeighborSampler(csr, fanouts=[10, 5], seed=0)
    cfg = jgin.GINConfig(n_layers=3, d_hidden=32, d_in=16, n_classes=8)
    params = init_params(jgin.param_specs(cfg), jax.random.key(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    opt_cfg = JAdamWConfig(lr=2e-3)
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 8, n)

    @jax.jit
    def step_fn(params, opt, batch):
        loss, grads = jax.value_and_grad(lambda p: jgin.loss_fn(p, batch, cfg))(params)
        params, opt, _ = adamw_update(params, grads, opt, opt_cfg.lr, opt_cfg)
        return params, opt, loss

    batches, losses = [], []
    for _ in range(steps_n):
        seeds = rng.integers(0, n, 64)
        arrays, _, _ = _reference_merge(sampler.sample(seeds), seeds, feats, labels, 2048, 8192)
        batch = JGraphBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
        params, opt, loss = step_fn(params, opt, batch)
        batches.append(arrays)
        losses.append(float(loss))
    return init, batches, losses


def test_trainer_matches_the_example_loop():
    """Three steps of the trainer at the example's size (scale 10, 64 seeds,
    fanouts (10, 5), GIN 3 x 32) from the reference's weights: the same
    sampler draws, batch for batch, and the same losses."""
    init, batches, losses = _reference_loop(3)
    src, dst = kronecker_graph(10, edge_factor=8, seed=0)
    w = uniform_weights(len(src), 16, 0.1, seed=0)
    trainer = gnn_train.SampledGINTrainer(src, dst, w, 1024, device="cpu")
    assert trainer.coarsening["coarse_n"] == 819 and trainer.coarsening["coarse_m"] == 4940
    convert.params_from_reference(trainer.model, init)
    for i, (arrays, loss) in enumerate(zip(batches, losses)):
        batch, nn, ne = trainer.next_batch()
        for k, v in arrays.items():
            np.testing.assert_array_equal(getattr(batch, k).numpy(), v, err_msg=k)
        got = float(trainer.step(batch)["loss"])
        np.testing.assert_allclose(got, loss, **(FWD if i == 0 else LATER))


def test_trainer_cli_runs_on_the_cpu(capsys):
    assert gnn_train.main(["--steps", "2", "--scale", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "coarsen-by-matching: 256 ->" in out and "step   1" in out
