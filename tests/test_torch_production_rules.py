"""The models under the production rules, then the dry-run's cells.

* On gloo worlds of 4 spawned CPU processes (a (data=2, model=2) mesh,
  joined within ``TIMEOUT`` seconds), every parameter and input a DTensor
  placed by ``arch_rules`` of the published configs, each step held to
  the same step without a mesh at rtol 1e-5 (float32 sums in another
  order):

  - the smoke LMs, one step of each rule kind of the production meshes:
    feature-sharded boundaries (``model_d``), replicated heads with
    sequence-parallel attention (``model_seq``), MoE over experts (``ep``)
    and over the experts' hidden units (``tp``, with folded experts and
    expanded k/v heads), a decode step with the cache split over the
    batch, one whose single request's cache is split over its slots, and
    a prefill with the sequence split; on the port's weights from seed
    0, and also held to the JAX package's unsharded step on the same
    weights (loss rtol 1e-5 and gradient norm
    rtol 1e-4, as ``test_torch_lm_train.py`` holds them; logits rtol 1e-5,
    atol 1e-4, as ``test_torch_lm.py`` does);
  - the four GNNs, one AdamW step each under ``ogb_products``' rules
    (edges over both axes, the node state split but for GIN's) and GIN's
    and Equiformer-v2's under ``full_graph_sm``'s (edges over data), with
    chunked message passing, Equiformer-v2's ``src_blocked`` on blocks
    that straddle the ranks' node rows, and tied edges split across
    ranks: the loss, the gradient norm and every gradient. A gradient is
    held to rtol 1e-5 with an absolute floor of 1e-5 times the larger of
    its own largest magnitude and a thousandth of the step's largest:
    Equiformer-v2's last attention bias has an exact gradient of zero (a
    head's edge softmax does not move when all its logits shift), so both
    runs hold only rounding there;
  - BERT4Rec's ``serve_bulk`` (two user chunks), ``retrieval_cand`` and
    ``train_batch`` steps under their rules: the top-100 values and ids,
    or the loss, gradient norm and gradients.
* In a subprocess, one cell per family runs through ``run_cell`` on the
  fake 16x16 world: a record with no error, a positive peak, and an LM's
  useful share of the counted FLOPs in [0.25, 1.1].
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.launch.steps as jsteps
from repro.configs import get_arch as jget_arch
from repro.configs.registry import ShapeSpec as JShapeSpec
from repro.models import transformer as jtfm
from repro.models.param import init_params
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init
from repro_torch import convert
from repro_torch.testing import sharded
from repro_torch.testing.sharded import run_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120
RTOL = 1e-5
#: against the JAX package: the loss, the gradient norm, the logits
REF_LOSS_RTOL, REF_NORM_RTOL, REF_LOGITS = 1e-5, 1e-4, dict(rtol=1e-5, atol=1e-4)
#: a gradient's absolute floor, as a share of the step's largest gradient
GRAD_FLOOR = 1e-3
LR = 1e-2

#: (name, arch, the production shape whose rules apply, kind, batch, seq, config
#: overrides); each group runs in a world of its own
GROUPS = [
    [("model_d", "gemma-7b", "train_4k", "train", 4, 64, {}),
     ("model_seq", "minicpm-2b", "train_4k", "train", 4, 64, {})],
    [("moe_ep", "moonshot-v1-16b-a3b", "train_4k", "train", 4, 64, {}),
     ("moe_tp", "grok-1-314b", "train_4k", "train", 4, 64, {"expert_sharding": "tp"}),
     ("moe_ep_fold", "grok-1-314b", "train_4k", "train", 4, 64, {})],
    [("decode_cache_batch", "gemma-7b", "decode_32k", "decode", 4, 64, {}),
     ("decode_seq_split", "minicpm-2b", "long_500k", "decode", 1, 64, {}),
     ("prefill_seq", "minicpm-2b", "prefill_32k", "prefill", 2, 64, {})],
]
GROUP_OF = {c[0]: g for g, cases in enumerate(GROUPS) for c in cases}
CASE = {c[0]: c for cases in GROUPS for c in cases}


def _reference_freqs(d_head, theta):
    half = d_head // 2
    return np.asarray(jax.jit(
        lambda: jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))())


def _reference_case(name, arch_id, rules, kind, B, S, over, path):
    """The case's inputs, written to ``path`` for the ranks: the port's
    weights from seed 0 (at the JAX package's initial weights float32
    rounding alone moves moonshot's gradients by more than a 1e-5
    comparison of two float32 runs can resolve), the reference's RoPE
    vector and the inputs. Returns the reference's unsharded step on the
    same weights (its parameter tree from the port's): ``{loss,
    grad_norm}`` or ``{logits}``."""
    from repro_torch.models import transformer as tfm

    jcfg = dataclasses.replace(jget_arch(arch_id).smoke_config, param_dtype=jnp.float32,
                               vocab_pad_to=8, **over)
    jarch = dataclasses.replace(jget_arch(arch_id), config=jcfg)
    jshape = JShapeSpec(name, kind, seq_len=S, global_batch=B)
    model = tfm.Transformer(dataclasses.replace(sharded.smoke_lm_config(arch_id), **over),
                            device="cpu", seed=0)
    flat = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    params = jax.tree_util.tree_map(jnp.asarray, convert._unflatten(flat))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(init_params(jtfm.param_specs(jcfg), jax.random.key(0))))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    cache = {k: rng.normal(size=(jcfg.n_layers, B, S, jcfg.n_kv, jcfg.d_head)).astype(np.float32)
             for k in ("k", "v")}
    token = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
    np.savez(path, tokens=tokens, cache_k=cache["k"], cache_v=cache["v"], token=token,
             rope_freqs=_reference_freqs(jcfg.d_head, jcfg.rope_theta),
             **{f"w/{k}": v for k, v in flat.items()})
    if kind == "train":
        opt_cfg = JAdamWConfig(lr=LR)
        _, _, m = jax.jit(jsteps.make_lm_train_step(jarch, jshape, opt_cfg))(
            params, adamw_init(params, opt_cfg), {"tokens": tokens})
        return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    if kind == "prefill":
        _, logits = jax.jit(jsteps.make_lm_prefill(jarch, jshape))(params, {"tokens": tokens})
    else:
        logits, _ = jax.jit(jsteps.make_lm_decode(jarch, jshape))(
            params, {"cache": cache, "token": token})
    return {"logits": np.asarray(logits, np.float32)}


def _world_fixture(rank_fn, groups, tmp_path_factory, with_reference=False):
    """Each group's results (a world of 4 ranks each, every rank's values
    the same), run once on demand; an LM group also gets its cases' inputs
    and the reference's results (``reference/<name>``)."""
    done = {}

    def get(g):
        if g not in done:
            root = tmp_path_factory.mktemp(f"group{g}")
            cases, ref = [], {}
            for c in groups[g]:
                case = dict(c)
                if with_reference:
                    case["inputs"] = str(root / f"{case['name']}.npz")
                    ref[case["name"]] = _reference_case(
                        case["name"], case["arch"], case["rules"], case["kind"], case["batch"],
                        case["seq"], case["config"], case["inputs"])
                cases.append(case)
            results = run_world(rank_fn, 4, root / "world", (2, 2), cases, timeout=TIMEOUT)
            for r in results[1:]:  # every rank gathered the same values
                assert r.keys() == results[0].keys()
            done[g] = (results[0], ref)
        return done[g]

    return get


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    keys = ("name", "arch", "rules", "kind", "batch", "seq", "config")
    return _world_fixture(sharded.production_rules_rank,
                          [[dict(zip(keys, c)) for c in cases] for cases in GROUPS],
                          tmp_path_factory, with_reference=True)


def _assert_sharded_equals_unsharded(world, name, grad_floor=0.0):
    keys = sorted(k.removeprefix(f"{name}/want/") for k in world if k.startswith(f"{name}/want/"))
    assert keys and all(f"{name}/got/{k}" in world for k in keys)
    step_max = max((float(np.abs(world[f"{name}/want/{k}"]).max()) for k in keys
                    if k.startswith("grad/")), default=0.0)
    bad = {}
    for k in keys:
        want, got = world[f"{name}/want/{k}"], world[f"{name}/got/{k}"]
        scale = max(float(np.abs(want).max()), 1e-30)
        if k.startswith("grad/"):
            scale = max(scale, grad_floor * step_max)
        assert got.shape == want.shape, k
        if not np.allclose(got, want, rtol=RTOL, atol=RTOL * scale):
            bad[k] = float(np.abs(got - want).max() / scale)
    assert not bad, f"differ (max abs error over max magnitude): {bad}"


@pytest.mark.parametrize("name", list(GROUP_OF))
def test_step_under_production_rules_equals_unsharded(worlds, name):
    _assert_sharded_equals_unsharded(worlds(GROUP_OF[name])[0], name)


@pytest.mark.parametrize("name", list(GROUP_OF))
def test_step_under_production_rules_matches_reference(worlds, name):
    """The sharded step against the JAX package's unsharded step on the same
    weights and inputs."""
    world, ref = worlds(GROUP_OF[name])
    want = ref[name]
    if CASE[name][3] == "train":
        np.testing.assert_allclose(world[f"{name}/got/loss"], want["loss"], rtol=REF_LOSS_RTOL)
        np.testing.assert_allclose(world[f"{name}/got/grad_norm"], want["grad_norm"],
                                   rtol=REF_NORM_RTOL)
    else:
        np.testing.assert_allclose(world[f"{name}/got/logits"], want["logits"], **REF_LOGITS)


#: GNN cases: (name, arch, the shape whose rules apply, config overrides);
#: 48 nodes (12 a rank where they are split), 192 edges
GNN_CASES = [
    ("gin_products_chunked", "gin-tu", "ogb_products", {"edge_chunk": 64}),
    ("gin_small", "gin-tu", "full_graph_sm", {}),
    ("egnn_products_chunked", "egnn", "ogb_products", {"edge_chunk": 64}),
    ("meshgraphnet_products_chunked", "meshgraphnet", "ogb_products", {"edge_chunk": 64}),
    # 3 chunks: node blocks of 16 rows over ranks of 12
    ("equiformer_products_src_blocked", "equiformer-v2", "ogb_products",
     {"edge_chunk": 64, "src_blocked": True}),
    ("equiformer_small", "equiformer-v2", "full_graph_sm", {}),
]
#: BERT4Rec cases: (name, shape whose rules apply, kind, batch, candidates,
#: config overrides); 2,048 items, so a slice of the two-stage top-100 holds
#: 128 (the smoke config's 1,024 would hold 64)
RECSYS_CASES = [
    ("serve_bulk_two_chunks", "serve_bulk", "serve_scores", 8192, 0, {"item_vocab": 2048}),
    ("retrieval_cand", "retrieval_cand", "retrieval", 1, 2048, {"item_vocab": 2048}),
    ("train_batch", "train_batch", "train", 8, 0, {}),
]


@pytest.fixture(scope="module")
def other_worlds(tmp_path_factory):
    gnn = [dict(name=n, arch=a, rules=r, config=c, n=48, e=192) for n, a, r, c in GNN_CASES]
    rec = [dict(name=n, rules=r, kind=k, batch=b, n_candidates=nc, config=c)
           for n, r, k, b, nc, c in RECSYS_CASES]
    get_gnn = _world_fixture(sharded.gnn_rules_rank, [gnn], tmp_path_factory)
    get_rec = _world_fixture(sharded.recsys_rules_rank, [rec], tmp_path_factory)
    return {"gnn": lambda: get_gnn(0)[0], "recsys": lambda: get_rec(0)[0]}


@pytest.mark.parametrize("name", [c[0] for c in GNN_CASES])
def test_gnn_step_under_production_rules_equals_unsharded(other_worlds, name):
    _assert_sharded_equals_unsharded(other_worlds["gnn"](), name, GRAD_FLOOR)


@pytest.mark.parametrize("name", [c[0] for c in RECSYS_CASES])
def test_recsys_step_under_production_rules_equals_unsharded(other_worlds, name):
    world = other_worlds["recsys"]()
    _assert_sharded_equals_unsharded(world, name, GRAD_FLOOR)
    if f"{name}/want/ids" in world:  # the top 100's ids are exact
        np.testing.assert_array_equal(world[f"{name}/got/ids"], world[f"{name}/want/ids"])


CELLS = [("gemma-7b", "train_4k"), ("moonshot-v1-16b-a3b", "train_4k"),
         ("minicpm-2b", "prefill_32k"), ("grok-1-314b", "decode_32k"),
         ("gin-tu", "ogb_products"), ("bert4rec", "serve_p99")]
CELL_RUN = """
import json, sys
from repro_torch.launch.dryrun import run_cell
for arch_id, shape_name in json.loads(sys.argv[1]):
    print(json.dumps(run_cell(arch_id, shape_name, False)), flush=True)
"""


@pytest.fixture(scope="module")
def cells():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", CELL_RUN, json.dumps(CELLS)], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT, check=True)
    recs = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    return {(r["arch"], r["shape"]): r for r in recs}


@pytest.mark.parametrize("arch_id, shape_name", CELLS)
def test_production_cell_runs_on_the_fake_world(cells, arch_id, shape_name):
    rec = cells[(arch_id, shape_name)]
    assert "error" not in rec and rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert rec["memory"]["peak_per_device"] > 0 and rec["flops_per_device"] > 0
    if rec["arch"] not in ("gin-tu", "bert4rec"):
        assert 0.25 <= rec["roofline"]["useful_flop_ratio"] <= 1.1, rec["roofline"]
