"""Sharded execution of the port as DTensor placement, held to the JAX package.

* ``pspecs``: for every arch and shape of the registry, on the reference's
  single- and multi-pod meshes, the port's ``pspecs`` under the port's
  ``arch_rules`` give every leaf of the step's trees (parameters, optimizer
  state, inputs) the axes of the reference's ``pspecs`` under its own. ``shardings`` on gloo
  worlds of CPU processes give the expected ``Shard``/``Replicate`` lists,
  and a dimension over ``("pod", "data")`` holds the rows that jax's
  ``NamedSharding`` gives each device (a subprocess with 8 forced host
  devices).
* ``constrain``: the identity with no rules, and with rules but no mesh;
  it raises on a rank mismatch and on axes the mesh lacks; on a mesh it
  places a plain tensor without changing a value. gemma-7b's smoke forward
  under the rules on a 2x2 world equals the forward without rules (atol
  1e-5: the model axis splits the projections' sums in two, float32).
* The JAX package's multi-device test, parts 2 and 3, on gloo worlds: the
  gemma-7b smoke LM (float32, ``vocab_pad_to=8``, that test's rules) takes
  5 AdamW steps (lr 1e-2) on a 4x2 world. Its losses equal the JAX
  package's *unsharded* ``loss_fn`` / ``adamw_update`` steps on the same
  weights to rtol 1e-5 (float32 sums in another order), its gradient norms
  to rtol 1e-5 at step 1 and 1e-3 after (``NORM_RTOL``), and the loss
  falls. After one step every parameter is within 1e-6 of the
  port's unsharded AdamW step (an update is ~lr = 1e-2: a parameter left
  unchanged fails by four orders), and every leaf is split as the rules
  say. The parameters saved on 4x2 restore onto a 2x2 world through
  ``restore(..., shardings=...)`` with ``abstract_params`` as the template
  exactly. ``sharded_topk`` over a vocabulary-sharded DTensor of tied
  scores gives exactly the reference's indices.

Each spawned world is joined within ``TIMEOUT`` seconds, and its ranks
import only the port (``repro_torch.testing.sharded``).
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
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import repro.configs.registry as jregistry
import repro.launch.steps as jsteps
from repro.models import bert4rec as jb4r
from repro.models import transformer as jtfm
from repro.models.param import init_params as j_init_params
from repro.models.param import pspecs as j_pspecs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import constrain, sharding_rules, use_mesh
from repro_torch.distributed.sharding import placements
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_size
from repro_torch.models import bert4rec as b4r
from repro_torch.models import transformer as tfm
from repro_torch.models.param import PSpec, abstract_params, iter_specs, pspecs
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.testing import sharded
from repro_torch.testing.sharded import run_world, smoke_lm_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120
#: the rules of the JAX package's multi-device test (tests/test_multidevice.py)
RULES = {"dp": ("data",), "embed": None, "heads": "model", "kv_heads": "model", "mlp": "model",
         "vocab": "model", "layers": None, "model_seq": None}
ARCH, STEPS, LR = "gemma-7b", 5, 1e-2
LOSS_RTOL = 1e-5
#: after the first update: AdamW moves an entry by about lr * sign(g), and
#: where g is float32 noise the sign may differ; the norm of the gradients
#: that follow reads those entries (the port's unsharded steps are 1.3e-4
#: from the reference's there, the sharded ones 3.0e-4)
NORM_RTOL = 1e-3
STEP1_ATOL = 1e-6
CLEAR = 1e-2


# ------------------------------------------------------------------ pspecs


def _trees(mod, tfm_mod, b4r_mod, arch, shape, opt_cfg):
    """The spec trees the reference's ``build_step`` partitions for the step."""
    if arch.family == "lm":
        inputs = mod.lm_input_specs(arch, shape)
        if shape.kind == "train":
            return (*mod.lm_state_specs(arch, opt_cfg), inputs)
        return tfm_mod.param_specs(arch.config), inputs
    if arch.family == "gnn":
        return (*mod.gnn_state_specs(arch, shape, opt_cfg), mod.gnn_input_specs(arch, shape))
    inputs = mod.recsys_input_specs(arch, shape)
    if shape.kind == "train":
        return (*mod.recsys_state_specs(arch, opt_cfg), inputs)
    return b4r_mod.param_specs(arch.config), inputs


def _flat(tree, prefix=""):
    if isinstance(tree, PSpec):
        return {prefix: tuple(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _flat_reference(tree):
    from jax.sharding import PartitionSpec

    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): tuple(leaf)
            for path, leaf in leaves}


CASES = [(a, s) for a in jregistry.all_arch_ids() for s in jregistry.get_arch(a).shapes]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch_id, shape_name", CASES)
def test_pspecs_match_reference(arch_id, shape_name, multi_pod):
    jarch = jregistry.get_arch(arch_id)
    jshape = jarch.shapes[shape_name]
    want = [_flat_reference(j_pspecs(t, jsteps.arch_rules(jarch, jshape, multi_pod)))
            for t in _trees(jsteps, jtfm, jb4r, jarch, jshape, JAdamWConfig())]
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    rules = steps.arch_rules(arch, shape, multi_pod)
    got = [_flat(pspecs(t, rules)) for t in _trees(steps, tfm, b4r, arch, shape, AdamWConfig())]
    assert got == want


def test_abstract_params_allocate_nothing():
    specs = tfm.param_specs(get_arch("grok-1-314b").config)
    tree = abstract_params(specs)
    leaves = _flat_tensors(tree)
    assert leaves and all(t.device.type == "meta" for t in leaves.values())
    assert leaves["layers/w1"].shape == specs["layers"]["w1"].shape
    assert leaves["layers/w1"].dtype == specs["layers"]["w1"].dtype


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_tensors(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


JAX_ROWS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
out = {}
for name, spec in (("pod_data", P(("pod", "data"))), ("data_model", P(("data", "model"))),
                   ("model", P("model"))):
    m = NamedSharding(mesh, spec).devices_indices_map((16,))
    out[name] = [list(range(16))[m[d][0]] for d in jax.devices()[:8]]
print(json.dumps(out))
"""


def test_shardings_split_rows_as_named_sharding(tmp_path):
    """On a (pod, data, model) = (2, 2, 2) world the placements of
    ``shardings`` are the expected lists, and each rank holds the rows that
    jax's ``NamedSharding`` gives the device at its mesh position."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    ref = subprocess.run([sys.executable, "-c", JAX_ROWS], env=env, check=True, timeout=TIMEOUT,
                         capture_output=True, text=True)
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    rules = {**RULES, "dp": ("pod", "data")}
    results = run_world(sharded.shardings_rank, 8, tmp_path / "out", rules, list(want),
                        timeout=TIMEOUT)
    for rank, r in enumerate(results):
        for name, rows in want.items():
            assert r[f"rows/{name}"].tolist() == rows[rank], (rank, name)
    expected = {
        "embed": "(Replicate(), Replicate(), Shard(dim=0))",
        "lm_head": "(Replicate(), Replicate(), Shard(dim=1))",
        "layers.wq": "(Replicate(), Replicate(), Shard(dim=2))",
        "layers.ln1": "(Replicate(), Replicate(), Replicate())",
        "tokens": "(Shard(dim=0), Shard(dim=0), Replicate())",
    }
    for r in results:
        assert {k: str(r[f"placements/{k}"]) for k in expected} == expected


# ------------------------------------------------------------------ constrain


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group in this process and its (1, 1) mesh."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_constrain_is_the_identity_without_rules_or_mesh(world1):
    x = torch.arange(6.0).reshape(2, 3)
    assert constrain(x, "dp", None) is x
    with use_mesh(world1):
        assert constrain(x, "dp", None) is x
    with sharding_rules(RULES):
        assert constrain(x, "dp", None) is x
        assert constrain(x, "dp") is x  # no mesh: not even the rank is read


def test_constrain_places_without_changing_values(world1):
    x = torch.arange(6.0).reshape(2, 3)
    with sharding_rules(RULES), use_mesh(world1):
        y = constrain(x, "dp", "vocab")
        assert tuple(y.placements) == (Shard(0), Shard(1))
        torch.testing.assert_close(y.full_tensor(), x, rtol=0, atol=0)
        z = constrain(y, None, None)
        assert tuple(z.placements) == (Replicate(), Replicate())
        assert constrain(z, "embed", None) is z  # already laid out


def test_constrain_raises(world1):
    x = torch.ones(2, 3)
    with use_mesh(world1):
        with sharding_rules(RULES):
            with pytest.raises(ValueError, match="2-d tensor"):
                constrain(x, "dp")
            with pytest.raises(ValueError, match="2-d tensor"):
                constrain(x, "dp", None, None)
        with sharding_rules({"dp": ("pod", "data")}):
            with pytest.raises(ValueError, match="not in the mesh"):
                constrain(x, "dp", None)
        with sharding_rules({"dp": ("model", "data")}):
            with pytest.raises(ValueError, match="mesh's order"):
                constrain(x, "dp", None)


def test_host_mesh(world1):
    assert world1.mesh_dim_names == ("data", "model") and world1.device_type == "cpu"
    assert (mesh_axis_size(world1, "data"), mesh_axis_size(world1, "pod")) == (1, 1)
    assert placements(world1, ("data", None)) == (Shard(0), Replicate())
    assert placements(world1, (None, ("data", "model"))) == (Shard(1), Shard(1))
    with pytest.raises(ValueError, match="splits two dimensions"):
        placements(world1, ("data", ("data", "model")))


# ------------------------------------------------------------------ the LM


def _reference_freqs(d_head, theta):
    half = d_head // 2
    return np.asarray(jax.jit(
        lambda: jnp.exp(-jnp.arange(0, half, dtype=jnp.float32) * (np.log(theta) / half)))())


@pytest.fixture(scope="module")
def lm_reference(tmp_path_factory):
    """The multi-device test's LM without a mesh: its initial weights, tokens
    and RoPE vector saved for the ranks, and each step's loss and gradient
    norm under ``jax.jit``."""
    jcfg = dataclasses.replace(jregistry.get_arch(ARCH).smoke_config, param_dtype=jnp.float32,
                               vocab_pad_to=8)
    params = j_init_params(jtfm.param_specs(jcfg), jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (4, 64), 0, jcfg.vocab)
    opt_cfg = JAdamWConfig(lr=LR)
    opt = j_adamw_init(params, opt_cfg)

    @jax.jit
    def step(params, opt, toks):
        loss, g = jax.value_and_grad(lambda p: jtfm.loss_fn(p, toks, jcfg))(params)
        params, opt, gnorm = j_adamw_update(params, g, opt, opt_cfg.lr, opt_cfg)
        return params, opt, loss, gnorm

    flat = convert._flatten(jax.tree_util.tree_map(np.asarray, params))
    path = tmp_path_factory.mktemp("lm") / "inputs.npz"
    np.savez(path, arch=ARCH, tokens=np.asarray(toks, np.int64),
             rope_freqs=_reference_freqs(jcfg.d_head, jcfg.rope_theta),
             **{f"w/{k}": np.asarray(v, np.float32) for k, v in flat.items()})
    losses, norms, p = [], [], params
    for _ in range(STEPS):
        p, opt, loss, gnorm = step(p, opt, toks)
        losses.append(float(loss))
        norms.append(float(gnorm))
    return path, np.asarray(losses), np.asarray(norms)


@pytest.fixture(scope="module")
def lm_trained(lm_reference, tmp_path_factory):
    """5 sharded steps on a 4x2 world, the parameters saved at the end."""
    path = lm_reference[0]
    ckpt = tmp_path_factory.mktemp("ckpt")
    results = run_world(sharded.lm_train_rank, 8, tmp_path_factory.mktemp("train"), (4, 2),
                        RULES, str(path), STEPS, LR, str(ckpt), timeout=TIMEOUT)
    return results, ckpt


def test_sharded_forward_equals_unsharded(lm_reference, tmp_path):
    results = run_world(sharded.lm_forward_rank, 4, tmp_path / "out", (2, 2), RULES,
                        str(lm_reference[0]), timeout=TIMEOUT)
    for r in results:
        assert str(r["placements"]) == "(Shard(dim=0), Replicate())"
        np.testing.assert_allclose(r["got"], r["want"], rtol=0, atol=1e-5)


def test_sharded_steps_match_reference(lm_reference, lm_trained):
    _, want_losses, want_norms = lm_reference
    results, _ = lm_trained
    for r in results:
        np.testing.assert_allclose(r["losses"], want_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"][0], want_norms[0], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"][1:], want_norms[1:], rtol=NORM_RTOL)
        assert r["losses"][-1] < r["losses"][0], r["losses"]


def test_sharded_step_updates_every_parameter(lm_reference, lm_trained):
    """One sharded step equals the port's unsharded step where the gradient
    is clear of float32 noise (|g| above ``CLEAR`` of its leaf's largest:
    within ``STEP1_ATOL``), and is within 2 * lr elsewhere (AdamW's first
    update is about lr * sign(g)). A sharded leaf that AdamW gathered and
    then left unchanged would be ~lr away on every clear entry."""
    a = np.load(lm_reference[0])
    cfg, model = sharded._lm_from_inputs(a)
    opt = AdamW(model.parameters(), AdamWConfig(lr=LR))
    steps._descend(opt, tfm.loss_fn(model, torch.from_numpy(a["tokens"]), cfg), LR)
    results, _ = lm_trained
    for path, p in model.named_parameters():
        want, g = p.detach().numpy(), np.abs(p.grad.numpy())
        clear = g > CLEAR * g.max()
        assert np.abs(want - a[f"w/{path}"])[clear].min() > 0.5 * LR, path
        for r in results:
            got = r[f"step1/{path}"]
            np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=STEP1_ATOL,
                                       err_msg=path)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR, err_msg=path)


def test_sharded_parameters_follow_the_rules(lm_trained):
    """Each rank holds its shard: heads, FFN columns and vocabulary split in
    two over ``model``, the rest whole (the data axis shards no leaf)."""
    cfg = smoke_lm_config(ARCH)
    specs = dict(iter_specs(tfm.param_specs(cfg)))
    split = {"embed": 0, "lm_head": 1, "layers.wq": 2, "layers.wk": 2, "layers.wv": 2,
             "layers.wo": 1, "layers.w1": 2, "layers.w2": 1}
    for r in lm_trained[0]:
        for path, spec in specs.items():
            want = list(spec.shape)
            if path in split:
                want[split[path]] //= 2
            assert r[f"local/{path}"].tolist() == want, path


def test_restore_onto_another_mesh_is_exact(lm_trained, tmp_path):
    results, ckpt = lm_trained
    restored = run_world(sharded.lm_restore_rank, 4, tmp_path / "out", (2, 2), RULES, ARCH,
                         str(ckpt), timeout=TIMEOUT)
    saved = {k[len("final/"):]: v for k, v in results[0].items() if k.startswith("final/")}
    assert saved
    for r in restored:
        assert int(r["step"]) == STEPS
        for path, w in saved.items():
            np.testing.assert_array_equal(r[f"restored/{path}"], w, err_msg=path)
        head = saved["lm_head"].shape
        assert r["local/lm_head"].tolist() == [head[0], head[1] // 2]


# ------------------------------------------------------------------ top-k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_topk_on_a_vocabulary_sharded_dtensor(tmp_path, seed):
    """Tied scores (integers 0..3): the indices are exactly the reference
    two-stage top-k's, which takes the lower index among ties."""
    scores = np.random.default_rng(seed).integers(0, 4, (4, 64)).astype(np.float32)
    path = tmp_path / "scores.npz"
    np.savez(path, scores=scores)
    want_v, want_i = jax.jit(lambda s: jsteps.sharded_topk(s, k=5, shards=4))(scores)
    results = run_world(sharded.topk_rank, 4, tmp_path / "out", (2, 2), str(path), 5, 4,
                        timeout=TIMEOUT)
    for r in results:
        np.testing.assert_array_equal(r["indices"], np.asarray(want_i))
        np.testing.assert_array_equal(r["values"], np.asarray(want_v))
        np.testing.assert_array_equal(r["local_indices"], np.asarray(want_i))
