"""Run a function on a gloo world of CPU processes, for tests.

:func:`run_world` spawns one process per rank (a fresh interpreter each,
``spawn``), joins them into one gloo group through a file store, calls the
function on every rank, joins them all within ``timeout`` seconds and kills
what is left, so a hang fails the caller instead of blocking it. A rank
writes the dict of numpy arrays that the function returns to
``rank<r>.npz``, or the error it raised to ``rank<r>.err``. The function
travels by import path, so it lives in the port (the ranks import only
the port); its inputs and outputs travel as ``.npz`` files and plain
arguments.

:func:`run_sharded` runs :func:`repro_torch.core.mwm_rounds_sharded` on
such a world.
"""
from __future__ import annotations

import multiprocessing
import pathlib
import time
import traceback

import numpy as np


def _rank(rank: int, world: int, fn, args: tuple, out_dir: str):
    import torch.distributed as dist

    out = pathlib.Path(out_dir)
    try:
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        np.savez(out / f"rank{rank}.npz", **(result or {}))
    except Exception:  # the parent reads the traceback; the exit code says it failed
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_world(fn, world: int, out_dir, *args, timeout: float = 60.0) -> list[dict]:
    """Call ``fn(*args)`` on each of ``world`` spawned ranks of one gloo group
    (``fn`` a module-level function of the port; ``torch.distributed``'s rank
    tells the ranks apart); returns each rank's result as a dict of numpy
    arrays. Raises ``RuntimeError`` naming the ranks that failed or hung."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, fn, tuple(args), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        errors = {r: (out / f"rank{r}.err").read_text() for r in failed
                  if (out / f"rank{r}.err").exists()}
        raise RuntimeError(f"ranks {failed} failed (hung: {hung}): {errors}")
    results = []
    for r in range(world):
        with np.load(out / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return results


def _rounds_rank(shape, inputs: str) -> dict:
    from repro_torch.convert import config_from_reference, stream_from_arrays
    from repro_torch.core import mwm_rounds_sharded
    from repro_torch.distributed import RemeshPlan, build_mesh

    mesh = build_mesh(RemeshPlan(data=shape[0], model=shape[1], pod=0, dropped_devices=0),
                      device_type="cpu")
    a = np.load(inputs)
    stream = stream_from_arrays(a["src"], a["dst"], a["weight"], a["valid"], device="cpu")
    cfg = config_from_reference(int(a["n"]), int(a["L"]), float(a["eps"]), a["thresholds"])
    res = mwm_rounds_sharded(stream, cfg, mesh)
    return {"assigned": res.assigned.numpy(), "mb": res.mb.numpy()}


def run_sharded(shape, inputs, out_dir, timeout: float = 60.0) -> list:
    """Run a ``(data, model)`` mesh of ``data * model`` ranks over the
    stream in ``inputs`` (``src``, ``dst``, ``weight``, ``valid``, ``n``,
    ``L``, ``eps``, ``thresholds``); returns each rank's ``(assigned, mb)``.
    Raises ``RuntimeError`` naming the ranks that failed or hung."""
    results = run_world(_rounds_rank, shape[0] * shape[1], out_dir, tuple(shape), str(inputs),
                        timeout=timeout)
    return [(r["assigned"], r["mb"]) for r in results]


# ------------------------------------------------------------ sharded LM ranks


def smoke_lm_config(arch_id: str):
    """The arch's smoke config in float32 with ``vocab_pad_to=8``, as the JAX
    package's multi-device test builds it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch_id).smoke_config, param_dtype=torch.float32,
                               vocab_pad_to=8)


def _lm_from_inputs(a):
    """The smoke LM on the CPU holding the weights ``w/<path>`` and the RoPE
    vector ``rope_freqs`` of the ``.npz`` ``a``."""
    import torch

    from repro_torch.models import transformer as tfm

    cfg = smoke_lm_config(str(a["arch"]))
    model = tfm.Transformer(cfg, device="cpu")
    with torch.no_grad():
        for path, p in model.named_parameters():
            p.copy_(torch.from_numpy(a[f"w/{path}"]))
        model.rope_freqs.copy_(torch.from_numpy(a["rope_freqs"]))
    return cfg, model


def _leaf(tree, path: str):
    for key in path.split("."):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return tree


def _placed(prefix: str, tree, spec_tree) -> dict:
    """``{prefix/path: whole value}`` (a copy) and ``{local/path: this rank's
    shard shape}`` of a tree of DTensors (``full_tensor`` is a collective:
    every rank calls it)."""
    from repro_torch.models.param import iter_specs

    out = {}
    for path, _ in iter_specs(spec_tree):
        t = _leaf(tree, path).detach()
        out[f"{prefix}/{path}"] = t.full_tensor().numpy().copy()  # a replicated leaf's is its own
        out[f"local/{path}"] = np.asarray(t.to_local().shape)
    return out


#: the vectors whose rows ``shardings_rank`` reports, by the mesh axes that split them
ROW_SPLITS = {"pod_data": ("pod", "data"), "data_model": ("data", "model"), "model": "model"}


def shardings_rank(rules: dict, row_splits: list) -> dict:
    """On a (pod, data, model) = (2, 2, 2) mesh: the placements that
    ``shardings`` gives the smoke LM's leaves (``placements/<path>``) and its
    tokens (``placements/tokens``) under ``rules``, and the rows of
    ``arange(16)`` that this rank holds when split over each of
    ``ROW_SPLITS``' named axes (``rows/<name>``)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements, resolve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import iter_specs, shardings

    mesh = make_host_mesh(2, 2, pod=2, device="cpu")
    specs = tfm.param_specs(smoke_lm_config("gemma-7b"))
    placed = shardings(specs, rules, mesh)
    out = {f"placements/{path}": np.asarray(str(tuple(_leaf(placed, path).placements)))
           for path, _ in iter_specs(specs)}
    out["placements/tokens"] = np.asarray(str(placements(mesh, resolve(("dp", None), rules))))
    for name in row_splits:
        rows = distribute_tensor(torch.arange(16), mesh, placements(mesh, (ROW_SPLITS[name],)),
                                 src_data_rank=None)
        out[f"rows/{name}"] = rows.to_local().numpy()
    return out


def lm_forward_rank(shape, rules: dict, inputs: str) -> dict:
    """``backbone`` of the tokens under no gradient: without rules on the
    plain model (``want``), then under ``rules`` on a ``shape`` mesh with
    every parameter a DTensor (``got``, gathered)."""
    import torch

    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import distribute_params

    a = np.load(inputs)
    cfg, model = _lm_from_inputs(a)
    tokens = torch.from_numpy(a["tokens"])
    mesh = make_host_mesh(*shape, device="cpu")
    with torch.no_grad():
        want = tfm.backbone(model, tokens, cfg)
        distribute_params(model, tfm.param_specs(cfg), rules, mesh)
        with sharding_rules(rules), use_mesh(mesh):
            got = tfm.backbone(model, tokens, cfg)
    return {"want": want.numpy(), "got": got.full_tensor().numpy(),
            "placements": np.asarray(str(tuple(got.placements)))}


def lm_train_rank(shape, rules: dict, inputs: str, steps: int, lr: float,
                  ckpt_dir: str | None = None) -> dict:
    """``steps`` AdamW steps (``AdamWConfig(lr=lr)``) of the smoke LM on the
    tokens, with every parameter a DTensor on a ``shape`` mesh and ``rules``
    installed: each step's loss and gradient norm, the whole parameters
    after step 1 (``step1/<path>``) and after the last (``final/<path>``),
    each shard's shape (``local/<path>``); with ``ckpt_dir``, the parameters
    saved there at the last step (one writer)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _descend
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import distribute_params, param_tree
    from repro_torch.optim import AdamW, AdamWConfig

    a = np.load(inputs)
    cfg, model = _lm_from_inputs(a)
    specs = tfm.param_specs(cfg)
    mesh = make_host_mesh(*shape, device="cpu")
    distribute_params(model, specs, rules, mesh)
    opt = AdamW(model.parameters(), AdamWConfig(lr=lr))
    tokens = torch.from_numpy(a["tokens"])
    out, losses, norms = {}, [], []
    with sharding_rules(rules), use_mesh(mesh):
        for i in range(steps):
            res = _descend(opt, tfm.loss_fn(model, tokens, cfg), lr)
            losses.append(float(res["loss"]))
            norms.append(float(res["grad_norm"]))
            if i == 0:
                out |= _placed("step1", param_tree(model, specs), specs)
    out |= _placed("final", param_tree(model, specs), specs)
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir, async_save=False).save(steps, {"params": param_tree(model, specs)})
    return {**out, "losses": np.asarray(losses), "grad_norms": np.asarray(norms)}


def lm_restore_rank(shape, rules: dict, arch_id: str, ckpt_dir: str) -> dict:
    """The newest checkpoint of ``ckpt_dir`` restored onto a ``shape`` mesh
    (``abstract_params`` as the template, ``shardings`` under ``rules``): its
    step, each leaf whole (``restored/<path>``) and this rank's shard shapes."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import abstract_params, shardings

    specs = tfm.param_specs(smoke_lm_config(arch_id))
    mesh = make_host_mesh(*shape, device="cpu")
    step, restored = CheckpointManager(ckpt_dir, async_save=False).restore(
        {"params": abstract_params(specs)}, shardings={"params": shardings(specs, rules, mesh)})
    return {"step": np.asarray(step), **_placed("restored", restored["params"], specs)}


def topk_rank(shape, inputs: str, k: int, shards: int) -> dict:
    """``sharded_topk`` of the scores ``[B, V]`` placed with their columns
    over the mesh's ``model`` axis (rows replicated)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import sharded_topk

    mesh = make_host_mesh(*shape, device="cpu")
    scores = torch.from_numpy(np.load(inputs)["scores"])
    scores = distribute_tensor(scores, mesh, placements(mesh, (None, "model")), src_data_rank=None)
    v, i = sharded_topk(scores, k, shards)
    return {"values": v.full_tensor().numpy(), "indices": i.full_tensor().numpy(),
            "local_values": v.to_local().numpy(), "local_indices": i.to_local().numpy()}
