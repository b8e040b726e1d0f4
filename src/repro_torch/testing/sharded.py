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


# ------------------------------------------------------ production rules


def _whole(t):
    """A tensor's whole value as numpy (a DTensor's gathered: a collective)."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def production_rules_rank(shape, cases: list) -> dict:
    """Each case of ``cases`` (``name``, ``arch``, ``rules``: the shape whose
    production ``arch_rules`` of the arch's published config are used,
    ``kind``: train, prefill or decode, ``batch``, ``seq``, ``config``:
    overrides of both configs, ``inputs``: an ``.npz`` of the weights
    ``w/<path>``, ``rope_freqs``, the ``tokens`` [batch, seq], a decode
    step's ``cache_k``, ``cache_v`` and ``token``) on the arch's smoke
    config (float32, ``vocab_pad_to=8``), twice: plain, and with every
    parameter and input a DTensor on a ``shape`` mesh under the rules.
    Returns ``<name>/want/<key>`` and ``<name>/got/<key>``: a train step's
    loss, gradient norm and every gradient (``grad/<path>``); a prefill's
    last logits and cache; a decode step's logits and the committed cache."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.components import place
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param import distribute_params
    from repro_torch.optim import AdamW, AdamWConfig

    mesh = make_host_mesh(*shape, device="cpu")
    out = {}
    for case in cases:
        over = case.get("config", {})
        full = get_arch(case["arch"])
        full = dataclasses.replace(full, config=dataclasses.replace(full.config, **over))
        cfg = dataclasses.replace(smoke_lm_config(case["arch"]), **over)
        arch = dataclasses.replace(full, config=cfg)
        rules = steps.arch_rules(full, full.shapes[case["rules"]], False)
        kind, B, S = case["kind"], case["batch"], case["seq"]
        shape_spec = ShapeSpec(case["name"], kind, seq_len=S, global_batch=B)
        a = np.load(case["inputs"])
        tokens = torch.from_numpy(a["tokens"])
        for tag, placed in (("want", False), ("got", True)):
            model = tfm.Transformer(cfg, device="cpu")
            with torch.no_grad():
                for path, p in model.named_parameters():
                    p.copy_(torch.from_numpy(a[f"w/{path}"]))
                model.rope_freqs.copy_(torch.from_numpy(a["rope_freqs"]))
            key = f"{case['name']}/{tag}"
            with contextlib.ExitStack() as stack:
                if placed:
                    distribute_params(model, tfm.param_specs(cfg), rules, mesh)
                    stack.enter_context(sharding_rules(rules))
                    stack.enter_context(use_mesh(mesh))
                lay = (lambda t, *names: place(t, names, rules, mesh)) if placed else (
                    lambda t, *names: t)
                if kind == "train":
                    opt_cfg = AdamWConfig(lr=1e-2)
                    res = steps.make_lm_train_step(arch, shape_spec, opt_cfg, device="cpu")(
                        model, AdamW(model.parameters(), opt_cfg), {"tokens": lay(tokens, "dp", None)})
                    out[f"{key}/loss"] = np.asarray(float(res["loss"]))
                    out[f"{key}/grad_norm"] = np.asarray(float(res["grad_norm"]))
                    for path, p in model.named_parameters():
                        out[f"{key}/grad/{path}"] = _whole(p.grad)
                elif kind == "prefill":
                    c, logits = steps.make_lm_prefill(arch, shape_spec, device="cpu")(
                        model, {"tokens": lay(tokens, "dp", None)})
                    out[f"{key}/logits"] = _whole(logits)
                    for k in ("k", "v"):
                        out[f"{key}/cache_{k}"] = _whole(c[k])
                else:
                    logical = ("layers", "cache_batch", "seq", "kv_heads", None)
                    batch = {"cache": {k: lay(torch.from_numpy(a[f"cache_{k}"]), *logical)
                                       for k in ("k", "v")},
                             "token": lay(torch.from_numpy(a["token"]), "cache_batch")}
                    logits, c = steps.make_lm_decode(arch, shape_spec, device="cpu")(model, batch)
                    out[f"{key}/logits"] = _whole(logits)
                    for k in ("k", "v"):
                        out[f"{key}/cache_{k}"] = _whole(c[k])
    return out


#: the logical names of a GNN batch's inputs (``steps.gnn_input_specs``')
GNN_LOGICAL = {"node_feats": ("nodes", None), "src": ("edges",), "dst": ("edges",),
               "edge_mask": ("edges",), "node_mask": ("nodes",), "label_mask": ("nodes",),
               "coords": ("nodes", None)}


def gnn_arrays(arch_id: str, cfg, n: int, e: int, n_chunks: int, seed: int = 3) -> dict:
    """A batch of ``n`` nodes and ``e`` edges as numpy arrays, on the
    ``src_blocked`` contract (chunk i of ``n_chunks`` has its sources in
    node block i), a few nodes and edges masked, and each chunk's first
    edges repeated further on (two edges of one chunk with the same
    message: their logits tie)."""
    rng = np.random.default_rng(seed)
    nb, c = -(-n // n_chunks), e // n_chunks
    src = np.concatenate([rng.integers(i * nb, min((i + 1) * nb, n), c) for i in range(n_chunks)])
    dst = rng.integers(0, n, e)
    for i in range(n_chunks):  # ties: edge k of the chunk again at k + c / 2
        lo = i * c
        src[lo + c // 2:lo + c // 2 + 3], dst[lo + c // 2:lo + c // 2 + 3] = src[lo:lo + 3], dst[lo:lo + 3]
    node_mask = np.ones(n, bool)
    node_mask[-3:] = False
    if arch_id == "gin-tu":
        labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)
    else:
        labels = rng.normal(size=(n, cfg.d_out)).astype(np.float32)
    return {"node_feats": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
            "src": src.astype(np.int32), "dst": dst.astype(np.int32),
            "edge_mask": (src != dst) & (rng.random(e) > 0.1), "node_mask": node_mask,
            "labels": labels, "label_mask": node_mask & (rng.random(n) > 0.2),
            "coords": rng.normal(size=(n, 3)).astype(np.float32)}


def rank_chunk_order(e: int, n_chunks: int, n_shards: int) -> np.ndarray:
    """The permutation that lays out ``e`` edges in ``n_chunks`` chunks of
    consecutive rows for a run whose edges are split in ``n_shards`` blocks:
    in that run chunk i is the i-th part of every block, so part i of block
    b gets the b-th slice of the unsplit layout's chunk i."""
    c = e // n_chunks
    part = c // n_shards
    return np.asarray([i * c + b * part + k for b in range(n_shards)
                       for i in range(n_chunks) for k in range(part)])


def gnn_rules_rank(shape, cases: list) -> dict:
    """Each case of ``cases`` (``name``, ``arch``, ``rules``: the shape
    whose production ``arch_rules`` are used, ``config``: overrides of the
    smoke config, ``n``, ``e``), from seed 0, one AdamW step of the GNN
    twice: plain, and with every parameter and input a DTensor on a
    ``shape`` mesh under the rules (the edges laid out by
    :func:`rank_chunk_order`, so both runs' chunks hold the same edges).
    Returns ``<name>/want/<key>`` and ``<name>/got/<key>``: the loss, the
    gradient norm and every gradient (``grad/<path>``)."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.components import place
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.param import distribute_params
    from repro_torch.optim import AdamW, AdamWConfig

    mesh = make_host_mesh(*shape, device="cpu")
    out = {}
    for case in cases:
        full = get_arch(case["arch"])
        cfg = dataclasses.replace(full.smoke_config, **case.get("config", {}))
        arch = dataclasses.replace(full, config=cfg)
        shape_spec = full.shapes[case["rules"]]
        rules = steps.arch_rules(full, shape_spec, False)
        n, e = case["n"], case["e"]
        nc = e // cfg.edge_chunk if cfg.edge_chunk else 1
        arrays = gnn_arrays(case["arch"], cfg, n, e, nc)
        mod = steps._gnn_module(arch)
        opt_cfg = AdamWConfig(lr=1e-2)
        for tag, placed in (("want", False), ("got", True)):
            model = mod.MODEL(cfg, device="cpu", seed=0)
            key = f"{case['name']}/{tag}"
            batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
            with contextlib.ExitStack() as stack:
                if placed:
                    distribute_params(model, mod.param_specs(cfg), rules, mesh)
                    stack.enter_context(sharding_rules(rules))
                    stack.enter_context(use_mesh(mesh))
                    edges = place(batch["src"], ("edges",), rules, mesh)
                    n_shards = edges.numel() // edges.to_local().numel()
                    perm = torch.from_numpy(rank_chunk_order(e, nc, n_shards))
                    logical = {**GNN_LOGICAL,
                               "labels": ("nodes",) if batch["labels"].dim() == 1 else ("nodes", None)}
                    batch = {k: place(v.index_select(0, perm) if logical[k] == ("edges",) else v,
                                      logical[k], rules, mesh) for k, v in batch.items()}
                res = steps.make_gnn_train_step(arch, shape_spec, opt_cfg, device="cpu")(
                    model, AdamW(model.parameters(), opt_cfg), batch)
                out[f"{key}/loss"] = np.asarray(float(res["loss"]))
                out[f"{key}/grad_norm"] = np.asarray(float(res["grad_norm"]))
                for path, p in model.named_parameters():  # a parameter the loss misses: zeros
                    out[f"{key}/grad/{path}"] = _whole(torch.zeros_like(p) if p.grad is None
                                                       else p.grad)
    return out


def recsys_rules_rank(shape, cases: list) -> dict:
    """Each case of ``cases`` (``name``, ``rules``: the BERT4Rec shape whose
    production ``arch_rules`` are used, ``kind``, ``batch``, ``config``:
    overrides of the smoke config, ``n_candidates`` for retrieval), from
    seed 0, the step twice: plain, and with every parameter and input a
    DTensor on a ``shape`` mesh under the rules. Returns
    ``<name>/want/<key>`` and ``<name>/got/<key>``: a serving step's top-100
    values and ids; a train step's loss, gradient norm and gradients."""
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.distributed import sharding_rules, use_mesh
    from repro_torch.launch import steps
    from repro_torch.launch.components import place
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models.param import distribute_params
    from repro_torch.optim import AdamW, AdamWConfig

    mesh = make_host_mesh(*shape, device="cpu")
    out = {}
    full = get_arch("bert4rec")
    for case in cases:
        cfg = dataclasses.replace(full.smoke_config, **case.get("config", {}))
        arch = dataclasses.replace(full, config=cfg)
        rules = steps.arch_rules(full, full.shapes[case["rules"]], False)
        shape_spec = ShapeSpec(case["name"], case["kind"], batch=case["batch"],
                               n_candidates=case.get("n_candidates", 0))
        specs = steps.recsys_input_specs(arch, shape_spec)
        rng = np.random.default_rng(5)
        arrays = {k: rng.integers(0, cfg.item_vocab, s.shape).astype(np.int32)
                  for k, s in specs.items() if k not in ("mask_pos", "neg_logq", "context_ids")}
        arrays["context_ids"] = rng.integers(0, 64, specs["context_ids"].shape).astype(np.int32)
        if "mask_pos" in specs:
            arrays["mask_pos"] = rng.integers(0, cfg.seq_len, specs["mask_pos"].shape).astype(np.int32)
            arrays["neg_logq"] = rng.normal(size=specs["neg_logq"].shape).astype(np.float32)
        opt_cfg = AdamWConfig(lr=1e-2)
        for tag, placed in (("want", False), ("got", True)):
            model = b4r.Bert4Rec(cfg, device="cpu", seed=0)
            key = f"{case['name']}/{tag}"
            batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
            with contextlib.ExitStack() as stack:
                if placed:
                    distribute_params(model, b4r.param_specs(cfg), rules, mesh)
                    stack.enter_context(sharding_rules(rules))
                    stack.enter_context(use_mesh(mesh))
                    batch = {k: place(v, specs[k].logical, rules, mesh) for k, v in batch.items()}
                step = steps.make_recsys_step(arch, shape_spec, opt_cfg, device="cpu")
                if case["kind"] == "train":
                    res = step(model, AdamW(model.parameters(), opt_cfg), batch)
                    out[f"{key}/loss"] = np.asarray(float(res["loss"]))
                    out[f"{key}/grad_norm"] = np.asarray(float(res["grad_norm"]))
                    for path, p in model.named_parameters():
                        out[f"{key}/grad/{path}"] = _whole(p.grad)
                else:
                    values, ids = step(model, batch)
                    out[f"{key}/values"], out[f"{key}/ids"] = _whole(values), _whole(ids)
    return out
