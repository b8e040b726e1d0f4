"""Multi-pod dry-run: every (arch x shape) step on the production meshes,
with per-device roofline terms, the JAX package's ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out build/dryrun_results.json] [--force]

The reference lowers and compiles each step for 512 forced host devices
and reads XLA's artifact. The port runs the step itself: in a fake world
of 256 (or 512) ranks played by one process (``launch/mesh.py``), every
parameter, optimizer moment and input a ``meta`` DTensor placed by the
production rules, so no data exists and no device is touched. One rank's
local ops are read by :class:`repro_torch.launch.components.LocalCosts`:

* LM cells: whole steps traced at 2 and 3 layers, their FLOPs, bytes,
  collectives and each phase's peak (the step's and the optimizer's)
  extrapolated linearly in L (every layer adds the same work, state, saved
  carry and optimizer temporaries; the larger phase peak taken), as
  ``cost_method`` records; ``parts`` splits the cost the reference's way
  (``components.lm_component_costs``: one layer x L, the head, the
  embedding, the optimizer, each traced alone), completed by what only
  the whole step does (``layer_rest`` a layer, ``rest`` once: the
  gradients' reductions onto the parameters' layout, the final norm, the
  stacked layers' slicing), so the parts add up to the whole step's cost;
* GNN and recsys cells: one whole step (the port's chunk loops are Python
  loops, so the trace counts every chunk and needs no trip-count
  correction: the reference's scan correction is 1 here, and so recorded).

Each record keeps the reference's keys: ``memory.peak_per_device``,
``flops_per_device``, ``bytes_per_device`` (the unfused upper bound),
``collectives``, ``model_flops``, ``roofline`` (at the H100's peaks),
``cost_method``, ``n_chips``, ``kind``, and the two timing keys: ``lower_s``
(building the step and placing its arguments) and ``compile_s`` (the
traces). Results go to ``--out`` (default under ``build/``), one record per
(arch, shape, mesh), resumable: cells already there are skipped unless
``--force``. A failing cell is recorded with its error and traceback, and
the command exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import all_arch_ids, get_arch
from repro_torch.configs.registry import ArchSpec, ShapeSpec
from repro_torch.distributed.sharding import placements, use_mesh
from repro_torch.launch.components import LocalCosts, lm_component_costs
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.roofline import roofline_terms, useful_flops
from repro_torch.launch.steps import (BuiltStep, build_step, default_opt_cfg, gnn_batch_dims,
                                      gnn_shape_config, gnn_state_specs, make_gnn_model)
from repro_torch.models import bert4rec as b4r
from repro_torch.models import transformer as tfm
from repro_torch.models.param import distribute_params
from repro_torch.optim import AdamW, AdamWConfig

DEFAULT_OUT = os.path.join("build", "dryrun_results.json")
#: an LM's peak is traced at these depths and extrapolated linearly in L
#: (one layer is not yet in the per-layer regime: its step carries less)
PEAK_DEPTHS = (2, 3)


def _model(arch: ArchSpec, shape: ShapeSpec, rules: dict, mesh):
    """The arch's model on ``meta`` (nothing drawn), every parameter placed
    on ``mesh`` by ``rules``."""
    if arch.family == "lm":
        model, specs = tfm.Transformer(arch.config, device="meta"), tfm.param_specs(arch.config)
    elif arch.family == "gnn":
        model = make_gnn_model(arch, shape, device="meta")
        specs = gnn_state_specs(arch, shape, AdamWConfig())[0]
    else:
        model, specs = b4r.Bert4Rec(arch.config, device="meta"), b4r.param_specs(arch.config)
    return distribute_params(model, specs, rules, mesh)


def _place(tree, pspecs, mesh):
    """``meta`` tensors as DTensors on ``mesh`` with their :class:`PSpec`s."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, mesh, placements(mesh, tuple(pspecs)), src_data_rank=None)
    return {k: _place(v, pspecs[k], mesh) for k, v in tree.items()}


def trace_step(bs: BuiltStep, arch: ArchSpec, shape: ShapeSpec, mesh,
               opt_cfg: AdamWConfig | None = None) -> dict:
    """One whole step of ``bs`` (built on ``meta``) on ``mesh``: the model
    and optimizer state placed by ``bs.rules`` (the Adam moments made up
    front, as after step 1), the batch by ``bs.arg_pspecs``, then the step
    under :class:`LocalCosts`. Returns the costs (``flops``, ``bytes``,
    ``collective_bytes``), ``collectives``, ``peak_bytes``,
    ``argument_bytes`` (alive when the step starts), ``setup_s`` and
    ``trace_s``."""
    t0 = time.perf_counter()
    with use_mesh(mesh):
        model = _model(arch, shape, bs.rules, mesh)
        batch = _place(bs.arg_specs[-1], bs.arg_pspecs[-1], mesh)
        args, tracked = (model, batch), [list(model.parameters()), batch]
        if shape.kind == "train":
            opt_cfg = opt_cfg or default_opt_cfg(arch)
            opt = AdamW(model.parameters(), opt_cfg)
            for p in model.parameters():
                opt.state[p]["m"] = torch.zeros_like(p, dtype=opt_cfg.moment_dtype)
                opt.state[p]["v"] = torch.zeros_like(p, dtype=opt_cfg.moment_dtype)
            args = (model, opt, batch)
            tracked.append([list(st.values()) for st in opt.state.values()])
        costs = LocalCosts()
        if shape.kind == "train":
            opt.register_step_pre_hook(lambda *_: setattr(costs, "phase", "optimizer"))
        costs.track(*tracked)
        argument_bytes = costs.live_bytes
        t1 = time.perf_counter()
        with costs:
            bs.fn(*args)
    return {**costs.record(), "collectives": costs.collective_totals(),
            "peak_bytes": costs.peak_bytes, "peaks": dict(costs.peaks),
            "argument_bytes": argument_bytes,
            "setup_s": t1 - t0, "trace_s": time.perf_counter() - t1}


def _with_layers(arch: ArchSpec, n: int) -> ArchSpec:
    return dataclasses.replace(arch, config=dataclasses.replace(arch.config, n_layers=n))


def extrapolate(values: dict, n: int) -> float:
    """The value at depth ``n`` of a quantity linear in the depth, from its
    ``{depth: value}`` at two depths."""
    (a, va), (b, vb) = sorted(values.items())
    return va + (n - a) * (vb - va) / (b - a)


def lm_peak(arch: ArchSpec, shape: ShapeSpec, mesh, multi_pod: bool,
            rules: dict | None = None, opt_cfg: AdamWConfig | None = None) -> dict:
    """An LM step's per-device peak and argument bytes at the arch's depth,
    from whole steps traced at :data:`PEAK_DEPTHS` layers."""
    L = arch.config.n_layers
    traced = {}
    for n in PEAK_DEPTHS if L > max(PEAK_DEPTHS) else (L,):
        a = _with_layers(arch, n)
        bs = build_step(a, shape, multi_pod=multi_pod, device="meta", rules=rules,
                        opt_cfg=opt_cfg or default_opt_cfg(arch))
        traced[n] = trace_step(bs, a, shape, mesh, opt_cfg or default_opt_cfg(arch))
    if len(traced) == 1:
        t = traced[L]
        return {"peak": t["peak_bytes"], "argument": t["argument_bytes"], "traces": traced}
    # each phase's peak is linear in L, but the phase that peaks may change
    phases = {ph: extrapolate({n: t["peaks"][ph] for n, t in traced.items()}, L)
              for ph in traced[PEAK_DEPTHS[0]]["peaks"]}
    return {"peak": max(phases.values()), "phases": phases,
            "argument": extrapolate({n: t["argument_bytes"] for n, t in traced.items()}, L),
            "traces": traced}


#: the costs a trace counts, per device
COSTS = ("flops", "bytes", "collective_bytes")


def lm_costs(parts: dict, traces: dict, L: int) -> tuple[dict, dict]:
    """An LM step's per-device costs at depth ``L`` (``COSTS`` and the
    collectives by kind) from whole steps traced at one or two depths
    (``{depth: trace_step record}``), and ``parts`` (the isolated
    component traces, a layer's with ``mult``) completed so that they add
    up to them: ``layer_rest`` (a layer's share that its isolated trace
    misses, ``mult`` L) and ``rest`` (the step's share that no part has)."""
    flat = {n: {**{k: t[k] for k in COSTS},
                **{f"collectives/{k}": v for k, v in t["collectives"].items()}}
            for n, t in traces.items()}
    if len(flat) == 1:
        (n, t), = flat.items()
        total, per_layer = dict(t), None
    else:
        keys = {k for t in flat.values() for k in t}  # a kind of collective may start at depth 3
        total = {k: extrapolate({n: t.get(k, 0.0) for n, t in flat.items()}, L) for k in keys}
        (a, ta), (b, tb) = sorted(flat.items())
        per_layer = {k: (tb[k] - ta[k]) / (b - a) for k in COSTS}
    parts = {name: dict(c) for name, c in parts.items()}
    layer = parts["layer"]
    if per_layer is not None:
        parts["layer_rest"] = {**{k: per_layer[k] - layer[k] for k in COSTS}, "mult": L}
    parts["rest"] = {k: total[k] - sum(c.get("mult", 1) * c[k] for c in parts.values())
                     for k in COSTS}
    collectives = {k.removeprefix("collectives/"): v for k, v in sorted(total.items())
                   if k.startswith("collectives/")}
    collectives["n_ops"] = int(round(collectives.get("n_ops", 0)))
    return {k: total[k] for k in COSTS}, {"collectives": collectives, "parts": parts}


def _memory(peak: float, argument: float) -> dict:
    return {"argument_bytes": int(argument), "temp_bytes": int(peak - argument),
            "peak_per_device": int(peak)}


def cell_record(arch: ArchSpec, shape: ShapeSpec, mesh, multi_pod: bool,
                rules: dict | None = None, opt_cfg: AdamWConfig | None = None) -> dict:
    """The dry-run record of one cell on ``mesh`` (an open fake world's), its
    steps placed by ``rules`` (default: the production rules)."""
    n_chips = mesh.size()
    t0 = time.perf_counter()
    bs = build_step(arch, shape, multi_pod=multi_pod, device="meta", rules=rules, opt_cfg=opt_cfg)
    rec = {"arch": arch.id, "shape": shape.name,
           "mesh": "x".join(str(s) for s in mesh.shape), "n_chips": n_chips, "kind": bs.kind}
    if arch.family == "lm":
        lower = time.perf_counter() - t0
        t1 = time.perf_counter()
        parts = lm_component_costs(arch, shape, mesh, multi_pod, opt_cfg, rules=bs.rules)
        peak = lm_peak(arch, shape, mesh, multi_pod, bs.rules, opt_cfg)
        lower += sum(t["setup_s"] for t in peak["traces"].values())
        rec["cost_method"] = ("component; whole steps traced at "
                              + " and ".join(str(n) for n in peak["traces"])
                              + f" layers, linear in L = {arch.config.n_layers}")
        rec["memory"] = _memory(peak["peak"], peak["argument"])
        total, extra = lm_costs(parts, peak["traces"], arch.config.n_layers)
        rec["flops_per_device"] = total["flops"]
        rec["bytes_per_device"] = total["bytes"]
        rec.update(extra)
        compile_s = time.perf_counter() - t1 - sum(t["setup_s"] for t in peak["traces"].values())
    else:
        t = trace_step(bs, arch, shape, mesh, opt_cfg)
        lower, compile_s = time.perf_counter() - t0 - t["trace_s"], t["trace_s"]
        scan_corr = 1
        if arch.family == "gnn":
            gcfg = gnn_shape_config(arch, shape)
            if gcfg.edge_chunk:  # the reference's trip count; the trace ran every chunk
                scan_corr = gnn_batch_dims(shape, gcfg.edge_chunk)[1] // gcfg.edge_chunk
        rec["cost_method"] = ("whole-program" if scan_corr == 1 else
                              f"whole-program, {scan_corr} chunks traced (the reference's "
                              f"scan correction x{scan_corr} is the trace's own loop)")
        rec["memory"] = _memory(t["peak_bytes"], t["argument_bytes"])
        rec["flops_per_device"] = t["flops"]
        rec["bytes_per_device"] = t["bytes"]
        rec["collectives"] = t["collectives"]
    rec["lower_s"] = round(lower, 2)
    rec["compile_s"] = round(compile_s, 2)
    rec["model_flops"] = useful_flops(arch, shape)
    rec["roofline"] = roofline_terms(rec)
    return rec


#: the calibration's bands: predicted peak over measured, and FLOPs' relative error
PEAK_BAND = (0.8, 1.25)
FLOPS_RTOL = 0.01


def calibrate(arch: ArchSpec, shape: ShapeSpec, rules: dict, measured: dict,
              opt_cfg: AdamWConfig | None = None, device=None, seed: int = 0) -> dict:
    """Hold the dry-run's model of an LM train step to a run of it on one
    card: the step's record on a 1x1 fake world (its DTensors placed by
    ``rules``, as a 1x1 mesh of one card places them) against
    ``measured["peak_bytes"]`` (``torch.cuda.max_memory_allocated`` over
    such steps) and ``measured["step_ms"]``, and its FLOPs against
    ``FlopCounterMode`` over one step of the model built on ``device`` (None:
    the card; ``RuntimeError`` without one) from ``seed``. ``ok`` when the
    predicted peak is within :data:`PEAK_BAND` of the measured, the FLOPs
    within :data:`FLOPS_RTOL` and ``step_time_lower_bound_s`` at most the
    measured step."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.types import resolve_device
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_lm_train_step

    dev = resolve_device(device)
    opt_cfg = opt_cfg or default_opt_cfg(arch)
    with fake_world(1):
        mesh = DeviceMesh(dev.type, torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
        rec = cell_record(arch, shape, mesh, False, rules=rules, opt_cfg=opt_cfg)
    gen = torch.Generator(dev.type).manual_seed(seed) if dev.type == "cuda" else None
    model = tfm.Transformer(arch.config, device=dev, seed=seed, generator=gen)
    opt = AdamW(model.parameters(), opt_cfg)
    tokens = TokenPipeline(arch.config.vocab, shape.global_batch, shape.seq_len, seed=seed,
                           device=dev).batch_at(0)
    counter = FlopCounterMode(display=False)
    with counter:
        make_lm_train_step(arch, shape, opt_cfg, dev)(model, opt, {"tokens": tokens})
    del model, opt
    flops = counter.get_total_flops()
    peak_ratio = rec["memory"]["peak_per_device"] / measured["peak_bytes"]
    flops_rel = abs(rec["flops_per_device"] - flops) / flops
    bound_s = rec["roofline"]["step_time_lower_bound_s"]
    ok = (PEAK_BAND[0] <= peak_ratio <= PEAK_BAND[1] and flops_rel <= FLOPS_RTOL
          and bound_s <= measured["step_ms"] / 1e3)
    return {"record": rec, "measured": {**measured, "flops": flops}, "peak_ratio": peak_ratio,
            "peak_band": PEAK_BAND, "flops_rel_err": flops_rel, "flops_rtol": FLOPS_RTOL,
            "lower_bound_s": bound_s, "ok": ok}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool) -> dict:
    """The record of (arch, shape) on the production mesh, in a fake world
    of 256 ranks (512 with ``multi_pod``) opened and closed here."""
    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    with fake_world(512 if multi_pod else 256):
        return cell_record(arch, shape, make_production_mesh(multi_pod=multi_pod), multi_pod)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape name")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    results: dict[str, dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    arch_ids = [args.arch] if args.arch else all_arch_ids()
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        shape_names = [args.shape] if args.shape else list(arch.shapes)
        for shape_name in shape_names:
            for multi_pod in meshes:
                key = f"{arch_id}|{shape_name}|{'multi' if multi_pod else 'single'}"
                if key in results and not args.force and "error" not in results[key]:
                    print(f"skip {key} (cached)", flush=True)
                    continue
                print(f"=== {key}", flush=True)
                try:
                    rec = run_cell(arch_id, shape_name, multi_pod)
                    print(f"    ok lower={rec['lower_s']}s compile={rec['compile_s']}s "
                          f"flops/dev={rec['flops_per_device']:.3e} "
                          f"peak/dev={rec['memory']['peak_per_device'] / 2**30:.2f}GiB",
                          flush=True)
                except Exception as e:  # the CLI's boundary: recorded with its traceback
                    n_fail += 1
                    rec = {"arch": arch_id, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"    FAIL {rec['error'][:200]}", flush=True)
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    print(f"done; {n_fail} failures", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
