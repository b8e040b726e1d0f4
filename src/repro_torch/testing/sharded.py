"""Run :func:`repro_torch.core.mwm_rounds_sharded` on a gloo mesh of CPU
processes, for tests.

:func:`run_sharded` spawns one process per rank (a fresh interpreter each,
``spawn``), joins them all within ``timeout`` seconds and kills what is left,
so a hang fails the caller instead of blocking it. Each rank loads the
stream and the thresholds from an ``.npz`` file, builds the mesh with
:func:`repro_torch.distributed.build_mesh` and writes the result it
returns to ``rank<r>.npz`` beside it, or the error it raised to
``rank<r>.err``.
"""
from __future__ import annotations

import multiprocessing
import pathlib
import time
import traceback

import numpy as np


def _rank(rank: int, world: int, shape, inputs: str, out_dir: str):
    import torch.distributed as dist

    from repro_torch.convert import config_from_reference, stream_from_arrays
    from repro_torch.core import mwm_rounds_sharded
    from repro_torch.distributed import RemeshPlan, build_mesh

    out = pathlib.Path(out_dir)
    try:
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
        try:
            mesh = build_mesh(RemeshPlan(data=shape[0], model=shape[1], pod=0, dropped_devices=0),
                              device_type="cpu")
            a = np.load(inputs)
            stream = stream_from_arrays(a["src"], a["dst"], a["weight"], a["valid"], device="cpu")
            cfg = config_from_reference(int(a["n"]), int(a["L"]), float(a["eps"]), a["thresholds"])
            res = mwm_rounds_sharded(stream, cfg, mesh)
            np.savez(out / f"rank{rank}.npz", assigned=res.assigned.numpy(), mb=res.mb.numpy())
        finally:
            dist.destroy_process_group()
    except Exception:  # the parent reads the traceback; the exit code says it failed
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_sharded(shape, inputs, out_dir, timeout: float = 60.0) -> list:
    """Run a ``(data, model)`` mesh of ``data * model`` ranks over the
    stream in ``inputs`` (``src``, ``dst``, ``weight``, ``valid``, ``n``,
    ``L``, ``eps``, ``thresholds``); returns each rank's ``(assigned, mb)``.
    Raises ``RuntimeError`` naming the ranks that failed or hung."""
    world = shape[0] * shape[1]
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, tuple(shape), str(inputs), str(out)))
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
            results.append((z["assigned"], z["mb"]))
    return results
