#!/usr/bin/env python3
"""Where a GIN step's time goes at the ogb_products dimensions (card only).

    python3 scripts/gnn_step_profile.py

GIN at gin-tu's width (5 layers, d = 64) on a ``make_gnn_batch(seed=0)``
batch of 2,449,152 nodes and 61,859,328 edges (100 features, 47 classes).
Prints JSON lines:

* ``steps``: CUDA-event ms of each of ``--steps`` train steps and the peak
  device memory;
* ``ops``: each of the three operations a layer's message passing runs
  once forward and once backward, timed alone at the step's shapes (CUDA
  events, the mean of 5): the row gather ``h.index_select(0, src)`` [E, 64],
  the edge mask ``masked_fill_`` on it, and the float32-atomic
  ``index_add`` into [N, 64]; each with its bytes bound (each input read
  once, each output written once, at 3.35 TB/s) and its achieved GB/s;
* ``profile``: one step under ``torch.profiler``: its CUDA-event ms, the
  device's busy ms (its kernels' and copies' time summed) and idle share,
  and the kernels that take most of it (``"device_time": "not measured"``
  when the profiler sees no device time).
"""
import argparse
import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.roofline import HBM_BW  # noqa: E402


def cuda_ms(fn, reps=1):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def emit(what, **fields):
    print(json.dumps({"what": what, **fields}), flush=True)


def _self_device_ms(evt) -> float:
    total = getattr(evt, "self_device_time_total", None)
    if total is None:
        total = getattr(evt, "self_cuda_time_total", 0.0)
    return total / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnn_step_profile: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import make_gnn_batch
    from repro_torch.launch.steps import (
        gnn_batch_dims,
        gnn_shape_config,
        make_gnn_model,
        make_gnn_train_step,
    )
    from repro_torch.optim import AdamW, AdamWConfig

    arch = get_arch("gin-tu")
    shape = arch.shapes["ogb_products"]
    cfg = gnn_shape_config(arch, shape)
    N, E = gnn_batch_dims(shape, cfg.edge_chunk)
    t0 = time.perf_counter()
    batch = make_gnn_batch(N, E, cfg.d_in, n_classes=shape.n_classes, seed=0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    model = make_gnn_model(arch, shape)
    opt_cfg = AdamWConfig()
    opt = AdamW(model.parameters(), opt_cfg)
    step = make_gnn_train_step(arch, shape, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    ms = [cuda_ms(lambda: step(model, opt, batch))[0] for _ in range(args.steps)]
    emit("steps", n=N, e=E, d=cfg.d_hidden, layers=cfg.n_layers, make_batch_s=gen_s, step_ms=ms,
         peak_bytes=torch.cuda.max_memory_allocated())

    d = cfg.d_hidden
    h = torch.randn(N, d, device="cuda")
    src, dst, keep = batch.src, batch.dst, batch.edge_mask
    drop = ~keep[:, None]
    msg = h.index_select(0, src)
    ops = {
        "gather": (lambda: h.index_select(0, src), N * d * 4 + E * 4 + E * d * 4),
        "mask": (lambda: msg.masked_fill_(drop, 0), E + 2 * E * d * 4),
        "index_add": (lambda: h.new_zeros((N, d)).index_add(0, dst, msg),
                      E * 4 + E * d * 4 + N * d * 4),
    }
    out = {}
    for name, (fn, nbytes) in ops.items():
        fn()
        t, _ = cuda_ms(fn, reps=5)
        out[name] = {"ms": t, "bytes": nbytes, "bound_ms": nbytes / HBM_BW * 1e3,
                     "achieved_GB_per_s": nbytes / (t * 1e-3) / 1e9}
    emit("ops", shape=[E, d], per_layer_forward_and_backward=2, ops=out)
    del h, msg, drop

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_ms, _ = cuda_ms(lambda: step(model, opt, batch))
    # the device's own events (kernels, copies, memsets): an operator's self
    # device time repeats its kernels'
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted((r for r in prof.key_averages() if r.device_type == cuda),
                  key=_self_device_ms, reverse=True)
    busy = sum(_self_device_ms(r) for r in rows)
    top = [{"name": r.key[:120], "calls": r.count, "device_ms": _self_device_ms(r)}
           for r in rows[:12]]
    if busy == 0:
        emit("profile", device_time="not measured", step_ms=step_ms)
    else:
        emit("profile", device_time="measured", step_ms=step_ms, device_busy_ms=busy,
             idle_share=max(0.0, 1 - busy / step_ms), top=top)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
