#!/usr/bin/env python3
"""Where an LM or BERT4Rec train step's time and memory go (card only).

    python3 scripts/lm_train_profile.py --batch 4 --select --profile
    python3 scripts/lm_train_profile.py --recsys-batch 8192

LM: minicpm-2b at its published config (40 layers, d 2,304, bf16 weights
drawn on the card, float32 moments: ``default_opt_cfg``) on ``train_4k``'s
4,096 tokens a sequence, ``--batch`` sequences from ``TokenPipeline(seed=0)``
through ``make_lm_train_step``. BERT4Rec: its published config on
``--recsys-batch`` users of ``RecsysPipeline(seed=0)`` through
``make_recsys_step``'s train kind.
Prints JSON lines:

* ``device``: the card's name and power limit (``nvidia-smi``);
* ``lm_steps`` / ``recsys_steps``: CUDA-event ms of each of ``--steps``
  steps, the loss and gradient norm of each, the peak device memory and
  the bytes of the state (weights, gradients, moments);
* ``select`` (``--select``): the same steps with each layer's slice of the
  stacked leaves taken by plain indexing (autograd's select-backward: a
  zero tensor of the whole leaf per layer, summed), beside the port's
  ``_LayerSlice`` (each layer's gradient written into one buffer), then
  ``_LayerSlice`` again;
* ``gather`` (``--gather``, BERT4Rec): the same steps with the table rows
  read by indexing (``table[ids]``: its backward is ``index_put_`` with
  ``accumulate``, which walks an id's duplicates one after another) beside
  the port's ``take_rows`` (``F.embedding``: sorted segments);
* ``profile`` (``--profile``): one step (the LM's, else BERT4Rec's) under
  ``torch.profiler``: its CUDA-event ms, the device's busy ms (kernels,
  copies and memsets; the optimizer's annotation left out) and idle
  share, and the kernels that take most of it (``"device_time": "not
  measured"`` when the profiler sees no device time).

A batch that does not fit raises ``torch.OutOfMemoryError``: run one
batch a process.
"""
import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def cuda_ms(fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def emit(what, **fields):
    print(json.dumps({"what": what, **fields}), flush=True)


def _self_device_ms(evt) -> float:
    total = getattr(evt, "self_device_time_total", None)
    if total is None:
        total = getattr(evt, "self_cuda_time_total", 0.0)
    return total / 1e3


def _state_bytes(model, opt) -> dict:
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    moments = sum(t.numel() * t.element_size() for st in opt.state.values()
                  for k, t in st.items() if k in ("m", "v"))
    return {"weights": weights, "gradients": weights, "moments": moments}


def _profile(label, step):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_ms, _ = cuda_ms(lambda: step(0))
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type == cuda and not r.key.startswith("Optimizer.")),
                  key=_self_device_ms, reverse=True)
    busy = sum(_self_device_ms(r) for r in rows)
    top = [{"name": r.key[:120], "calls": r.count, "device_ms": _self_device_ms(r)}
           for r in rows[:20]]
    if busy == 0:
        emit("profile", of=label, device_time="not measured", step_ms=step_ms)
    else:
        emit("profile", of=label, device_time="measured", step_ms=step_ms, device_busy_ms=busy,
             idle_share=max(0.0, 1 - busy / step_ms), top=top)


def _run(step, n):
    out = []
    for i in range(n):
        ms, res = cuda_ms(lambda: step(i))
        out.append({"ms": ms, "loss": float(res["loss"]), "grad_norm": float(res["grad_norm"])})
    return out


def lm(args):
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import default_opt_cfg, lm_shape_config, make_lm_train_step
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamW

    arch = get_arch("minicpm-2b")
    shape = arch.shapes["train_4k"]
    opt_cfg = default_opt_cfg(arch)
    model = tfm.Transformer(arch.config, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(model.parameters(), opt_cfg)
    train = make_lm_train_step(arch, shape, opt_cfg)
    pipe = TokenPipeline(arch.config.vocab, args.batch, shape.seq_len, seed=0)
    batches = [pipe.batch_at(i) for i in range(args.steps)]
    step = lambda i: train(model, opt, {"tokens": batches[i]})
    torch.cuda.reset_peak_memory_stats()
    steps = _run(step, args.steps)
    cfg = lm_shape_config(arch, shape)
    emit("lm_steps", arch=arch.id, batch=args.batch, seq_len=shape.seq_len,
         attn_chunk=cfg.attn_chunk, attn_par=cfg.attn_par, loss_chunk=cfg.loss_chunk,
         steps=steps, peak_bytes=torch.cuda.max_memory_allocated(),
         state_bytes=_state_bytes(model, opt))
    if args.select:
        sliced = tfm.Transformer.layer_params
        plain = lambda self, i: {k: p[i] for k, p in self.layers.named_parameters()}
        runs = {}
        for name, fn in (("layer_slice", sliced), ("select_backward", plain),
                         ("layer_slice_again", sliced)):
            tfm.Transformer.layer_params = fn
            torch.cuda.reset_peak_memory_stats()
            runs[name] = {"step_ms": [s["ms"] for s in _run(step, 2)],
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        tfm.Transformer.layer_params = sliced
        emit("select", batch=args.batch, runs=runs)
    if args.profile:
        _profile("lm", step)


def recsys(args):
    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.data import RecsysPipeline
    from repro_torch.launch.steps import default_opt_cfg, make_recsys_step
    from repro_torch.models import bert4rec as b4r
    from repro_torch.optim import AdamW

    arch = get_arch("bert4rec")
    cfg = arch.config
    opt_cfg = default_opt_cfg(arch)
    shape = ShapeSpec("train_batch", "train", batch=args.recsys_batch)
    model = b4r.Bert4Rec(cfg, generator=torch.Generator("cuda").manual_seed(0))
    opt = AdamW(model.parameters(), opt_cfg)
    train = make_recsys_step(arch, shape, opt_cfg)
    pipe = RecsysPipeline(cfg.item_vocab, args.recsys_batch, cfg.seq_len, cfg.n_mask,
                          cfg.n_negatives, cfg.n_context, seed=0)
    batches = [pipe.batch_at(i) for i in range(args.steps)]
    step = lambda i: train(model, opt, batches[i])
    torch.cuda.reset_peak_memory_stats()
    steps = _run(step, args.steps)
    emit("recsys_steps", batch=args.recsys_batch, steps=steps,
         peak_bytes=torch.cuda.max_memory_allocated(), state_bytes=_state_bytes(model, opt))
    if args.gather:
        from repro_torch.models import embedding

        port = embedding.take_rows

        def indexed(table, ids):
            V = table.shape[0]
            idx = ids.long()
            idx = torch.where(idx < 0, idx + V, idx)
            outside = (idx < 0) | (idx >= V)
            return table[idx.clamp(0, V - 1)].masked_fill_(outside[..., None], float("nan"))

        runs = {}
        for name, fn in (("take_rows", port), ("indexing", indexed), ("take_rows_again", port)):
            embedding.take_rows = b4r.take_rows = fn
            runs[name] = [s["ms"] for s in _run(step, 2)]
        embedding.take_rows = b4r.take_rows = port
        emit("gather", batch=args.recsys_batch, step_ms=runs)
    if args.profile and not args.batch:
        _profile("recsys", step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=0, help="LM sequences a step (0: no LM run)")
    ap.add_argument("--recsys-batch", type=int, default=0, help="BERT4Rec users a step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--select", action="store_true")
    ap.add_argument("--gather", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_train_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__)
    if args.batch:
        lm(args)
    if args.recsys_batch:
        recsys(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
