"""Train a transformer LM end to end with the production loop: AdamW with
the WSD schedule, gradient clipping, checkpoint and restart, straggler
monitoring. The counterpart of the JAX package's ``examples/train_lm.py``,
with its presets (tiny: CPU-friendly; 100m) and defaults:

    PYTHONPATH=src python -m repro_torch.launch.train_lm --steps 60
    PYTHONPATH=src python -m repro_torch.launch.train_lm --preset 100m --steps 200

Each step takes the ``TokenPipeline`` batch of its index and one
``make_lm_train_step`` step at the schedule's learning rate. Every
``--ckpt-every`` steps the parameters and the AdamW state are saved in the
JAX package's layout (``{"params": tree, "opt": {m, v, count}}``); a run
restarts from the newest checkpoint in ``--ckpt-dir``. ``--device cpu``
runs on the CPU; by default the trainer runs on the CUDA card and raises
without one.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ArchSpec, ShapeSpec
from repro_torch.core.types import resolve_device
from repro_torch.data import TokenPipeline
from repro_torch.distributed import StragglerMonitor
from repro_torch.launch.steps import make_lm_train_step
from repro_torch.models import transformer as tfm
from repro_torch.models.param import count_params
from repro_torch.optim import AdamW, AdamWConfig, wsd_schedule

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv=2, d_head=32,
                 d_ff=256, vocab=2048, seq=128, batch=8),
    "100m": dict(n_layers=8, d_model=768, n_heads=12, n_kv=4, d_head=64,
                 d_ff=2048, vocab=32768, seq=512, batch=8),
}


def preset_config(name: str) -> tuple[tfm.TransformerConfig, dict]:
    """(float32 config, preset) of a preset, as the reference example builds it."""
    p = PRESETS[name]
    cfg = tfm.TransformerConfig(
        name=f"lm-{name}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv=p["n_kv"], d_head=p["d_head"], d_ff=p["d_ff"],
        vocab=p["vocab"], param_dtype=torch.float32, attn_chunk=64, loss_chunk=64,
    )
    return cfg, p


def _restore(mgr: CheckpointManager, model: tfm.Transformer, opt: AdamW):
    """Load the newest checkpoint into ``model`` and ``opt``; its step or None."""
    tree = convert.params_to_reference(model)
    tmpl = {"params": tree, "opt": {"m": tree, "v": tree, "count": np.zeros((), np.int32)}}
    step, restored = mgr.restore(tmpl)
    if restored is None:
        return None
    convert.params_from_reference(model, restored["params"])
    convert.opt_state_from_reference(opt, model, restored["opt"])
    return step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg, p = preset_config(args.preset)
    print(f"model: {count_params(tfm.param_specs(cfg)) / 1e6:.1f}M params on {dev}")
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.01)
    arch = ArchSpec(id=cfg.name, family="lm", config=cfg, shapes={}, smoke_config=cfg,
                    source="examples/train_lm.py presets")
    shape = ShapeSpec("train", "train", seq_len=p["seq"], global_batch=p["batch"])
    step_fn = make_lm_train_step(arch, shape, opt_cfg, device=dev)
    pipe = TokenPipeline(cfg.vocab, p["batch"], p["seq"], seed=0, device=dev)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    mon = StragglerMonitor()
    model = tfm.Transformer(cfg, device=dev, seed=0)
    opt = AdamW(model.parameters(), opt_cfg)
    start = _restore(mgr, model, opt) or 0
    if start:
        print(f"restored checkpoint at step {start} (restart-from-failure path)")
    for step in range(start, args.steps):
        tokens = pipe.batch_at(step)
        lr = float(wsd_schedule(step, opt_cfg.lr, warmup=10, stable=args.steps // 2,
                                decay=args.steps // 2))
        mon.start()
        out = step_fn(model, opt, {"tokens": tokens}, lr=lr)
        loss = float(out["loss"])
        ev = mon.stop()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} gnorm {float(out['grad_norm']):.3f} "
                  f"lr {lr:.2e}" + (f" [straggler x{ev.ratio:.1f}]" if ev else ""))
        if step and step % args.ckpt_every == 0:
            mgr.save(step, {"params": convert.params_to_reference(model),
                            "opt": convert.opt_state_to_reference(opt, model)})
    mgr.wait()
    print("done; final checkpoint steps:", mgr.all_steps())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
