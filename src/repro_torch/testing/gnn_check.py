"""Holding a GNN train step on the card to the same step on the CPU, for
the card-only tests.

:func:`cpu_loss_and_grads` runs the loss and its gradients on a CPU copy
of a model (the same weights) for a batch; after the card's step,
:func:`grad_errors` gives, per parameter, the largest absolute difference
of its gradient over the largest magnitude of the CPU's. Atomics reorder
the card's float32 segment sums, so the two agree to rounding, not bit for
bit.
"""
from __future__ import annotations

import copy

import torch


def _grads(model) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu()
            for n, p in model.named_parameters()}


def cpu_loss_and_grads(model, batch) -> tuple[float, dict]:
    """(loss, {name: gradient}) of ``model``'s weights on the CPU for ``batch``."""
    host = copy.deepcopy(model).to("cpu")
    host.zero_grad(set_to_none=True)
    loss = host.loss_fn(batch.to("cpu"))
    loss.backward()
    return float(loss.detach()), _grads(host)


def grad_errors(model, cpu_grads: dict, floor: float = 1e-3) -> dict:
    """{name: max |g - g_cpu| / max(max |g_cpu|, floor)} of ``model``'s
    gradients. The floor keeps a gradient that is zero in exact arithmetic
    (Equiformer-v2's attention biases: the per-head maximum subtracts any
    per-head constant) from dividing its rounding noise (~1e-9) by itself:
    at the default, such a gradient is held to 1e-3 * 1e-3 absolute."""
    out = {}
    for name, g in _grads(model).items():
        want = cpu_grads[name]
        if not want.numel():
            out[name] = 0.0
            continue
        scale = max(float(want.abs().max()), floor)
        out[name] = float((g - want).abs().max()) / scale
    return out
