"""AdamW with float32 moments, the JAX package's arithmetic exactly.

``repro.optim.adamw_update`` in the same order of operations:

* clip by the global float32 norm, scale ``min(1, max_norm / max(norm,
  1e-9))`` (``grad_clip=0`` skips it and reports a norm of 0);
* an int32 ``count``; bias corrections ``1 - b ** count`` in float32;
* ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, the decay applied
  to every parameter;
* ``step`` returns the norm before clipping.

``step`` walks each parameter in slices of its leading axis of at most
``SLICE_ELEMS`` elements, clipping and updating one slice at a time: the
update is elementwise, so the result is bit-equal to one pass over the
whole leaf, and its float32 temporaries stay a few slices in size (a
stacked [40, 2304, 11520] leaf is 4.25 GB a float32 copy). The gradients
in ``.grad`` are left as they are.

On DTensor parameters (placed on a ``DeviceMesh`` by
``repro_torch.models.param.distribute_params``) the moments are DTensors
with the parameter's placements; each gradient is first laid out as its
parameter (a partial sum is reduced: the data-parallel all-reduce), and the
slices walk the local shards of the parameter, its gradient and its
moments (``to_local()``), which the updates write in place. Indexing a
DTensor would not do: a slice of a sharded DTensor is a new, gathered
tensor, so the parameter would be left unchanged. The clip's norm is the
norm of the whole gradient, each element counted once however it is
placed.

``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: their epsilon
placement and order of operations differ. The state per parameter is
``{"m", "v"}`` plus one ``count`` (``AdamW.count``);
``repro_torch.convert.opt_state_from_reference`` / ``opt_state_to_reference``
carry it to and from the reference's ``{m, v, count}`` dict.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.param import ArraySpec

#: the most elements of a leaf that ``AdamW.step`` updates at once
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32


def adamw_init_specs(param_spec_tree, cfg: AdamWConfig):
    """The state's spec tree: moments with their parameters' shapes and
    logical axes, and a scalar int32 count."""
    def mom(tree):
        if isinstance(tree, ArraySpec):
            return ArraySpec(tree.shape, tree.logical, cfg.moment_dtype, "zeros")
        if isinstance(tree, dict):
            return {k: mom(v) for k, v in tree.items()}
        return [mom(v) for v in tree]

    return {"m": mom(param_spec_tree), "v": mom(param_spec_tree),
            "count": ArraySpec((), (), torch.int32, "zeros")}


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """``{m, v, count}`` for a dict of named parameters: zero moments of
    ``cfg.moment_dtype`` and a zero int32 count."""
    zeros = {k: _zeros_like(p, cfg.moment_dtype) for k, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _zeros_like(p: torch.Tensor, dtype) -> torch.Tensor:
    """Zeros of ``p``'s shape in ``dtype`` on its device (a DTensor: with its
    placements on its mesh)."""
    if isinstance(p, DTensor):
        return torch.zeros_like(p, dtype=dtype)
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def _sum_of_squares(g: torch.Tensor) -> torch.Tensor:
    """float32 sum of ``g``'s squares, with one float32 copy of ``g`` at most
    (a DTensor: the sum over the whole tensor, as a plain tensor)."""
    if g.dtype == torch.float32:
        sq = torch.sum(torch.square(g))
    else:
        sq = torch.sum(g.float().square_())
    return sq.full_tensor() if isinstance(sq, DTensor) else sq


def _global_norm(grads: list) -> torch.Tensor:
    """The sqrt of the sum, over the gradients in order, of each one's
    float32 sum of squares."""
    sq = sum(_sum_of_squares(g) for g in grads)
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: list, max_norm: float):
    """(clipped gradients, norm before clipping), the norm as
    :func:`_global_norm`."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return [(g * scale).to(g.dtype) for g in grads], norm


def _row_slices(p: torch.Tensor):
    """Index expressions that walk ``p`` in slices of its leading axis of at
    most ``SLICE_ELEMS`` elements (one row at least; a 0-d ``p`` whole)."""
    if p.dim() == 0:
        yield ...
        return
    rows = max(1, SLICE_ELEMS // max(1, p[0].numel()))
    for i in range(0, p.shape[0], rows):
        yield slice(i, i + rows)


def _laid_out_as(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s placements when ``p`` is a DTensor (a partial sum
    reduced, a replicated gradient sliced), else ``g``."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _local(t: torch.Tensor) -> torch.Tensor:
    """The shard of ``t`` this rank holds (its storage: writes land in ``t``),
    or ``t`` itself when it is not a DTensor."""
    return t.to_local() if isinstance(t, DTensor) else t


class AdamW(torch.optim.Optimizer):
    """The reference's AdamW over ``params`` (one group). ``step()`` takes
    the gradients in ``p.grad`` and returns the global norm before
    clipping, a float32 tensor on the parameters' device."""

    def __init__(self, params, cfg: AdamWConfig = AdamWConfig()):
        super().__init__(params, {"lr": cfg.lr})
        self.cfg = cfg
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int32, device=first.device)

    @torch.no_grad()
    def step(self, closure=None, lr: float | None = None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        cfg = self.cfg
        params = [p for g in self.param_groups for p in g["params"]]
        lr = self.param_groups[0]["lr"] if lr is None else lr
        grads = [_laid_out_as(p, p.grad) if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if cfg.grad_clip:
            gnorm = _global_norm(grads)
            scale = _clip_scale(gnorm, cfg.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=self.count.device)
            scale = None
        self.count += 1
        count = self.count.float()
        b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=count.device), count)
        b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=count.device), count)
        for p, g in zip(params, grads):
            st = self.state[p]
            if "m" not in st:
                st["m"] = _zeros_like(p, cfg.moment_dtype)
                st["v"] = _zeros_like(p, cfg.moment_dtype)
            p_, g_, m_, v_ = (_local(t) for t in (p, g, st["m"], st["v"]))
            for sl in _row_slices(p_):
                self._update(p_[sl], g_[sl], m_[sl], v_[sl], scale, lr, b1c, b2c)
        return gnorm

    def _update(self, p, g, m, v, scale, lr, b1c, b2c):
        """One slice: the clipped gradient, the moments and the parameter, in place."""
        cfg = self.cfg
        if scale is not None:
            g = (g * scale).to(g.dtype)
        g32, m32, v32, p32 = g.float(), m.float(), v.float(), p.float()
        m_new = cfg.b1 * m32 + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v32 + (1 - cfg.b2) * g32 * g32
        upd = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        p.copy_((p32 - lr * (upd + cfg.weight_decay * p32)).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
