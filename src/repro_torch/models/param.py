"""Parameter declaration: trees of :class:`ArraySpec` made real on a module.

Models declare parameters as nested dicts and lists of :class:`ArraySpec`
(shape + logical axis names + init), as the JAX package's models do.
:func:`materialize` registers one ``nn.Parameter`` per spec on a module,
under the reference's tree path (``layers.0.w1``), so a module's
``state_dict`` keys are the reference's leaves. :func:`init_params` fills
them with the reference's distributions from an explicit
``torch.Generator``, drawing on the generator's device leaf by leaf (the
values differ from ``jax.random``'s draws; parity tests carry the JAX
values across with ``repro_torch.convert.params_from_reference``). A CPU
generator gives the same values on every device; a CUDA generator draws
on the card, which a model of billions of parameters needs (its float32
draws would not fit the host's memory one leaf at a time).

The sharding and dry-run halves of the reference module (``abstract_params``,
``pspecs``, ``shardings``) are not ported yet (ROADMAP.md §1 item 14).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    shape: tuple
    logical: tuple  # one name (or None) per dim
    dtype: Any = torch.float32
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _fan_in(shape) -> float:
    return float(shape[-2]) if len(shape) >= 2 else float(shape[-1])


def iter_specs(spec_tree, prefix: str = "") -> Iterator[tuple[str, ArraySpec]]:
    """(dotted path, spec) of every leaf, in the reference's flatten order."""
    if isinstance(spec_tree, ArraySpec):
        yield prefix, spec_tree
    elif isinstance(spec_tree, dict):
        for k in sorted(spec_tree):
            yield from iter_specs(spec_tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(spec_tree, (list, tuple)):
        for i, v in enumerate(spec_tree):
            yield from iter_specs(v, f"{prefix}.{i}" if prefix else str(i))
    else:
        raise TypeError(f"not a spec tree: {type(spec_tree)}")


def materialize(module: nn.Module, spec_tree: dict, device) -> nn.Module:
    """Register the tree's parameters on ``module`` (uninitialized, on
    ``device``): a dict becomes a submodule, a list an ``nn.ModuleList``."""
    for k in sorted(spec_tree):
        v = spec_tree[k]
        if isinstance(v, ArraySpec):
            module.register_parameter(
                k, nn.Parameter(torch.empty(v.shape, dtype=v.dtype, device=device)))
        elif isinstance(v, dict):
            module.add_module(k, materialize(nn.Module(), v, device))
        elif isinstance(v, (list, tuple)):
            module.add_module(k, nn.ModuleList(
                [materialize(nn.Module(), x, device) for x in v]))
        else:
            raise TypeError(f"{k}: not a spec tree: {type(v)}")
    return module


@torch.no_grad()
def init_params(module: nn.Module, spec_tree: dict, generator: torch.Generator) -> nn.Module:
    """Fill the tree's parameters: ``normal`` N(0, 1) / sqrt(fan_in) (fan_in
    ``shape[-2]``, or ``shape[-1]`` for a vector), ``embed`` N(0, 1),
    ``zeros``, ``ones``; an explicit ``scale`` replaces the factor. Draws
    come from ``generator`` on its own device, one float32 leaf at a time,
    in the reference's leaf order (a CPU generator: the same values on
    every device; a CUDA generator: draws on the card)."""
    for path, spec in iter_specs(spec_tree):
        p = module.get_parameter(path)
        if spec.init == "zeros":
            p.zero_()
        elif spec.init == "ones":
            p.fill_(1.0)
        else:
            scale = spec.scale
            if scale is None:
                scale = 1.0 if spec.init == "embed" else 1.0 / math.sqrt(_fan_in(spec.shape))
            draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                               device=generator.device)
            p.copy_(draw.mul_(scale).to(spec.dtype))
            del draw
    return module


def count_params(spec_tree) -> int:
    return int(sum(math.prod(s.shape) for _, s in iter_specs(spec_tree)))


def build_params(module: nn.Module, spec_tree: dict, device, seed: int = 0,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """:func:`materialize` then :func:`init_params` from ``generator``, by
    default a CPU generator seeded with ``seed``: a module built on the card
    and one built on the CPU from one seed hold the same values. Pass a
    seeded ``torch.Generator("cuda")`` to draw on the card instead."""
    materialize(module, spec_tree, device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return init_params(module, spec_tree, generator)
