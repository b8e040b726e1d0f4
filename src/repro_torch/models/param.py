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

The same tree serves sharded execution: :func:`pspecs` gives each leaf's
mesh axes under a logical->mesh-axis rule map (the reference's
``PartitionSpec``, as :class:`PSpec`), :func:`shardings` their DTensor
placements on a ``DeviceMesh``, :func:`distribute_params` places a built
module's parameters by them, and :func:`abstract_params` gives shape and
dtype templates on the ``meta`` device (nothing is allocated).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional

import torch
from torch import nn
from torch.distributed.tensor import distribute_tensor

from repro_torch.distributed.sharding import MeshPlacement, placements, resolve


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
    seeded ``torch.Generator("cuda")`` to draw on the card instead. On the
    ``meta`` device (the dry-run's templates) nothing is drawn."""
    materialize(module, spec_tree, device)
    if torch.device(device).type == "meta":
        return module
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    return init_params(module, spec_tree, generator)


class PSpec(tuple):
    """Per tensor dimension, the mesh axis it is split over: a name, a tuple
    of names, or None (the reference's ``PartitionSpec``)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PSpec{tuple(self)!r}"


def _map_specs_with_paths(fn, spec_tree, prefix: str = ""):
    """The tree with each spec replaced by ``fn(dotted path, spec)``."""
    if isinstance(spec_tree, ArraySpec):
        return fn(prefix, spec_tree)
    join = lambda k: f"{prefix}.{k}" if prefix else str(k)
    if isinstance(spec_tree, dict):
        return {k: _map_specs_with_paths(fn, v, join(k)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs_with_paths(fn, v, join(i))
                               for i, v in enumerate(spec_tree))
    raise TypeError(f"not a spec tree: {type(spec_tree)}")


def _map_specs(fn, spec_tree):
    return _map_specs_with_paths(lambda _, s: fn(s), spec_tree)


def abstract_params(spec_tree):
    """The tree's shape-and-dtype templates: empty tensors on the ``meta``
    device (a checkpoint restore's template; nothing is allocated)."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), spec_tree)


def pspecs(spec_tree, rules: dict):
    """rules: logical axis name -> mesh axis (str | tuple | None). Per leaf,
    a :class:`PSpec`; a mesh axis appears at most once in a leaf's."""
    return _map_specs(lambda s: PSpec(*resolve(s.logical, rules)), spec_tree)


def shardings(spec_tree, rules: dict, mesh):
    """Per leaf, a :class:`MeshPlacement`: its DTensor placements on ``mesh``
    (one per mesh dimension; a dimension over a tuple of mesh axes is
    ``Shard`` on each of them)."""
    return _map_specs(
        lambda s: MeshPlacement(mesh, placements(mesh, resolve(s.logical, rules))), spec_tree)


def param_tree(module: nn.Module, spec_tree):
    """``module``'s parameters in the spec tree's structure (the reference's
    parameter pytree; DTensors stay DTensors), e.g. to checkpoint."""
    return _map_specs_with_paths(lambda path, s: module.get_parameter(path), spec_tree)


@torch.no_grad()
def distribute_params(module: nn.Module, spec_tree: dict, rules: dict, mesh) -> nn.Module:
    """Replace each of the tree's parameters on ``module`` by a DTensor
    parameter on ``mesh`` with its :func:`shardings` placements, from the
    values this rank holds (every rank built the same module: no data moves),
    one leaf at a time. Returns ``module``."""
    for path, spec in iter_specs(spec_tree):
        owner, _, name = path.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        full = getattr(sub, name)
        shard = distribute_tensor(full.detach(), mesh, placements(mesh, resolve(spec.logical, rules)),
                                  src_data_rank=None)
        delattr(sub, name)
        del full
        sub.register_parameter(name, nn.Parameter(shard))
    return module
