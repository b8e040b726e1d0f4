"""Logical-axis sharding constraints for model internals, as DTensor placement.

Models call ``constrain(x, "dp", "model_seq", None)`` with *logical* axis
names, as the JAX package's models do. Rules installed by the caller
(``with sharding_rules(rules): ...``) map each name to a mesh axis, a tuple
of mesh axes, or None; the mesh comes from ``with use_mesh(mesh): ...``, the
counterpart of the reference's ``with mesh:``. Under both, ``constrain``
redistributes ``x`` to the placements the names resolve to on that
:class:`~torch.distributed.device_mesh.DeviceMesh` (a plain tensor is first
taken as replicated on the mesh): a layout, as ``with_sharding_constraint``
is; the values never change.

``constrain`` returns ``x`` itself in exactly two cases: no rules are
installed (one card, the smoke tests), or rules are installed but no mesh
is current (what the reference's ``except Exception: return x`` amounts to
outside ``with mesh:``). Anything else that goes wrong raises: the port
has no catch-all (ROADMAP.md §3).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(rules: dict):
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` current for :func:`constrain` (the reference's ``with mesh:``)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def resolve(logical, rules: dict) -> tuple:
    """Per dimension, the mesh axis (a name, a tuple of names, or None) that
    the logical ``names`` map to under ``rules``; a mesh axis is used at most
    once per tensor (a later dimension that would reuse one stays whole), and
    a one-name tuple is that name, as jax's ``PartitionSpec`` keeps it."""
    axes, used = [], set()
    for name in logical:
        ax = rules.get(name) if name is not None else None
        key = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        if ax is not None and any(k in used for k in key):
            ax = None
        if ax is not None:
            used.update(key)
            ax = key[0] if len(key) == 1 else key
        axes.append(ax)
    return tuple(axes)


def placements(mesh, axes) -> tuple[Placement, ...]:
    """DTensor placements on ``mesh`` (one per mesh dimension) of a tensor
    whose dimension d is split over ``axes[d]``. A dimension over a tuple of
    mesh axes is ``Shard(d)`` on each of them; the tuple must follow the
    mesh's order, which splits the rows as jax's ``NamedSharding`` does (the
    first axis major). Raises ``ValueError`` for an axis the mesh lacks, a
    tuple out of the mesh's order, or a mesh axis named twice."""
    names = tuple(mesh.mesh_dim_names or ())
    out: list[Placement] = [Replicate()] * mesh.ndim
    for d, ax in enumerate(axes):
        if ax is None:
            continue
        group = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        missing = [a for a in group if a not in names]
        if missing:
            raise ValueError(f"mesh axes {missing} are not in the mesh's {names}")
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"axes {group} of dimension {d} are not in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} splits two dimensions of {axes}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshPlacement:
    """A tensor's layout: DTensor placements, one per dimension of ``mesh``
    (the reference's ``NamedSharding``)."""
    mesh: Any
    placements: tuple


def on_mesh(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) is taken as replicated; a DTensor must already be on ``mesh``."""
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            raise ValueError(f"a DTensor on {x.device_mesh} met the current mesh {mesh}")
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor: a mask, positions, a buffer) as a replicated
    DTensor on ``like``'s mesh when ``like`` is a DTensor, else ``t``: the
    one place where the models' plain operands join DTensor activations."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        return on_mesh(t, like.device_mesh)
    return t


def constrain(x, *logical):
    """``x`` laid out as the logical names resolve under the installed rules
    on the current mesh; ``x`` itself when no rules are installed, or no mesh
    is current. Raises ``ValueError`` when the names do not match ``x``'s
    rank or an axis is not on the mesh."""
    rules = current_rules()
    mesh = current_mesh()
    if rules is None or mesh is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"constrain{logical}: {len(logical)} names for a {x.dim()}-d tensor")
    want = placements(mesh, resolve(logical, rules))
    x = on_mesh(x, mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)
