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


def _strides(shape) -> tuple:
    """A contiguous tensor's strides (computed, not allocated: under a
    tracing mode even a ``meta`` tensor counts as an allocation)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def zeros(shape, dtype, device, *logical):
    """Zeros of ``shape``: a plain tensor where :func:`constrain` would
    return its input, else a DTensor laid out as the logical names resolve,
    each rank allocating only its own shard."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    if len(logical) != len(shape):
        raise ValueError(f"zeros{logical}: {len(logical)} names for a {len(shape)}-d tensor")
    want = placements(mesh, resolve(logical, rules))
    local_shape, _ = compute_local_shape_and_global_offset(shape, mesh, want)
    local = torch.zeros(local_shape, dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, want, run_check=False, shape=torch.Size(shape),
                              stride=_strides(shape))


class _PinGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.place = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.place:
            g = g.redistribute(ctx.mesh, ctx.place)
        return g


def pin_grad(x):
    """``x``, whose gradient is laid out as ``x`` is (a DTensor's; anything
    else is returned as it is). Put after a reshape that merges a dimension:
    the gradient then reaches the reshape's backward, which splits that
    dimension again, in a layout it can split (DTensor refuses to split a
    dimension sharded into uneven pieces)."""
    return _PinGrad.apply(x) if isinstance(x, DTensor) else x


def row_layout(t: DTensor) -> list:
    """A DTensor's placements, which must split only its first axis (rows:
    edges, users), or nothing."""
    place = list(t.placements)
    if not all(p.is_replicate() or p.is_shard(0) for p in place):
        raise ValueError(f"rows placed {place}; want Shard(0) or Replicate")
    return place


def row_chunks(t: torch.Tensor, n: int) -> list:
    """``t`` [R, ...] in ``n`` chunks of rows along its first axis. A DTensor
    split over its rows is chunked within each rank's block (chunk i holds
    the i-th part of every rank's rows), so no row moves; :func:`cat_rows`
    puts such chunks back in order."""
    if not isinstance(t, DTensor):
        return list(t.reshape(n, t.shape[0] // n, *t.shape[1:]))
    mesh, place = t.device_mesh, row_layout(t)
    local = t.to_local()
    if local.shape[0] % n:
        raise ValueError(f"row_chunks: {local.shape[0]} rows a rank in {n} chunks")
    shape = (t.shape[0] // n, *t.shape[1:])
    stride = _strides(shape)
    return [DTensor.from_local(c, mesh, place, run_check=False, shape=torch.Size(shape),
                               stride=stride)
            for c in local.reshape(n, local.shape[0] // n, *local.shape[1:])]


def cat_rows(parts: list, like: torch.Tensor) -> torch.Tensor:
    """The chunks of :func:`row_chunks` of ``like`` (or results row for row)
    joined in ``like``'s row order: ``torch.cat``, or for a DTensor ``like``
    each part laid out as ``like``'s rows are (a part that came back whole
    keeps this rank's rows of it) and each rank's pieces joined in order."""
    if not isinstance(like, DTensor):
        return torch.cat(parts)
    mesh, place = like.device_mesh, row_layout(like)
    local = torch.cat([on_mesh(p, mesh).redistribute(mesh, place).to_local() for p in parts])
    shape = (sum(p.shape[0] for p in parts), *parts[0].shape[1:])
    return DTensor.from_local(local, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=_strides(shape))
