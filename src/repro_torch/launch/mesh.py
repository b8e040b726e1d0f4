"""Meshes: the JAX package's ``repro.launch.mesh``.

:func:`make_host_mesh` builds a ``("data", "model")`` (or ``("pod", "data",
"model")``) :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the process group the caller initialised, through the one mesh
builder of the port (:func:`repro_torch.distributed.build_mesh`), for tests
and examples.

:func:`make_production_mesh` is the dry-run's: single pod ``(data=16,
model=16)``, 256 H100s; multi-pod ``(pod=2, data=16, model=16)``, 512, the
``pod`` axis the slow one, so only batch/DP traffic crosses it. It spans
the ranks of a fake world (:func:`fake_world`: one process plays every
rank, and collectives move nothing), typed ``cuda`` so that DTensor plans
the collectives NCCL would run. Functions, not module constants: importing
this module touches no process group.
"""
from __future__ import annotations

import contextlib

from repro_torch.distributed.elastic import RemeshPlan, build_mesh

#: (shape, axis names) of the production meshes, single- and multi-pod
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, device=None):
    """A small mesh over the first ``max(pod, 1) * data * model`` ranks;
    ``device=None`` means the CUDA card (``RuntimeError`` without one), pass
    ``"cpu"`` for a gloo group."""
    return build_mesh(RemeshPlan(data=data, model=model, pod=pod, dropped_devices=0),
                      device_type=device)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the ranks of the current process group (a
    :func:`fake_world` of 256, or 512 with ``multi_pod``)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = PRODUCTION_MESHES[multi_pod]
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cuda", torch.arange(n).reshape(shape), mesh_dim_names=axes)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` ranks played by this process alone
    (torch's ``fake`` backend: collectives return at once and move nothing),
    opened for the block and destroyed after it. For tracing on ``meta``
    tensors: no rank's data exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``, 1 where the mesh has no such axis."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1
