"""Host meshes: the JAX package's ``repro.launch.mesh`` for tests and examples.

:func:`make_host_mesh` builds a ``("data", "model")`` (or ``("pod", "data",
"model")``) :class:`~torch.distributed.device_mesh.DeviceMesh` over the
ranks of the process group the caller initialised, through the one mesh
builder of the port (:func:`repro_torch.distributed.build_mesh`). The
production meshes of the dry-run (``make_production_mesh``) are not ported
yet (ROADMAP.md §1 item 14).
"""
from __future__ import annotations

from repro_torch.distributed.elastic import RemeshPlan, build_mesh


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0, device=None):
    """A small mesh over the first ``max(pod, 1) * data * model`` ranks;
    ``device=None`` means the CUDA card (``RuntimeError`` without one), pass
    ``"cpu"`` for a gloo group."""
    return build_mesh(RemeshPlan(data=data, model=model, pod=pod, dropped_devices=0),
                      device_type=device)


def mesh_axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``, 1 where the mesh has no such axis."""
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1
