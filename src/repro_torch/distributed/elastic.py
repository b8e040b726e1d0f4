"""Elastic scaling: pick the mesh after membership changes and rebuild it.

Flow on a real cluster: a node dies -> the job restarts on the survivors
(or an enlarged pool) -> ``plan_remesh`` picks the largest valid mesh ->
the checkpoint (which stores unsharded logical arrays, see
:mod:`repro_torch.checkpoint`) is restored on the new mesh. Nothing in the
checkpoint format depends on the old topology. ``plan_remesh`` is the JAX
package's, code for code; ``build_mesh`` builds a
:class:`torch.distributed.device_mesh.DeviceMesh` over the process group
the caller initialised (``torch.distributed.init_process_group``, NCCL on
the card, gloo on the CPU).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    pod: int  # 0 -> no pod axis
    dropped_devices: int

    @property
    def n_devices(self) -> int:
        return max(self.pod, 1) * self.data * self.model


def plan_remesh(n_available: int, *, prefer_model: int = 16,
                min_model: int = 1) -> RemeshPlan:
    """Largest (data, model) mesh fitting n_available devices.

    Keeps the model axis as close to `prefer_model` as the pool allows
    (TP degree changes force weight resharding but stay legal for any
    divisor of the original), then maximizes data. Excess devices idle.
    """
    model = min(prefer_model, n_available)
    while model > min_model and n_available // model < 1:
        model //= 2
    # model axis must divide cleanly into the pool to keep SPMD rectangular
    while model > min_model and (n_available // model) * model < n_available * 0.5:
        model //= 2
    data = max(1, n_available // model)
    used = data * model
    return RemeshPlan(data=data, model=model, pod=0,
                      dropped_devices=n_available - used)


def build_mesh(plan: RemeshPlan, device_type=None):
    """The plan's mesh, dimensions named ``("data", "model")`` (or
    ``("pod", "data", "model")``), over the first ``plan.n_devices`` ranks
    of the initialised process group, in order. ``device_type=None`` means the CUDA card (``RuntimeError`` without
    one); pass ``"cpu"`` for a gloo group."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device_type)
    shape = (plan.pod, plan.data, plan.model) if plan.pod else (plan.data, plan.model)
    names = ("pod", "data", "model") if plan.pod else ("data", "model")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)
