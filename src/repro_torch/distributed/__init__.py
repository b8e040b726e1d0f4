"""Distribution support of the port: the straggler monitor, elastic
meshes (``plan_remesh``, ``build_mesh`` over ``torch.distributed``) and the
models' logical sharding constraints (``constrain``: DTensor placement
under installed rules on the mesh of ``use_mesh``, a no-op otherwise)."""
from repro_torch.distributed.elastic import RemeshPlan, build_mesh, plan_remesh
from repro_torch.distributed.sharding import (
    MeshPlacement,
    constrain,
    current_mesh,
    current_rules,
    sharding_rules,
    use_mesh,
)
from repro_torch.distributed.straggler import StragglerEvent, StragglerMonitor

__all__ = ["RemeshPlan", "build_mesh", "plan_remesh", "StragglerEvent", "StragglerMonitor",
           "MeshPlacement", "constrain", "current_mesh", "current_rules", "sharding_rules",
           "use_mesh"]
