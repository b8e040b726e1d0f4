"""Distribution support of the port: the straggler monitor, elastic
meshes (``plan_remesh``, ``build_mesh`` over ``torch.distributed``) and the
models' logical sharding constraints (``constrain``, a no-op without
installed rules; their DTensor placement is ROADMAP.md §1 item 14)."""
from repro_torch.distributed.elastic import RemeshPlan, build_mesh, plan_remesh
from repro_torch.distributed.sharding import constrain, current_rules, sharding_rules
from repro_torch.distributed.straggler import StragglerEvent, StragglerMonitor

__all__ = ["RemeshPlan", "build_mesh", "plan_remesh", "StragglerEvent", "StragglerMonitor",
           "constrain", "current_rules", "sharding_rules"]
