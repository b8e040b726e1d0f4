"""Distribution support of the port: the straggler monitor and elastic
meshes (``plan_remesh``, ``build_mesh`` over ``torch.distributed``). The
JAX package's logical sharding rules (``repro.distributed.sharding``) serve
its models and are not ported (ROADMAP.md §1 item 14)."""
from repro_torch.distributed.elastic import RemeshPlan, build_mesh, plan_remesh
from repro_torch.distributed.straggler import StragglerEvent, StragglerMonitor

__all__ = ["RemeshPlan", "build_mesh", "plan_remesh", "StragglerEvent", "StragglerMonitor"]
