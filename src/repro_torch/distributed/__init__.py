"""Distribution support of the port: the straggler monitor (the rest of the
JAX package's ``repro.distributed`` is not ported yet, ROADMAP.md §1 item 13)."""
from repro_torch.distributed.straggler import StragglerEvent, StragglerMonitor

__all__ = ["StragglerEvent", "StragglerMonitor"]
