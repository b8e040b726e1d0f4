"""Workload configurations of the port. Importing this package registers
every ported architecture (the four GNNs); ``paper_matching`` is the
matcher's own workload."""
from repro_torch.configs import (  # noqa: F401
    egnn,
    equiformer_v2,
    gin_tu,
    meshgraphnet,
    paper_matching,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    ArchSpec,
    ShapeSpec,
    all_arch_ids,
    get_arch,
)
