"""Workload configurations of the port. Importing this package registers
every architecture of the JAX package: the five LMs, the four GNNs and
BERT4Rec; ``paper_matching`` is the matcher's own workload."""
from repro_torch.configs import (  # noqa: F401
    bert4rec,
    egnn,
    equiformer_v2,
    gemma_7b,
    gin_tu,
    grok_1_314b,
    internlm2_20b,
    meshgraphnet,
    minicpm_2b,
    moonshot_v1_16b_a3b,
    paper_matching,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS,
    ArchSpec,
    ShapeSpec,
    all_arch_ids,
    get_arch,
)
