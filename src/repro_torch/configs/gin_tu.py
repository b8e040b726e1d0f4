"""gin-tu [arXiv:1810.00826; paper] — GIN, 5L d=64, sum agg, learnable eps."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models.gin import GINConfig

CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, d_in=8, n_classes=4)

ARCH = register(
    ArchSpec(
        id="gin-tu",
        family="gnn",
        config=CONFIG,
        shapes=GNN_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:1810.00826; paper",
        gnn_model="gin",
    )
)
