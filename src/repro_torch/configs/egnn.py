"""egnn [arXiv:2102.09844; paper] — E(n)-equivariant GNN, 4L d=64."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, d_in=8)

ARCH = register(
    ArchSpec(
        id="egnn",
        family="gnn",
        config=CONFIG,
        shapes=GNN_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2102.09844; paper",
        gnn_model="egnn",
    )
)
