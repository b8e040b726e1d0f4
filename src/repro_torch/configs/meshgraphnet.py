"""meshgraphnet [arXiv:2010.03409; unverified] — 15L d=128, sum agg, MLP x2."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models.meshgraphnet import MGNConfig

CONFIG = MGNConfig(name="meshgraphnet", n_layers=15, d_hidden=128)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, d_in=8)

ARCH = register(
    ArchSpec(
        id="meshgraphnet",
        family="gnn",
        config=CONFIG,
        shapes=GNN_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2010.03409; unverified",
        gnn_model="meshgraphnet",
    )
)
