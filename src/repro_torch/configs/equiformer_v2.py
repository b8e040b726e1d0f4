"""equiformer-v2 [arXiv:2306.12059; unverified] — 12L d=128 l_max=6 m_max=2
8 heads, SO(2)-eSCN convolutions. See models/equiformer_v2.py for the
fidelity notes (exact azimuthal rotation, learned polar modulation)."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, register
from repro_torch.models.equiformer_v2 import EqV2Config

CONFIG = EqV2Config(
    name="equiformer-v2", n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8
)
SMOKE = dataclasses.replace(CONFIG, n_layers=2, d_hidden=16, l_max=2, d_in=8)

ARCH = register(
    ArchSpec(
        id="equiformer-v2",
        family="gnn",
        config=CONFIG,
        shapes=GNN_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2306.12059; unverified",
        gnn_model="equiformer_v2",
    )
)
