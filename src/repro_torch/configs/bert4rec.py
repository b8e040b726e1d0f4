"""bert4rec [arXiv:1904.06690; paper] — bidirectional sequence recommender."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, RECSYS_SHAPES, register
from repro_torch.models.bert4rec import Bert4RecConfig

CONFIG = Bert4RecConfig(
    name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2, seq_len=200,
    item_vocab=1_048_576,
)
SMOKE = dataclasses.replace(
    CONFIG, item_vocab=1024, seq_len=16, n_mask=4, n_negatives=64, n_context=4
)

ARCH = register(
    ArchSpec(
        id="bert4rec",
        family="recsys",
        config=CONFIG,
        shapes=RECSYS_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:1904.06690; paper",
    )
)
