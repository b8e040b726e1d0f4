"""gemma-7b [arXiv:2403.08295; hf] — GeGLU, head_dim=256, embed scaling."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv=16,
    d_head=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=128,
    vocab=512, attn_chunk=32, loss_chunk=32,
)

ARCH = register(
    ArchSpec(
        id="gemma-7b",
        family="lm",
        config=CONFIG,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2403.08295; hf",
    )
)
