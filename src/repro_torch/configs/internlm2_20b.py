"""internlm2-20b [arXiv:2403.17297; hf] — dense GQA transformer."""
import dataclasses

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="internlm2-20b",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=16384,
    vocab=92544,
    act="swiglu",
    rope_theta=1_000_000.0,
    expand_kv=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=512, attn_chunk=32, loss_chunk=32,
)

ARCH = register(
    ArchSpec(
        id="internlm2-20b",
        family="lm",
        config=CONFIG,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2403.17297; hf",
    )
)
