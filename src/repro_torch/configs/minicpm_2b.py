"""minicpm-2b [arXiv:2404.06395; hf] — llama-like dense, WSD schedule.

The WSD (warmup-stable-decay) schedule is this arch's contribution; the
trainer wires repro_torch.optim.schedule.wsd_schedule as its default LR
law. 36 heads do not divide the 16-wide model axis of the reference's
mesh: there attention runs sequence-parallel (``attn_par``) while the MLP
uses tensor parallelism.
"""
import dataclasses

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="minicpm-2b",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv=36,
    d_head=64,
    d_ff=5760,
    vocab=122753,
    act="swiglu",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv=6, d_head=12, d_ff=144,
    vocab=512, attn_chunk=32, loss_chunk=32,
)

ARCH = register(
    ArchSpec(
        id="minicpm-2b",
        family="lm",
        config=CONFIG,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="arXiv:2404.06395; hf",
        notes="WSD schedule default; heads not divisible by model axis",
    )
)
