"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B] — MoE 64e top-6.

Expert parallelism: 64 experts shard 4-per-device over the 16-wide model
axis (expert_sharding="ep").
"""
import dataclasses

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=1408,
    vocab=163840,
    act="swiglu",
    n_experts=64,
    top_k=6,
    expert_sharding="ep",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_head=16, d_ff=96,
    vocab=512, n_experts=8, top_k=2, attn_chunk=32, loss_chunk=32,
)

ARCH = register(
    ArchSpec(
        id="moonshot-v1-16b-a3b",
        family="lm",
        config=CONFIG,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
