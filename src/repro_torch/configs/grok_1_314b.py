"""grok-1-314b [hf:xai-org/grok-1; unverified] — MoE 8e top-2.

8 experts < 16-wide model axis: EPxTP folding (expert_fold=2) stores each
expert as two half-FFN "folded experts" so the folded expert dim (16)
shards the whole model axis — expert traffic moves activations
(all-to-all), never weights. Params are additionally FSDP-sharded
("embed" -> data): 314B bf16 cannot fit a 16-way shard alone.
"""
import dataclasses

from repro_torch.configs.registry import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    act="geglu",  # 3-matrix FFN matches the 314B total
    n_experts=8,
    top_k=2,
    expert_sharding="ep",
    expert_fold=2,  # 8 experts x 2 folds shard the 16-wide model axis
    logit_softcap=30.0,
    expand_kv=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=128,
    vocab=512, n_experts=4, top_k=2, attn_chunk=32, loss_chunk=32,
)

ARCH = register(
    ArchSpec(
        id="grok-1-314b",
        family="lm",
        config=CONFIG,
        shapes=LM_SHAPES,
        smoke_config=SMOKE,
        source="hf:xai-org/grok-1; unverified",
    )
)
