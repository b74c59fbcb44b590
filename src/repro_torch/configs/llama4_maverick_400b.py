"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE: 128 routed top-1 + 1 shared expert (early fusion = stub frontend).
"""
from .base import LayerGroup, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=5e5,
    groups=(LayerGroup(pattern=("attn",), count=48, ffn="moe"),),
    moe=MoEConfig(n_experts=128, top_k=1, n_shared=1, d_ff_expert=8192,
                  capacity_factor=1.25),
    notes="top-1 routing (Switch-style); 128 experts / TP=16 = 8 per shard; "
          "early-fusion multimodality = stub frontend (DESIGN.md §5).",
)
