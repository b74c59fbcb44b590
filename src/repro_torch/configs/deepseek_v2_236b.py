"""deepseek-v2-236b [moe] — arXiv:2405.04434.

60L d_model=5120 128H MLA (kv_lora=512) d_ff_expert=1536 vocab=102400,
MoE: 2 shared + 160 routed top-6; first layer dense (paper §2.1.2).
"""
from .base import LayerGroup, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,           # the single dense layer's FFN (paper: 12288)
    vocab_size=102400,
    head_dim=128,
    rope_theta=1e4,
    groups=(
        LayerGroup(pattern=("mla",), count=1, ffn="dense"),
        LayerGroup(pattern=("mla",), count=59, ffn="moe"),
    ),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                  capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    notes="MLA latent cache (512+64 per token vs 2*128*128 for GQA); "
          "EP: 160 experts / TP=16 = 10 per shard.",
)
