"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="mistral-large-123b",
    family="dense",
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1e6,
    groups=(LayerGroup(pattern=("attn",), count=88, ffn="dense"),),
    notes="GQA kv=8 < TP=16: KV heads replicated 2x across the model axis.",
)
