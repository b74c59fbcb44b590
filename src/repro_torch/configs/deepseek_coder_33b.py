"""deepseek-coder-33b [dense] — arXiv:2401.14196 (llama-arch).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-coder-33b",
    family="dense",
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    rope_theta=1e5,
    groups=(LayerGroup(pattern=("attn",), count=62, ffn="dense"),),
    notes="llama-arch; GQA kv=8 replicated 2x under TP=16.",
)
