"""phi3-mini-3.8b [dense] — arXiv:2404.14219.

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064.
RoPE + SwiGLU + GQA.
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-mini-3.8b",
    family="dense",
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    rope_theta=1e4,
    groups=(LayerGroup(pattern=("attn",), count=32, ffn="dense"),),
)
