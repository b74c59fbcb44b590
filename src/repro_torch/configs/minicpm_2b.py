"""minicpm-2b [dense] — arXiv:2404.06395.

40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760 vocab=122753.
WSD (warmup-stable-decay) schedule lives in training/optimizer.py.
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="minicpm-2b",
    family="dense",
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
    groups=(LayerGroup(pattern=("attn",), count=40, ffn="dense"),),
    notes="WSD schedule (training/optimizer.py); tied embeddings; "
          "vocab 122753 not divisible by TP=16 — XLA pads the shard.",
)
