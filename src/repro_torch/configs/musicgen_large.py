"""musicgen-large [audio] — arXiv:2306.05284.

48L d_model=2048 32H (MHA) d_ff=8192 vocab=2048 — decoder-only over
EnCodec tokens.  EnCodec frontend is a STUB: inputs are the quantized
codebook ids themselves (models/frontends.py).
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    rope_theta=1e4,
    frontend="audio_stub",
    groups=(LayerGroup(pattern=("attn",), count=48, ffn="dense"),),
    notes="backbone only; 4-codebook delay interleaving not modeled "
          "(frontend concern, DESIGN.md §8).",
)
