"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — M-RoPE,
dynamic resolution.  Vision tower is a STUB: patch embeddings arrive
precomputed (models/frontends.py); M-RoPE sections (16, 24, 24).
"""
from .base import LayerGroup, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1e6,
    m_rope_sections=(16, 24, 24),
    frontend="vision_stub",
    n_visual_tokens=256,
    groups=(LayerGroup(pattern=("attn",), count=28, ffn="dense"),),
    notes="M-RoPE over (t,h,w); text-only positions degenerate to 1-D. "
          "Dynamic resolution is a frontend concern (stub provides a "
          "fixed 256-patch grid).",
)
