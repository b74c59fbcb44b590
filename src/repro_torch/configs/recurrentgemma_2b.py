"""recurrentgemma-2b [hybrid] — arXiv:2402.19427 (Griffin).

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000 — RG-LRU + local
attention at 1 attention : 2 recurrent.  26 = 8×(rec,rec,attn) + (rec,rec).
Runs long_500k: recurrent state is O(1), local-attn cache is O(window).
"""
from .base import LayerGroup, ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b",
    family="hybrid",
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    rope_theta=1e4,
    groups=(
        LayerGroup(pattern=("rglru", "rglru", "attn_local"), count=8,
                   ffn="dense"),
        LayerGroup(pattern=("rglru", "rglru"), count=1, ffn="dense"),
    ),
    rec=RecurrentConfig(conv_width=4, d_rnn=2560, local_window=2048),
    notes="sub-quadratic: runs long_500k (ring-buffer local-attn cache "
          "of 2048 + O(1) RG-LRU state).",
)
