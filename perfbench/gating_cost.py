"""The yardstick's copy of the MoE gating kernel's cost formula.

A frozen copy of ``moe_gating_cost`` of
``repro_torch/kernels/moe_gating/ops.py``, taking shapes instead of
tensors, so that a change to the program cannot move its own yardstick;
a test holds it equal to the program's formula on sample shapes.
"""
from __future__ import annotations


def moe_gating_cost(T: int, E: int, top_k: int, *, n_groups: int = 1,
                    topk_groups: int = 1, dropless: bool = False,
                    elem: int = 4) -> tuple[int, int]:
    """(FLOPs, bytes) of a gating call over ``T`` tokens and ``E``
    experts: per token and expert the softmax's 4 operations and one
    comparison per top-k pick, with groups one more per expert and one
    per group and kept group; the f32 logits read once, the four (T, k)
    outputs (13 bytes an entry) written once, and in the dropless mode
    the (E,) int32 ends."""
    flops = T * E * (4 + top_k)
    if n_groups > 1:
        flops += T * (E + n_groups * topk_groups)
    nbytes = elem * T * E + T * top_k * 13
    return flops, nbytes + (4 * E if dropless else 0)
