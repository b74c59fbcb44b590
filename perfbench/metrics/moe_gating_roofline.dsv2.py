"""The MoE gating kernel's share of its roofline over the decode and
prefill spans traced: Σ bound over Σ measured kernel time.  A decode
step routes one token in each MoE layer, a prefill the rows of its
passes (a padded bucket's pads too: the kernel routes them); a call's
bound is the larger of its FLOPs at the bf16 peak and its bytes at the
HBM bandwidth (``perfbench.gating_cost``, the frozen formula)."""
import re

from perfbench import costs, gating_cost

KERNEL = re.compile(r"\bgating_kernel\b")


def read(run):
    t, c = run.trace, run.config
    e = c.get("moe")
    if t is None or e is None:
        return None
    layers = sum(g["count"] for g in costs.layers(c) if g["ffn"] == "moe")

    def bound(T):
        return layers * costs.bound_seconds(*gating_cost.moe_gating_cost(
            T, e["n_experts"], e["top_k"], n_groups=e.get("n_groups", 1),
            topk_groups=e.get("topk_groups", 1),
            dropless=e.get("dropless", False)))

    total = measured = 0.0
    for name in ("decode", "prefill"):
        for s in t.span_kernels(name):
            us = s.total_us(KERNEL.search)
            if not us:
                continue
            total += bound(1 if name == "decode" else sum(s.meta["chunks"]))
            measured += us / 1e6
    if not measured:
        return None
    return 100.0 * total / measured
