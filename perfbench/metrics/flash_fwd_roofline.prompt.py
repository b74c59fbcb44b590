"""The flash forward kernel's share of its roofline over the prefills
traced: Σ bound over Σ measured kernel time.  A chunk of r >= 2 rows at
cache position s runs one call a layer with q offset s over the s + r
key rows it needs; its bound is the larger of its FLOPs at the bf16 peak
and its bytes at the HBM bandwidth (the frozen cost formula)."""
import re

from perfbench import costs

KERNEL = re.compile(r"\bflash_(tc|f32)_kernel\b")


def read(run):
    t, c = run.trace, run.config
    if t is None:
        return None
    bound = measured = 0.0
    hd = c["head_dim"]
    for s in t.span_kernels("prefill"):
        us = s.total_us(KERNEL.search)
        if not us:
            continue
        start = 0
        for r in s.meta["chunks"]:
            if r >= 2:
                bound += c["n_layers"] * costs.bound_seconds(
                    *costs.flash_attention_cost(
                        1, r, start + r, c["n_heads"], c["n_kv_heads"], hd,
                        hd, q_offset=start))
            start += r
        measured += us / 1e6
    if not measured:
        return None
    return 100.0 * bound / measured
