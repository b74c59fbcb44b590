"""The decode-attention kernel's share of its roofline over the decode
replays traced: Σ bound over Σ measured kernel time.  A step at cache
position p reads p + 1 rows of each layer's cache; its bound is the
larger of its FLOPs at the bf16 peak and its bytes at the HBM bandwidth
(the frozen cost formula)."""
import re

from perfbench import costs

KERNEL = re.compile(r"\bdecode_kernel\b")


def read(run):
    t, c = run.trace, run.config
    if t is None:
        return None
    bound = measured = 0.0
    hd = c["head_dim"]
    for s in t.span_kernels("decode"):
        us = s.total_us(KERNEL.search)
        if not us:
            continue
        bound += c["n_layers"] * costs.bound_seconds(
            *costs.decode_attention_cost(
                1, c["serve"]["max_seq"], c["n_heads"], c["n_kv_heads"], hd,
                hd, rows=s.meta["pos"] + 1))
        measured += us / 1e6
    if not measured:
        return None
    return 100.0 * bound / measured
