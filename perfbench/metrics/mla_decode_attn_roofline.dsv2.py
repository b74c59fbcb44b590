"""The decode-attention kernel's share of its roofline in MLA's decode
steps, over the decode replays traced: Σ bound over Σ measured kernel
time.  Each of the layers runs one call over the keys and values
up-projected from the latent cache, H = K heads of nope + rope (D) and
v (Dv) wide; a step at cache position p reads p + 1 rows; its bound is
the larger of its FLOPs at the bf16 peak and its bytes at the HBM
bandwidth (the frozen cost formula)."""
import re

from perfbench import costs

KERNEL = re.compile(r"\bdecode_kernel\b")


def read(run):
    t, c = run.trace, run.config
    m = c.get("mla")
    if t is None or m is None:
        return None
    D, Dv = m["qk_nope_dim"] + m["qk_rope_dim"], m["v_head_dim"]
    bound = measured = 0.0
    for s in t.span_kernels("decode"):
        us = s.total_us(KERNEL.search)
        if not us:
            continue
        bound += c["n_layers"] * costs.bound_seconds(
            *costs.decode_attention_cost(
                1, c["serve"]["max_seq"], c["n_heads"], c["n_heads"], D, Dv,
                rows=s.meta["pos"] + 1))
        measured += us / 1e6
    if not measured:
        return None
    return 100.0 * bound / measured
