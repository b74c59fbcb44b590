"""The flash backward kernels' share of their roofline over the train
steps traced: Σ bound over Σ measured time of the backward's kernels
(its row sums, dK/dV and dQ passes, and the GQA reduction where there
is one).  A step runs one backward call a layer over the job's B x S;
its bound is the larger of its FLOPs at the bf16 peak and its bytes at
the HBM bandwidth (the frozen cost formula)."""
import re

from perfbench import costs

KERNELS = re.compile(r"\b(delta_kernel|delta_tc_kernel|dkdv_tc_kernel|"
                     r"dq_tc_kernel|dkdv_f32_kernel|dq_f32_kernel)\b|"
                     r"anonymous namespace\)::reduce_kernel\b")


def read(run):
    t, c = run.trace, run.config
    if t is None:
        return None
    job, hd = run.traffic, c["head_dim"]
    per_step = c["n_layers"] * costs.bound_seconds(
        *costs.flash_attention_bwd_cost(job["batch"], job["seq"],
                                        c["n_heads"], c["n_kv_heads"], hd,
                                        hd))
    bound = measured = 0.0
    for s in t.span_kernels("train_step"):
        us = s.total_us(KERNELS.search)
        if us:
            bound += per_step
            measured += us / 1e6
    if not measured:
        return None
    return 100.0 * bound / measured
