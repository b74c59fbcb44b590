"""Model FLOPs of the train steps in the window's untraced part (6·N·T
plus the attention products, recomputation not counted) over that part's
seconds at the bf16 peak, in %.  The untraced part: the profiler's
per-kernel tracing of a graph launch slows the host while it runs."""
from perfbench import costs


def read(run):
    c, job = run.counters, run.traffic
    if not c.get("untraced_steps") or c.get("untraced_s", 0) <= 0:
        return None
    flops = c["untraced_steps"] * costs.train_step_flops(
        run.config, job["batch"], job["seq"])
    return 100.0 * flops / (c["untraced_s"] * costs.PEAK_BF16_FLOPS)
