"""Model FLOPs of every token served in the window's untraced part (each
prompt once with its head, each decoded token at its position with its
head) over that part's seconds at the bf16 peak, in %.  The untraced
part: the profiler's per-kernel tracing of a graph launch slows the host
while it runs, so the traced part would read the tracer's cost."""
from perfbench import costs


def read(run):
    c = run.counters
    if not c.get("untraced_flops") or c.get("untraced_s", 0) <= 0:
        return None
    return 100.0 * c["untraced_flops"] / (c["untraced_s"]
                                          * costs.PEAK_BF16_FLOPS)
