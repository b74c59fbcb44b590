"""Model FLOPs of the prompts prefilled in the traced window over the
device time of their prefills (the union of the kernels each launched),
at the bf16 peak, in %."""
from perfbench import costs


def read(run):
    t, c = run.trace, run.config
    if t is None:
        return None
    spans = [s for s in t.span_kernels("prefill") if s.names]
    busy = sum(s.busy_us() for s in spans) / 1e6
    if not busy:
        return None
    flops = sum(costs.prompt_flops(c, s.meta["length"]) for s in spans)
    return 100.0 * flops / (busy * costs.PEAK_BF16_FLOPS)
