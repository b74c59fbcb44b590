"""Device milliseconds per decoded token: the union of the kernels each
decode-graph replay launched, over the replays traced whole."""


def read(run):
    if run.trace is None:
        return None
    spans = [s for s in run.trace.span_kernels("decode") if s.names]
    if not spans:
        return None
    return sum(s.busy_us() for s in spans) / len(spans) / 1e3
