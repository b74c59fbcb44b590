"""Prefill chunks of two tokens or more per prompt in the window: the
engine's own counters (``PrefillGraphs.replays`` / ``.prefills``)."""


def read(run):
    c = run.counters
    if not c.get("prefills"):
        return None
    return c["replays"] / c["prefills"]
