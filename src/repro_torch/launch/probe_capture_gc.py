"""Whether a collection inside a CUDA-graph capture invalidates it, on CUDA.

    PYTHONPATH=src python -m repro_torch.launch.probe_capture_gc

A dead reference cycle holds an earlier captured graph (as a served
engine and its executor's closures do); then a second graph is captured
whose Python code allocates ``--lists`` small lists, enough for an
automatic collection.  Run twice: with the cyclic collector off for the
capture (as ``kernels.GraphLaunches.capture()`` runs every capture of
the port) and with it on.  With it on, the collection frees the old
graph inside the capture, its ``reset`` is refused there, and CUDA
invalidates the capture.  Prints one line per run.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc

import torch


class _Cycle:
    """An object that refers to itself: only the cyclic collector frees
    it."""


def attempt(device: torch.device, lists: int, collector_off: bool) -> str:
    """One capture after a dead cycle holding a graph; returns the
    outcome."""
    x = torch.zeros(4, device=device)
    gc.collect()
    old = _Cycle()
    old.self, old.graph = old, torch.cuda.CUDAGraph()
    with torch.cuda.graph(old.graph, capture_error_mode="thread_local"):
        old.out = x + 1
    del old
    graph = torch.cuda.CUDAGraph()
    if collector_off:
        gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            x * 2
            junk = [[i] for i in range(lists)]
        return f"captured ({len(junk)} lists)"
    except Exception as e:       # torch.AcceleratorError among them
        return f"failed: {type(e).__name__}: {str(e).splitlines()[0]}"
    finally:
        gc.enable()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--lists", type=int, default=50_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    # the collector off first: a failed capture is the run's last act
    for off in (True, False):
        print(f"collector {'off' if off else 'on'} during the capture: "
              f"{attempt(dev, args.lists, off)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
