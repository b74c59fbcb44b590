"""The benchmark's command: one run of one cell on the card.

    python3 perfbench/run.py --workload phi3.serve.decode --seed 17 \\
        --seconds 30 --trace 0

Run from the root of a checkout.  ``--trace 1`` runs the same cell with
the profiler on over the first part of the window and prints the cell's
per-layer metrics instead of its end-to-end ones.  ``--control 1``
(calibration only) puts the fp8 control in the program's place in the
comparison, so that ``correct`` is the control's;
``--fault half_batch`` (calibration only) plants a training fault the
comparison must catch;
``--rate`` sets an open loop's rate (the knee sweep).  Builds and
caches stay in the checkout (``build/``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (from
    ``/proc/self/stat``; now where that cannot be read)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(uptime - started, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_PROC = _process_start()
ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=("half_batch",), default=None)
    p.add_argument("--rate", type=float, default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for path in (ROOT / "src", ROOT):
        sys.path.insert(0, str(path))
    from perfbench import harness
    return harness.main(args, T_PROC)


if __name__ == "__main__":
    sys.exit(main())
