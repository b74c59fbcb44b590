"""Compare one model's serving speed in two checkouts of this repo on one
card, run in the order A B B A (``--rounds`` times) so that drift of the
host or the card falls on both sides alike.

    python -m repro_torch.launch.serve_ab --arch phi3-mini-3.8b \\
        --a build/parent --b .

Each run is a fresh process that imports ``repro_torch`` from its side's
``src/``, draws full-width weights from seed 0, and serves the same six
prompts (64-512 tokens, the sixth a repeat of the first, 16 new tokens
each, 4 slots, ``max_seq`` 1024) through ``serve()``, the entry point
both sides share, twice: the first pass builds the kernels and warms the
device code, the second is timed.  Every run prints one JSON line; the
last line holds each side's medians.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

__all__ = ["main"]

_CHILD = r"""
import json, sys
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import init_params

dev = torch.device("cuda:0")
cfg = get_config(sys.argv[1])
params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, size=n)
           for n in (64, 512, 300, 137, 450, 64)]
prompts[5] = prompts[0]
# the first run builds the kernels and loads the device code each shape
# needs; only the second is timed
for _ in range(2):
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=1024, max_new=16)
stats = eng.stats()
tokens = sum(len(r.generated) for r in done)
print(json.dumps({"tokens_s": tokens / seconds, "seconds": seconds,
                  "ttft_p50_s": stats["ttft_p50_s"],
                  "ttft_p99_s": stats["ttft_p99_s"],
                  "itl_p50_s": stats["itl_p50_s"],
                  "itl_p99_s": stats["itl_p99_s"]}))
"""

_KEYS = ("tokens_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s")


def _run(root: str, arch: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD, arch], cwd=root,
                         env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--a", required=True, help="root of checkout A")
    p.add_argument("--b", required=True, help="root of checkout B")
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)

    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            res = _run(os.path.abspath(getattr(args, side)), args.arch)
            runs[side].append(res)
            print(json.dumps({"side": side, **res}), flush=True)
    print(json.dumps({side: {k: statistics.median(r[k] for r in rs)
                             for k in _KEYS}
                      for side, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
