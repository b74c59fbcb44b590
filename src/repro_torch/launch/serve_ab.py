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
device code, the second is timed.  ``--long N`` adds a seventh prompt of
N tokens (``max_seq`` grows to fit it) and times three direct prefills
of it after serving (median, ended by a device synchronise): the compute
part of that request's time to first token.  Every run prints one JSON
line; the last line holds each side's medians.

    python -m repro_torch.launch.serve_ab --arch recurrentgemma-2b \\
        --a build/parent --b . --long 3000

``--train B,S,STEPS`` compares training instead: each run trains the
model at full width from seed 0 through ``launch.train.train`` for
STEPS steps of B × S tokens and reports the median step past the first.

    python -m repro_torch.launch.serve_ab --arch minicpm-2b \\
        --a build/parent --b . --train 4,1024,5
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
import json, statistics, sys, time
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import init_cache, init_params, prefill

dev = torch.device("cuda:0")
cfg = get_config(sys.argv[1])
long = int(sys.argv[2])
max_seq = 1024 if long == 0 else max(1024, 1 << (long + 16).bit_length())
params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
rng = np.random.default_rng(0)
prompts = [rng.integers(0, cfg.vocab_size, size=n)
           for n in (64, 512, 300, 137, 450, 64)]
prompts[5] = prompts[0]
if long:
    prompts.append(rng.integers(0, cfg.vocab_size, size=long))
# the first run builds the kernels and loads the device code each shape
# needs; only the second is timed
for _ in range(2):
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=max_seq, max_new=16)
stats = eng.stats()
tokens = sum(len(r.generated) for r in done)
res = {"tokens_s": tokens / seconds, "seconds": seconds,
       "ttft_p50_s": stats["ttft_p50_s"], "ttft_p99_s": stats["ttft_p99_s"],
       "itl_p50_s": stats["itl_p50_s"], "itl_p99_s": stats["itl_p99_s"]}
if long:
    p, times = eng.params, []
    tok = torch.as_tensor(prompts[-1][None], dtype=torch.long, device=dev)
    for _ in range(3):
        caches = init_cache(cfg, 1, max_seq, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        prefill(cfg, p, tok, caches)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    res["prefill_long_s"] = statistics.median(times)
print(json.dumps(res))
"""

_TRAIN_CHILD = r"""
import json, statistics, sys
import torch
from repro_torch.configs import get_config
from repro_torch.launch.train import train

B, S, steps = (int(n) for n in sys.argv[2].split(","))
out = train(get_config(sys.argv[1]), steps=steps, batch=B, seq=S,
            device=torch.device("cuda:0"))
print(json.dumps({"step_s": statistics.median(out["step_seconds"][1:])}))
"""

_KEYS = ("tokens_s", "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s")


def _run(root: str, arch: str, child: str, arg: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", child, arch, arg],
                         cwd=root, env=env, capture_output=True, text=True,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--a", required=True, help="root of checkout A")
    p.add_argument("--b", required=True, help="root of checkout B")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--long", type=int, default=0,
                   help="add a prompt of this many tokens and time its "
                        "prefill")
    p.add_argument("--train", default=None, metavar="B,S,STEPS",
                   help="compare train steps of B x S tokens instead")
    args = p.parse_args(argv)
    keys = _KEYS + (("prefill_long_s",) if args.long else ())
    child, arg = _CHILD, str(args.long)
    if args.train:
        keys, child, arg = ("step_s",), _TRAIN_CHILD, args.train

    runs = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            res = _run(os.path.abspath(getattr(args, side)), args.arch,
                       child, arg)
            runs[side].append(res)
            print(json.dumps({"side": side, **res}), flush=True)
    print(json.dumps({side: {k: statistics.median(r[k] for r in rs)
                             for k in keys}
                      for side, rs in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
