"""Serving example on the PyTorch port: continuous batching with paged
KV (buddy arena), on a CUDA card by default.

Drives the public engine surface — ``submit()`` / ``step()`` /
``poll()`` — so requests are admitted while earlier ones are mid-decode
(continuous batching), the event-driven scheduler places each request's
prefill/decode groups onto the KV bins, and the run ends with the
engine's TTFT / inter-token latency percentiles.  The model is the
reduced config of ``--arch`` with random weights drawn from a seeded
``torch.Generator``; on the card each slot's decode step is replayed
from the CUDA graph the engine captured when it was built.

    PYTHONPATH=src python examples_torch/serve_lm.py --requests 12
    PYTHONPATH=src python examples_torch/serve_lm.py --bins 2 \
        --scheduler balanced
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu

:func:`main` returns the engine, its finished requests and the seconds
the run took.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="phi3-mini-3.8b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--bins", type=int, default=1,
                   help="KV replica bins the scheduler places requests on")
    p.add_argument("--scheduler", default="heft",
                   help="placement policy for admission (heft keeps "
                        "decode co-located with its KV; balanced may "
                        "migrate pages, charged as kv_moves)")
    p.add_argument("--device", default="cuda",
                   help="the device the model runs on (cuda or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    cfg = reduced(get_config(args.arch))
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    eng = ServingEngine(cfg, params, max_slots=args.slots, max_seq=128,
                        bins=args.bins, scheduler=args.scheduler,
                        device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    # trickle submissions between ticks: the engine admits new requests
    # while earlier ones are still decoding (continuous batching)
    ids = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=4 + i % 7)
        ids.append(eng.submit(prompt.astype(np.int32),
                              max_new_tokens=args.max_new))
        eng.step()
    while eng.step():
        pass
    dt = time.time() - t0

    done = [eng.poll(i) for i in ids]
    assert all(r is not None and r.done for r in done)
    total_tokens = sum(len(r.generated) for r in done)
    s = eng.stats()
    print(f"{len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s) over {eng.ticks} engine ticks")
    print(f"latency: ttft p50={s['ttft_p50_s'] * 1e3:.1f}ms "
          f"p99={s['ttft_p99_s'] * 1e3:.1f}ms | "
          f"inter-token p50={s['itl_p50_s'] * 1e3:.1f}ms "
          f"p99={s['itl_p99_s'] * 1e3:.1f}ms")
    print(f"kv: bins={s['bins']} utilization={s['kv_utilization']:.2f} "
          f"fragmentation={s['kv_fragmentation']:.2f} "
          f"grows={s['page_grows']} moves={s['kv_moves']} "
          f"preemptions={s['preemptions']}")
    for r in done[:3]:
        print(f"  req {r.id}: prompt[{len(r.prompt)}] -> {r.generated} "
              f"({r.state})")
    return eng, done, dt


if __name__ == "__main__":
    main()
