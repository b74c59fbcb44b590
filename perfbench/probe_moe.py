"""One run of a serving cell that also reads the engine's MoE counters.

    python3 perfbench/probe_moe.py --workload deepseek-v2.serve.decode \\
        --seed 17 --seconds 40 --trace 0

Runs the cell as ``perfbench/run.py`` does (the same options and the
same result line), then prints on standard error and as the last line
of standard output the MoE counters the engine kept on the device over
the run (``ServingEngine.stats``, read once when the loop has ended; the
warm-up request included): layer calls and entries on the experts held
here by decode and prefill, the most rows one held expert took in a
prefill, the entries dropped, and from them the mean rows a held expert
takes in one layer call of each.

A measuring tool beside the benchmark: the benchmark's command never
runs it.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench import harness, serve  # noqa: E402
from perfbench import run as bench  # noqa: E402


def rows_per_held_expert(stats: dict, held: int) -> dict:
    """Mean entries a held expert takes in one layer call, by phase."""
    out = {}
    for phase in ("decode", "prefill"):
        calls = stats.get(f"moe_layer_calls_{phase}", 0)
        if calls:
            out[phase] = stats[f"moe_held_entries_{phase}"] / (calls * held)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    caught: dict = {}
    real = serve._loop

    def loop(ex, eng, clients, spans):
        real(ex, eng, clients, spans)
        caught["stats"] = {k: v for k, v in eng.stats().items()
                           if k.startswith("moe_")}
        caught["held"] = eng.cfg.moe.held

    serve._loop = loop
    rc = bench.main(argv)
    if rc == 0 and caught.get("stats"):
        out = dict(caught["stats"], rows_per_held_expert=rows_per_held_expert(
            caught["stats"], caught["held"]))
        harness.eprint("moe counters: " + json.dumps(out))
        print(json.dumps({"moe_counters": out}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
