"""Paper §IV-B analog on the PyTorch port: matching-based detailed
placement.

A flattened iterative graph (MIS kernel → sequential partition host task
→ matching kernel per iteration, chained across iterations) — the
irregular, dependent workload where the paper observes saturation — run
by the port's executor, on a CUDA card by default.

    PYTHONPATH=src python examples_torch/detailed_placement.py --iters 8 \
        --policy round_robin
    # record a calibration trace / fit the simulator from a prior one
    PYTHONPATH=src python examples_torch/detailed_placement.py --profile dp.json
    PYTHONPATH=src python examples_torch/detailed_placement.py --calibrate dp.json
    # on the CPU
    PYTHONPATH=src python examples_torch/detailed_placement.py --device cpu

:func:`main` returns the graph, the objective trace, the simulation and
the run's seconds.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from examples_torch.workloads import build_detailed_placement  # noqa: E402
from repro_torch.configs import DEFAULT_SCHED  # noqa: E402
from repro_torch.core import Executor  # noqa: E402
from repro_torch.sched import (  # noqa: E402
    CostModel,
    TaskProfiler,
    available_policies,
    load_trace,
    simulate,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--cells", type=int, default=256)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--policy", default=DEFAULT_SCHED.policy,
                   choices=available_policies(),
                   help="placement policy (repro_torch.sched registry)")
    p.add_argument("--profile", metavar="PATH",
                   default=DEFAULT_SCHED.trace_path or None,
                   help="record a TaskProfiler JSON trace of the run "
                        "(default: SchedConfig.trace_path)")
    p.add_argument("--calibrate", metavar="TRACE",
                   help="fit the simulator's CostModel from a recorded "
                        "trace, so 'simulated' predicts wall-clock")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the graph N times (stateful, run_n); "
                        "dynamic re-placement only fires between repeats")
    p.add_argument("--replace-every", type=int,
                   default=DEFAULT_SCHED.replace_every,
                   help="re-invoke the scheduler every N repeats with "
                        "measured per-bin load (0 = off; needs --repeat>1)")
    p.add_argument("--no-steal-locality", dest="steal_locality",
                   action="store_false",
                   default=DEFAULT_SCHED.steal_locality,
                   help="random-victim stealing instead of locality-aware")
    p.add_argument("--device", default="cuda",
                   help="the executor's one device bin (cuda or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    model = (CostModel.fit(load_trace(args.calibrate)) if args.calibrate
             else CostModel(device_speed=DEFAULT_SCHED.device_speed))
    G, objective = build_detailed_placement(args.iters, args.cells)
    print(f"graph: {len(G)} tasks for {args.iters} iterations")
    profiler = TaskProfiler() if args.profile else None
    t0 = time.perf_counter()
    with Executor(num_workers=args.workers, devices=[device],
                  scheduler=args.policy, profiler=profiler,
                  steal_locality=args.steal_locality,
                  replace_every=args.replace_every) as ex:
        # score the executor's own scheduler instance: the placement
        # simulated is the one ex.run() recomputes identically below
        sim = simulate(G, ex.scheduler.schedule(G, ex.devices),
                       ex.devices, cost_model=model,
                       host_workers=args.workers)
        ex.run_n(G, args.repeat).result(timeout=600)
        st = ex.stats()
    dt = time.perf_counter() - t0
    extra = " [calibrated]" if args.calibrate else ""
    if args.replace_every:
        extra += f" replacements={st['replacements']}"
    print(f"{args.iters} iterations x {args.repeat} policy={args.policy} "
          f"in {dt:.2f}s; simulated {sim.summary()}{extra}; "
          f"objective trace: {[round(o, 1) for o in objective[:8]]}")
    if profiler is not None:
        profiler.save(args.profile)
        print(f"trace: {len(profiler.records)} records -> {args.profile} "
              f"(measured makespan {profiler.makespan() * 1e3:.1f}ms)")
    return {"graph": G, "objective": objective, "sim": sim, "seconds": dt}


if __name__ == "__main__":
    main()
