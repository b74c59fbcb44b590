"""Paper §IV-A analog on the PyTorch port: multi-view VLSI timing
correlation.

N independent view pipelines (host feature extraction → pull → device
logistic-regression kernel → push), scheduled by the port's
work-stealing executor with Algorithm-1 placement — the scaling
*structure* of paper Fig. 6, on a CUDA card by default.

    PYTHONPATH=src python examples_torch/timing_analysis.py --views 32 \
        --workers 4 --policy heft
    # profile-guided loop: record a trace, then predict from it
    PYTHONPATH=src python examples_torch/timing_analysis.py --profile t.json
    PYTHONPATH=src python examples_torch/timing_analysis.py --calibrate t.json
    # on the CPU
    PYTHONPATH=src python examples_torch/timing_analysis.py --device cpu

``--cells-per-view N`` switches from the per-view pipelines to the
paper's propagation DAG proper: ``views * N`` arrival-time cells with
bounded fan-in from nearby upstream cells (netlist locality), a graph
that scales to 10^5+ cells.  Scaling ``--views`` then grows one
connected graph instead of adding disjoint pipelines, so the reported
rate is cells/s:

    PYTHONPATH=src python examples_torch/timing_analysis.py --views 16 \
        --cells-per-view 100 --workers 4

The arrivals are read off the kernel tasks once the run has finished:
stacked into one tensor on the device and copied to the host at once.
:func:`main` returns one record per worker count (the graph, its
results, the simulation and the seconds each part took).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from examples_torch.workloads import build_timing_analysis, build_timing_graph  # noqa: E402
from repro_torch.configs import DEFAULT_SCHED  # noqa: E402
from repro_torch.core import Executor, KernelTask, TaskType  # noqa: E402
from repro_torch.sched import (  # noqa: E402
    CostModel,
    TaskProfiler,
    available_policies,
    load_trace,
    simulate,
)


def arrivals_of(G):
    """The arrival of every cell of a propagation DAG that has run, in
    cell order, as one host f64 array (one device-to-host copy)."""
    ks = [KernelTask(n) for n in G.nodes if n.type is TaskType.KERNEL]
    return torch.stack([k.result() for k in ks]).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--policy", default=DEFAULT_SCHED.policy,
                   choices=available_policies(),
                   help="placement policy (repro_torch.sched registry)")
    p.add_argument("--sweep", action="store_true",
                   help="sweep worker counts like paper Fig. 6")
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
    p.add_argument("--cells-per-view", type=int, default=0,
                   help="propagation-DAG mode: one connected "
                        "views*N-cell arrival-time graph instead of N "
                        "disjoint view pipelines (0 = legacy mode)")
    p.add_argument("--fanout", type=int, default=4,
                   help="max fan-in per cell in propagation-DAG mode")
    p.add_argument("--device", default="cuda",
                   help="the executor's one device bin (cuda or cpu)")
    args = p.parse_args(argv)
    if args.cells_per_view < 0:
        p.error("--cells-per-view must be >= 0")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    model = (CostModel.fit(load_trace(args.calibrate)) if args.calibrate
             else CostModel(device_speed=DEFAULT_SCHED.device_speed))
    workers = (1, 2, 4) if args.sweep else (args.workers,)
    n_cells = args.views * args.cells_per_view
    runs = []
    for w in workers:
        t_build = time.perf_counter()
        if n_cells:
            G, outs = build_timing_graph(n_cells, fanout=args.fanout), None
        else:
            G, outs = build_timing_analysis(args.views)
        build_s = time.perf_counter() - t_build
        profiler = TaskProfiler() if args.profile else None
        t0 = time.perf_counter()
        with Executor(num_workers=w, devices=[device], scheduler=args.policy,
                      profiler=profiler,
                      steal_locality=args.steal_locality,
                      replace_every=args.replace_every) as ex:
            # score the executor's own scheduler instance: the placement
            # simulated is the one ex.run() recomputes identically below
            sim = simulate(G, ex.scheduler.schedule(G, ex.devices),
                           ex.devices, cost_model=model, host_workers=w)
            t_run = time.perf_counter()
            ex.run_n(G, args.repeat).result(timeout=600)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            run_s = time.perf_counter() - t_run
            st = ex.stats()
        dt = time.perf_counter() - t0
        extra = " [calibrated]" if args.calibrate else ""
        if args.replace_every:
            extra += f" replacements={st['replacements']}"
        arrivals = None
        if outs is None:
            arrivals = arrivals_of(G)
            print(f"workers={w} policy={args.policy}: {n_cells} cells "
                  f"({args.views} views x {args.cells_per_view}) x "
                  f"{args.repeat} in {dt:.2f}s "
                  f"({n_cells * args.repeat / dt:.0f} cells/s), "
                  f"{len(arrivals)} arrivals, worst "
                  f"{arrivals.max():.3f}; simulated {sim.summary()}{extra}")
        else:
            done = sum(1 for o in outs if (o != 0).any())
            print(f"workers={w} policy={args.policy}: {args.views} views x "
                  f"{args.repeat} in {dt:.2f}s "
                  f"({args.views * args.repeat / dt:.1f} views/s), "
                  f"{done} models fitted; simulated {sim.summary()}{extra}")
        if profiler is not None:
            # one trace per sweep point — don't clobber earlier runs
            path = (args.profile if len(workers) == 1
                    else f"{args.profile}.w{w}")
            profiler.save(path)
            print(f"trace: {len(profiler.records)} records -> {path} "
                  f"(measured makespan {profiler.makespan() * 1e3:.1f}ms)")
        runs.append({"workers": w, "graph": G, "models": outs,
                     "arrivals": arrivals, "sim": sim, "profiler": profiler,
                     "seconds": dt, "build_seconds": build_s,
                     "run_seconds": run_s})
    return runs


if __name__ == "__main__":
    main()
