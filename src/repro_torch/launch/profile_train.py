"""Where one train step's device time goes, on CUDA.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch minicpm-2b --batch 4 --seq 1024

Builds the full-width config with random weights (seed 0), runs
``--warmup`` steps of ``make_train_step`` (remat ``full`` by default),
then one step under ``torch.profiler`` (CPU and CUDA activities).
Prints the step's wall time, the device's kernel time and busy share
(kernel time over wall time), the kernel time by group — matrix
products, the port's own kernels, everything else (elementwise work,
reductions, copies) — and the kernels that take the most time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, list_archs
from ..data import SyntheticSource
from ..models.transformer import REMAT_POLICIES
from ..training import (AdamWConfig, cosine_schedule, init_train_state,
                        make_train_step)

__all__ = ["main", "group_of"]

#: the port's kernels (``kernels/csrc/*.cu``), all in anonymous
#: namespaces (PyTorch's own have an ``at::`` in their names)
PORT_KERNELS = ("flash_tc_kernel", "flash_fwd_kernel", "dkdv_kernel",
                "dq_kernel", "dkdv_tc_kernel", "dq_tc_kernel", "delta_kernel",
                "delta_tc_kernel", "reduce_kernel", "scan_kernel",
                "rglru_kernel", "bwd_kernel", "gating_kernel", "decode_kernel")
#: substrings of cuBLAS/CUTLASS matrix-product kernel names
MATMUL_KERNELS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def group_of(name: str) -> str:
    """The group a kernel's name falls in: "port", "matmul" or "other"."""
    low = name.lower()
    if "(anonymous namespace)::" in name and "at::" not in name \
            and any(k in name for k in PORT_KERNELS):
        return "port"
    if any(k in low for k in MATMUL_KERNELS):
        return "matmul"
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=list_archs(), required=True)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--remat", choices=REMAT_POLICIES, default="full")
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    dev = torch.device("cuda", 0)

    cfg = get_config(args.arch)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    step = make_train_step(cfg, AdamWConfig(
        schedule=cosine_schedule(3e-4, 100, 1000)), remat_policy=args.remat)
    b = SyntheticSource(cfg.vocab_size).batch(0, args.batch, args.seq)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    for _ in range(args.warmup):
        step(state, batch)
    torch.cuda.synchronize(dev)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    groups: dict[str, float] = {}
    for e in kernels:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e6
    print(f"{cfg.arch_id} B {args.batch} x S {args.seq}, remat "
          f"{args.remat}: step wall {wall} s; kernel time {busy} s; busy "
          f"share {busy / wall}; idle share {1 - busy / wall}")
    for g, s in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {s} s ({s / wall} of the step)")
    print(f"top {args.top} kernels (device s, calls, name):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :args.top]:
        print(f"  {e.self_device_time_total / 1e6} {e.count} "
              f"[{group_of(e.key)}] {e.key[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
