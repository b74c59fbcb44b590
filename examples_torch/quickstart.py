"""Quickstart — the paper's saxpy example (Listing 1 / Fig. 1) on the
PyTorch port, on a CUDA card by default.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import Executor, Heteroflow  # noqa: E402

N = 65536


def saxpy(a, xs, ys):
    """The kernel: ``a * x + y`` on the device tensors of the two pulls."""
    return a * xs + ys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="the executor's one device bin (cuda or cpu)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    x = np.zeros(N, np.float32)
    y = np.zeros(N, np.float32)

    G = Heteroflow("saxpy")
    # two host tasks create the data vectors
    host_x = G.host(lambda: x.__setitem__(slice(None), 1.0), name="host_x")
    host_y = G.host(lambda: y.__setitem__(slice(None), 2.0), name="host_y")
    # two pull tasks send them to the device
    pull_x = G.pull(x, name="pull_x")
    pull_y = G.pull(y, name="pull_y")
    # the kernel task offloads saxpy (a torch function in place of CUDA)
    kernel = G.kernel(saxpy, 2.0, pull_x, pull_y, writes=(pull_y,),
                      name="saxpy")
    # a push task brings the result back
    push_y = G.push(pull_y, y, name="push_y")

    host_x.precede(pull_x)
    host_y.precede(pull_y)
    kernel.succeed(pull_x, pull_y).precede(push_y)

    print(G.dump())                      # DOT visualization (paper §III-A.6)

    with Executor(num_workers=4, devices=[device]) as executor:
        future = executor.run(G)         # non-blocking (paper §III-B)
        future.result()
        executor.wait_for_all()

    assert np.allclose(y, 4.0)
    print(f"saxpy ok: y[:4]={y[:4]}  (2*1+2 = 4)")
    return G, y


if __name__ == "__main__":
    main()
