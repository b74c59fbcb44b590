"""How xlstm-1.3b behaves at full width with random weights, on CUDA.

    PYTHONPATH=src python -m repro_torch.launch.probe_xlstm [--seq 512]

Random weights from seed 0, f32, one prompt of ``--seq`` tokens:

- sensitivity: the last-token logits of the prompt prefilled whole,
  prefilled in two chunks (200 + the rest) and prefilled whole after the
  embedding table is scaled by 1 + 1e-7 (about one f32 ulp), for the
  full 48-block stack and for the canary stack (one mLSTM and one sLSTM
  block, twice): the largest logit difference each makes;
- growth: the residual stream's largest |x| after each of the six
  super-blocks (seven mLSTM blocks and one sLSTM block);
- gradients: one loss and backward (remat none, B 1) for the full stack
  and for its first super-block alone: the gradient leaves that are not
  finite.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import subprocess

import torch

from ..configs import get_config
from ..configs.base import LayerGroup
from ..data import SyntheticSource
from ..models import init_cache, init_params, loss_fn, prefill
from ..models import layers as L
from ..models import transformer as T

__all__ = ["main"]

#: one mLSTM and one sLSTM block, twice: the reference's canary stack
CANARY = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _first(tree):
    """The first layer of a tree stacked over layers, as new leaves."""
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[:1].clone()


def _last_logits(cfg, params, prompt, chunks, dev):
    caches = init_cache(cfg, 1, prompt.shape[1], dtype=torch.float32,
                        device=dev)
    for chunk in chunks:
        logits, caches = prefill(cfg, params, chunk, caches)
    return logits


def sensitivity(cfg, prompt, dev) -> str:
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    whole = _last_logits(cfg, params, prompt, [prompt], dev)
    split = _last_logits(cfg, params, prompt,
                         [prompt[:, :200], prompt[:, 200:]], dev)
    nudged = _last_logits(cfg, dict(params, embed=params["embed"]
                                    * (1 + 1e-7)), prompt, [prompt], dev)
    return (f"{cfg.n_layers} blocks: chunked against whole "
            f"{float((split - whole).abs().max())}, the nudged embedding "
            f"against whole {float((nudged - whole).abs().max())} (|logits| "
            f"up to {float(whole.abs().max())})")


def growth(cfg, params, tokens) -> list[float]:
    """The residual's largest |x| after each super-block (no grad)."""
    g = cfg.groups[0]
    out = []
    with torch.no_grad():
        x = params["embed"][tokens].float()
        for lp in T._unstack(params["groups"][0], g.count):
            for i, mixer in enumerate(g.pattern):
                sub = lp[f"sub{i}"]
                h = L.rms_norm(x, sub["norm1"], cfg.norm_eps)
                x = x + T._RECURRENT[mixer](cfg, sub["mixer"], h, None)[0]
            out.append(float(x.abs().max()))
    return out


def gradients(cfg, params, batch) -> list[str]:
    """The gradient leaves of one loss and backward that are not finite."""
    for _, t in _leaves(params):
        t.requires_grad_(True)
        t.grad = None
    loss, _ = loss_fn(cfg, params, batch, remat_policy="none")
    loss.backward()
    bad = [k for k, t in _leaves(params) if not torch.isfinite(t.grad).all()]
    for _, t in _leaves(params):
        t.requires_grad_(False)
        t.grad = None
    return [f"loss {float(loss.detach())}"] + bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seq", type=int, default=512)
    args = p.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    full = get_config("xlstm-1.3b")
    prompt = torch.randint(0, full.vocab_size, (1, args.seq),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    for cfg in (dataclasses.replace(full, groups=CANARY), full):
        print(f"sensitivity, {sensitivity(cfg, prompt, dev)}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    params = init_params(full, torch.Generator(device=dev).manual_seed(0), dev)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in SyntheticSource(
        full.vocab_size, seed=0).batch(0, 1, args.seq).items()}
    print(f"growth, max |x| after each super-block: "
          f"{growth(full, params, batch['tokens'])}", flush=True)
    print(f"gradients, 48 blocks: {gradients(full, params, batch)}",
          flush=True)
    one = dataclasses.replace(full, groups=(
        dataclasses.replace(full.groups[0], count=1),))
    first = dict(params, groups=[_first(params["groups"][0])])
    print(f"gradients, the first super-block (8 blocks): "
          f"{gradients(one, first, batch)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
