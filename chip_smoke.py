#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes — every element within the tolerance of the plain
   version's f32 result (one bf16 rounding for a bf16 output), median
   time (CUDA events, L2 flushed before each launch), the plain version's
   time, ``torch.nn.functional.scaled_dot_product_attention``'s time on
   the same inputs (a yardstick only: the port never calls it) and the
   bound;
4. small-input reference: reduced phi3-mini served on the card and on the
   CPU (plain kernels) gives the same greedy tokens;
5. serve: ``repro_torch.launch.serve.serve`` at the full width of
   phi3-mini-3.8b (random weights from a seed) through the Executor over
   ``cuda:0``: 6 requests of 64-512 prompt tokens, 16 new tokens each, 4
   slots, max_seq 1024.  Every request completes with 16 tokens, a
   repeated prompt gets the same tokens, the launch counts equal 32 ×
   prefills (flash) and 32 × decode steps (decode), and a prefill and a
   decode step give finite logits of the vocabulary's width.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or without the repository's ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: each kernel is held against its plain version on f32 copies of the same
#: inputs, element by element: |out - ref| <= 2e-5 + rtol·|ref|.  2e-5 is
#: the f32 sums taken in another order (as the JAX package's kernel
#: sweeps); a bf16 output adds one rounding to nearest, at most 2^-8 of
#: the value, so rtol is 2e-5 for an f32 output and 2^-8 for a bf16 one
ATOL = 2e-5
RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}
PHI3 = "phi3-mini-3.8b"


def _median_ms(torch, fn, flush, reps: int = 15) -> float:
    """Median of ``reps`` launches timed with CUDA events, each after a
    write of a buffer larger than L2 (the serving path finds its inputs
    cold) and a device-side sleep long enough for the host to enqueue
    ``fn`` whole before the start event fires: the time is the device's,
    not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)          # ~1 ms of device cycles
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _check(torch, name, out, ref32, dtype_name) -> float:
    """``out`` (the kernel's) against ``ref32`` (the plain version's, on f32
    copies of the same inputs); returns the max abs error."""
    err = (out.float() - ref32).abs()
    rtol = RTOL[dtype_name]
    bad = err > ATOL + rtol * ref32.abs()
    max_err = float(err.max())
    if bool(bad.any()) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max abs err {max_err} (tol {ATOL} + "
                             f"{rtol}·|ref|)")
    return max_err


def kernel_phase(torch, dev) -> dict:
    """Every kernel case of phase 3; returns the case chosen for each
    kernel's entry of the ``{"kernels": ...}`` line."""
    import torch.nn.functional as F

    from repro_torch.kernels import (decode_attention, decode_attention_plain,
                                     flash_attention, flash_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    chosen = {}
    print("kernel cases (name, shape, dtype, max_abs_err, atol, rtol, ms, "
          "plain_ms, library_ms, bound_ms, bound_by):")
    for B, H, K, S, D, dt in [(1, 32, 32, 128, 96, "bfloat16"),
                              (1, 32, 32, 512, 96, "bfloat16"),
                              (1, 32, 32, 1000, 96, "bfloat16"),
                              (1, 32, 8, 1000, 128, "bfloat16"),
                              (1, 32, 32, 512, 96, "float32")]:
        dtype = getattr(torch, dt)
        q, k, v = (randn((B, S, n, D), dtype) for n in (H, K, K))
        out = flash_attention(q, k, v)
        ref = flash_attention_plain(q.float(), k.float(), v.float())
        err = _check(torch, "flash_attention", out, ref, dt)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = _median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != K), flush)
        flops = 2 * B * H * S * S * D          # causal: QK^T and PV, halved
        nbytes = 2 * (B * S * H * D + B * S * K * D) * dtype.itemsize
        bounds = {"operations": flops / PEAK_FLOPS[dt] * 1e3,
                  "bytes": nbytes / HBM_BYTES_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:106",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: flash_attention(q, k, v), flush),
               "plain_ms": _median_ms(
                   torch, lambda: flash_attention_plain(q, k, v), flush),
               "bound_ms": bounds[bound_by], "bound_by": bound_by,
               "library_ms": lib}
        print(f"  flash_attention B={B} H={H} K={K} S={S} D={D} {dt}: "
              f"{err} {ATOL} {RTOL[dt]} {row['ms']} {row['plain_ms']} {lib} "
              f"{row['bound_ms']} {bound_by}")
        if (S, K, dt) == (512, 32, "bfloat16"):
            chosen["flash_attention"] = row

    for B, S, lens, dt in [(1, 1024, [1], "bfloat16"),
                           (1, 1024, [517], "bfloat16"),
                           (1, 1024, [1024], "bfloat16"),
                           (4, 1024, [1024, 517, 64, 1], "bfloat16"),
                           (1, 1024, [517], "float32")]:
        H = K = 32
        D = 96
        dtype = getattr(torch, dt)
        q = randn((B, H, D), dtype)
        k, v = (randn((B, S, K, D), dtype) for _ in range(2))
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        out = decode_attention(q, k, v, vl)
        ref = decode_attention_plain(q.float(), k.float(), v.float(), vl)
        err = _check(torch, "decode_attention", out, ref, dt)
        qt = q[:, :, None]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = (torch.arange(S, device=dev)[None, :] < vl[:, None])
        mask = mask[:, None, None, :]
        lib = _median_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush)
        rows = sum(min(n, S) for n in lens)
        nbytes = dtype.itemsize * (2 * rows * K * D + 2 * B * H * D) + 4 * B
        flops = 4 * rows * H * D
        bounds = {"operations": flops / PEAK_FLOPS[dt] * 1e3,
                  "bytes": nbytes / HBM_BYTES_S * 1e3}
        bound_by = max(bounds, key=bounds.get)
        row = {"name": "decode_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention/kernel.py:90",
               "max_abs_err": err,
               "ms": _median_ms(
                   torch, lambda: decode_attention(q, k, v, vl), flush),
               "plain_ms": _median_ms(
                   torch, lambda: decode_attention_plain(q, k, v, vl), flush),
               "bound_ms": bounds[bound_by], "bound_by": bound_by,
               "library_ms": lib}
        print(f"  decode_attention B={B} S={S} valid_len={lens} {dt}: "
              f"{err} {ATOL} {RTOL[dt]} {row['ms']} {row['plain_ms']} {lib} "
              f"{row['bound_ms']} {bound_by}")
        if (lens, dt) == ([517], "bfloat16"):
            chosen["decode_attention"] = row
    return chosen


def reference_phase(torch, dev) -> None:
    """Reduced phi3-mini (f32 compute) on the card with the kernels and on
    the CPU with their plain versions: the same greedy tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)

    cfg = dataclasses.replace(reduced(get_config(PHI3)),
                              compute_dtype="float32")
    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), cpu)
    prompt = torch.arange(3, 40) % cfg.vocab_size
    runs = {}
    for d in (cpu, dev):
        p = _to(torch, cast_params(cfg, params), d)
        caches = init_cache(cfg, 1, 64, device=d)
        logits, caches = prefill(cfg, p, prompt[None].to(d), caches)
        toks, all_logits = [int(logits[0].argmax())], [logits.cpu()]
        for _ in range(8):
            tok = torch.tensor([toks[-1]], device=d)
            logits, caches = decode_step(cfg, p, tok, caches)
            toks.append(int(logits[0].argmax()))
            all_logits.append(logits.cpu())
        runs[d.type] = (toks, torch.cat(all_logits))
    (ct, cl), (gt, gl) = runs["cpu"], runs["cuda"]
    err = float((cl - gl).abs().max())
    print(f"reduced {PHI3} f32 greedy tokens: cpu {ct} cuda {gt}; "
          f"max logit diff {err}")
    if ct != gt or err > 1e-3:
        raise AssertionError("the card's tokens differ from the CPU's")


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


def serve_phase(torch, dev) -> tuple[int, int]:
    """Phase 5; returns the flash and decode launch counts of the run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.launch.serve import serve
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)

    cfg = get_config(PHI3)
    n_layers, max_new = cfg.n_layers, 16
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    lengths = [64, 512, 300, 137, 450, 64]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    prompts[5] = prompts[0]                   # the same prompt, twice

    flash_attention.launches = decode_attention.launches = 0
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=1024, max_new=max_new)
    flash_n, decode_n = flash_attention.launches, decode_attention.launches

    stats = eng.stats()
    tokens = sum(len(r.generated) for r in done)
    print(f"serve {PHI3} full width ({n_layers} layers): {len(done)} "
          f"requests, {tokens} tokens in {seconds} s = {tokens / seconds} "
          f"tokens/s; ttft p50 {stats['ttft_p50_s']} p99 "
          f"{stats['ttft_p99_s']} s; itl p50 {stats['itl_p50_s']} p99 "
          f"{stats['itl_p99_s']} s; preemptions {stats['preemptions']}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    by_id = sorted(done, key=lambda r: r.id)
    if len(done) != len(prompts) or any(len(r.generated) != max_new
                                        for r in done):
        raise AssertionError("not every request completed with "
                             f"{max_new} tokens")
    if by_id[0].generated != by_id[5].generated:
        raise AssertionError("the same prompt served twice gave "
                             f"{by_id[0].generated} and {by_id[5].generated}")
    prefills = len(done) + stats["preemptions"]
    decode_steps = len(done) * (max_new - 1)    # the first token is prefill's
    print(f"launches: flash {flash_n} ({n_layers} x {prefills} prefills = "
          f"{n_layers * prefills}), decode {decode_n} ({n_layers} x "
          f"{decode_steps} decode steps = {n_layers * decode_steps})")
    if stats["preemptions"] or flash_n != n_layers * prefills \
            or decode_n != n_layers * decode_steps:
        raise AssertionError("the serving path did not run every layer's "
                             "attention through the kernels")

    p = cast_params(cfg, params)
    caches = init_cache(cfg, 1, 1024, device=dev)
    prompt = torch.as_tensor(prompts[1][None], dtype=torch.long, device=dev)
    logits, caches = prefill(cfg, p, prompt, caches)
    logits2, caches = decode_step(cfg, p, logits.argmax(-1), caches)
    for name, lg in (("prefill", logits), ("decode", logits2)):
        if tuple(lg.shape) != (1, cfg.vocab_size) \
                or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name} logits: shape {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    if int(logits[0].argmax()) != by_id[1].generated[0]:
        raise AssertionError("a direct prefill disagrees with the engine")
    _decode_step_split(torch, cfg, p, logits2.argmax(-1), caches, dev)
    return flash_n, decode_n


def _decode_step_split(torch, cfg, params, tok, caches, dev) -> None:
    """Where one batch-1 decode step's time goes: the host's enqueue of
    its ops against enqueue plus the device finishing, beside the bytes
    bound of the step (every matmul weight and the cache rows read
    once)."""
    from repro_torch.models import decode_step

    enqueue, total = [], []
    for _ in range(10):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, caches = decode_step(cfg, params, tok, caches)
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        enqueue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)
    weights = sum(w.numel() * w.element_size()
                  for g in params["groups"] for sub in g.values()
                  for part in ("mixer", "ffn") for w in sub[part].values())
    weights += params["lm_head"].numel() * params["lm_head"].element_size()
    length = caches[0]["sub0"]["length"]
    kv = 2 * length * cfg.n_kv_heads * cfg.head_dim_ * 2 * cfg.n_layers
    bound = (weights + kv) / HBM_BYTES_S * 1e3
    print(f"decode step, batch 1, cache length {length}: host enqueue "
          f"median {statistics.median(enqueue)} ms, enqueue + device "
          f"median {statistics.median(total)} ms, bytes bound {bound} ms")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    chosen = kernel_phase(torch, dev)
    reference_phase(torch, dev)
    flash_n, decode_n = serve_phase(torch, dev)
    chosen["flash_attention"]["launches"] = flash_n
    chosen["decode_attention"]["launches"] = decode_n
    print(json.dumps({"kernels": list(chosen.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
