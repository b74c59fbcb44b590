#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version at the serving
   paths' shapes (phi3-mini, recurrentgemma-2b, llama4-maverick and
   deepseek-v2's routing) — every element within the tolerance of the
   plain version's f32 result (one bf16 rounding for a bf16 output; MoE
   gating's experts, slots and keep identical, gates within 1e-6), median
   time (CUDA events, L2 flushed before each launch), the plain version's
   time, ``torch.nn.functional.scaled_dot_product_attention``'s time on
   the same inputs for the attention kernels (a yardstick only: the port
   never calls it; no single PyTorch call computes the scan or the
   routing) and the bound;
4. small-input reference: reduced phi3-mini, recurrentgemma and llama4
   served on the card and on the CPU (plain kernels) give the same greedy
   tokens;
5. serve, three paths, each through ``repro_torch.launch.serve.serve``
   and the Executor over ``cuda:0`` with random weights from seed 0, 4
   slots and 16 new tokens per request, the launch counts zeroed before
   and read after each:
   - phi3-mini-3.8b, full width and depth: 6 requests of 64-512 prompt
     tokens, max_seq 1024; flash = 32 × prefills, decode = 32 × decode
     steps;
   - recurrentgemma-2b, full width and depth (f32 weights): the same 6
     requests and one of 3000 tokens (the 2048 window masks its prefill
     and its ring wraps), max_seq 4096; rglru_scan = 18 × prefills, flash
     = 8 × prefills, decode = 8 × decode steps;
   - llama4-maverick-400b-a17b at full width cut to 1 layer of 48 (bf16
     weights), the 6 requests, max_seq 1024; moe_gating = prefills +
     decode steps, flash = prefills, decode = decode steps.
   Every request completes with 16 tokens, a repeated prompt gets the
   same tokens, and a direct prefill and decode step give finite logits
   of the vocabulary's width.  Each path frees its weights before the
   next.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or without the repository's ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
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
RG = "recurrentgemma-2b"
LLAMA4 = "llama4-maverick-400b-a17b"


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


def _bounds(nbytes: float, flops: float, dt: str) -> tuple[float, str]:
    """The least time for the work, in ms, and what bounds it."""
    bounds = {"operations": flops / PEAK_FLOPS[dt] * 1e3,
              "bytes": nbytes / HBM_BYTES_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return bounds[bound_by], bound_by


def kernel_phase(torch, dev) -> dict:
    """Every kernel case of phase 3; returns the case chosen for each
    kernel's entry of the ``{"kernels": ...}`` line."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    print("kernel cases (name, shape, dtype, max_abs_err, atol, rtol, ms, "
          "plain_ms, library_ms, bound_ms, bound_by):")
    chosen = {}
    chosen.update(_flash_cases(torch, dev, randn, flush))
    chosen.update(_decode_cases(torch, dev, randn, flush))
    chosen.update(_rglru_cases(torch, dev, randn, flush))
    chosen.update(_gating_cases(torch, dev, randn, flush))
    return chosen


def _flash_cases(torch, dev, randn, flush) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain

    chosen = {}
    # phi3-mini (D 96), GQA at G 4 (D 128), llama4's prefill (H 40, K 8,
    # G 5, D 128), recurrentgemma (MQA, D 256, window 2048)
    for B, H, K, S, D, win, dt in [(1, 32, 32, 128, 96, None, "bfloat16"),
                                   (1, 32, 32, 512, 96, None, "bfloat16"),
                                   (1, 32, 32, 1000, 96, None, "bfloat16"),
                                   (1, 32, 8, 1000, 128, None, "bfloat16"),
                                   (1, 40, 8, 512, 128, None, "bfloat16"),
                                   (1, 32, 32, 512, 96, None, "float32"),
                                   (1, 10, 1, 512, 256, 2048, "bfloat16"),
                                   (1, 10, 1, 3000, 256, 2048, "bfloat16"),
                                   (1, 10, 1, 3000, 256, 2048, "float32")]:
        dtype = getattr(torch, dt)
        q, k, v = (randn((B, S, n, D), dtype) for n in (H, K, K))
        out = flash_attention(q, k, v, window=win)
        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                    window=win)
        err = _check(torch, "flash_attention", out, ref, dt)
        del ref
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if win is None:
            lib = _median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=H != K), flush)
        else:
            pos = torch.arange(S, device=dev)
            band = (pos[:, None] >= pos[None, :]) \
                & (pos[:, None] - pos[None, :] < win)
            lib = _median_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=H != K), flush)
        # each query row sees min(row + 1, window) keys: QK^T and PV
        seen = sum(min(i + 1, win or S) for i in range(S))
        flops = 4 * B * H * D * seen
        nbytes = 2 * (B * S * H * D + B * S * K * D) * dtype.itemsize
        bound, bound_by = _bounds(nbytes, flops, dt)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:106",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: flash_attention(
                   q, k, v, window=win), flush),
               "plain_ms": _median_ms(torch, lambda: flash_attention_plain(
                   q, k, v, window=win), flush),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
        print(f"  flash_attention B={B} H={H} K={K} S={S} D={D} window={win} "
              f"{dt}: {err} {ATOL} {RTOL[dt]} {row['ms']} {row['plain_ms']} "
              f"{lib} {bound} {bound_by}")
        if (S, K, D, dt) == (512, 32, 96, "bfloat16"):
            chosen["flash_attention"] = row
    return chosen


def _decode_cases(torch, dev, randn, flush) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, decode_attention_plain

    chosen = {}
    # phi3-mini (H = K = 32, D 96); recurrentgemma's ring (H 10, K 1, D
    # 256, S = window 2048); llama4 (H 40, K 8, D 128)
    for B, H, K, S, D, lens, dt in [
            (1, 32, 32, 1024, 96, [1], "bfloat16"),
            (1, 32, 32, 1024, 96, [517], "bfloat16"),
            (1, 32, 32, 1024, 96, [1024], "bfloat16"),
            (4, 32, 32, 1024, 96, [1024, 517, 64, 1], "bfloat16"),
            (1, 32, 32, 1024, 96, [517], "float32"),
            (1, 10, 1, 2048, 256, [1], "bfloat16"),
            (1, 10, 1, 2048, 256, [1000], "bfloat16"),
            (1, 10, 1, 2048, 256, [2048], "bfloat16"),
            (1, 10, 1, 2048, 256, [1000], "float32"),
            (1, 40, 8, 1024, 128, [517], "bfloat16")]:
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
            qt, kt, vt, attn_mask=mask, enable_gqa=H != K), flush)
        rows = sum(min(n, S) for n in lens)
        nbytes = dtype.itemsize * (2 * rows * K * D + 2 * B * H * D) + 4 * B
        bound, bound_by = _bounds(nbytes, 4 * rows * (H // K) * K * D, dt)
        row = {"name": "decode_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention/kernel.py:90",
               "max_abs_err": err,
               "ms": _median_ms(
                   torch, lambda: decode_attention(q, k, v, vl), flush),
               "plain_ms": _median_ms(
                   torch, lambda: decode_attention_plain(q, k, v, vl), flush),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
        print(f"  decode_attention B={B} H={H} K={K} S={S} D={D} "
              f"valid_len={lens} {dt}: {err} {ATOL} {RTOL[dt]} {row['ms']} "
              f"{row['plain_ms']} {lib} {bound} {bound_by}")
        if (H, lens, dt) == (32, [517], "bfloat16"):
            chosen["decode_attention"] = row
    return chosen


def _rglru_cases(torch, dev, randn, flush) -> dict:
    """recurrentgemma's prefill scan (B 1, d_rnn 2560, f32), a bf16 case
    and a ragged batch.  No single PyTorch call computes the scan, so
    library_ms is null."""
    from repro_torch.kernels import rglru_scan, rglru_scan_plain

    chosen = {}
    for B, S, dr, dt in [(1, 512, 2560, "float32"),
                         (1, 3000, 2560, "float32"),
                         (1, 3000, 2560, "bfloat16"),
                         (4, 37, 2560, "float32")]:
        dtype = getattr(torch, dt)
        x = randn((B, S, dr), dtype)
        a = torch.sigmoid(randn((B, S, dr), torch.float32)).to(dtype)
        h0 = randn((B, dr), torch.float32)
        out = rglru_scan(x, a, h0)
        ref = rglru_scan_plain(x.float(), a.float(), h0)
        err = _check(torch, "rglru_scan", out, ref, dt)
        nbytes = 3 * B * S * dr * dtype.itemsize + 4 * B * dr
        bound, bound_by = _bounds(nbytes, 2 * B * S * dr, "float32")
        row = {"name": "rglru_scan", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
               "replaces": "src/repro/kernels/rglru_scan/kernel.py:66",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: rglru_scan(x, a, h0), flush),
               "plain_ms": _median_ms(
                   torch, lambda: rglru_scan_plain(x, a, h0), flush, reps=5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        print(f"  rglru_scan B={B} S={S} dr={dr} {dt}: {err} {ATOL} "
              f"{RTOL[dt]} {row['ms']} {row['plain_ms']} None {bound} "
              f"{bound_by}")
        if (S, dt) == (3000, "float32"):
            chosen["rglru_scan"] = row
    return chosen


def _gating_cases(torch, dev, randn, flush) -> dict:
    """llama4's routing (E 128, top-1) at a decode step and a 512-token
    prefill, deepseek-v2's (E 160, top-6) over 4096 tokens at a capacity
    that drops entries, and tied logits.  eids, slots and keep must equal
    the plain version's; gates within 1e-6.  No single PyTorch call
    computes the routing, so library_ms is null."""
    from repro_torch.kernels import moe_gating, moe_gating_plain

    chosen = {}
    for name, T, E, k, C, tied in [("llama4 decode", 1, 128, 1, 8, False),
                                   ("llama4 prefill", 512, 128, 1, 8, False),
                                   ("deepseek-v2", 4096, 160, 6, 64, False),
                                   ("tied logits", 512, 128, 2, 8, True)]:
        logits = randn((T, E), torch.float32) * 3
        if tied:                      # values in {-1, 0, 1}: many ties
            logits = (logits / 2).round().clamp(-1, 1)
        got = moe_gating(logits, top_k=k, capacity=C)
        want = moe_gating_plain(logits, top_k=k, capacity=C)
        for g, w, what in zip(got, want, ("eids", "gates", "slots", "keep")):
            err = float((g.float() - w.float()).abs().max())
            if err > (1e-6 if what == "gates" else 0.0):
                raise AssertionError(f"moe_gating {name}: {what} differ from "
                                     f"the plain version by {err}")
        err = float((got[1] - want[1]).abs().max())
        dropped = int((~got[3]).sum())
        nbytes = 4 * T * E + T * k * (4 + 4 + 4 + 1)
        bound, bound_by = _bounds(nbytes, T * E * (4 + k), "float32")
        row = {"name": "moe_gating", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
               "replaces": "src/repro/kernels/moe_gating/kernel.py:73",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: moe_gating(
                   logits, top_k=k, capacity=C), flush),
               "plain_ms": _median_ms(torch, lambda: moe_gating_plain(
                   logits, top_k=k, capacity=C), flush),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        print(f"  moe_gating {name} T={T} E={E} k={k} C={C}: eids/slots/keep "
              f"identical, {dropped} dropped, gates err {err} (tol 1e-6) "
              f"{row['ms']} {row['plain_ms']} None {bound} {bound_by}")
        if name == "llama4 prefill":
            chosen["moe_gating"] = row
    return chosen


def reference_phase(torch, dev) -> None:
    """Reduced phi3-mini, recurrentgemma and llama4 (f32 compute) on the
    card with the kernels and on the CPU with their plain versions: the
    same greedy tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)

    cpu = torch.device("cpu")
    for arch in (PHI3, RG, LLAMA4):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32")
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
        print(f"reduced {arch} f32 greedy tokens: cpu {ct} cuda {gt}; "
              f"max logit diff {err}")
        if ct != gt or err > 1e-3:
            raise AssertionError(f"{arch}: the card's tokens differ from the "
                                 f"CPU's")


def _to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _to(torch, v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, device) for v in tree]
    return tree.to(device)


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") else 0


#: the kernels whose launches each serve phase counts
COUNTED = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating")


def serve_phase(torch, dev, cfg, lengths, max_seq, *,
                long_prompt=None) -> tuple[dict, int, int]:
    """Serve ``cfg`` (full width, random weights from seed 0) through
    ``serve()`` and the Executor over ``dev``: prompts of ``lengths``
    tokens (the sixth gets the first one's prompt), 16 new tokens each, 4
    slots.  Every request completes, the repeated
    prompt gets the same tokens, and a direct prefill (of request
    ``long_prompt``, default the second) and decode step give finite
    logits of the vocabulary's width, the prefill's token the engine's.
    Returns the kernels' launch counts of the serving run, its prefills
    and its decode steps."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)

    max_new = 16
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    prompts[5] = prompts[0]                   # the same prompt, twice

    for name in COUNTED:
        getattr(kernels, name).launches = 0
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=max_seq, max_new=max_new)
    counts = {name: getattr(kernels, name).launches for name in COUNTED}

    stats = eng.stats()
    tokens = sum(len(r.generated) for r in done)
    print(f"serve {cfg.arch_id} full width ({cfg.n_layers} layers, "
          f"{cfg.param_dtype} weights drawn in {init_s} s): {len(done)} "
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
    a, b = by_id[0].generated, by_id[5].generated
    if a != b:
        raise AssertionError(f"the same prompt served twice gave {a} and {b}")
    if stats["preemptions"]:
        raise AssertionError("a request was preempted: the launch counts "
                             "below assume one prefill per request")

    p = eng.params
    del eng
    i = 1 if long_prompt is None else long_prompt
    caches = init_cache(cfg, 1, max_seq, device=dev)
    prompt = torch.as_tensor(prompts[i][None], dtype=torch.long, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, p, prompt, caches)
    torch.cuda.synchronize(dev)
    print(f"direct prefill of {prompt.shape[1]} tokens (warm): "
          f"{time.perf_counter() - t0} s")
    logits2, caches = decode_step(cfg, p, logits.argmax(-1), caches)
    for name, lg in (("prefill", logits), ("decode", logits2)):
        if tuple(lg.shape) != (1, cfg.vocab_size) \
                or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name} logits: shape {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    if int(logits[0].argmax()) != by_id[i].generated[0]:
        raise AssertionError("a direct prefill disagrees with the engine")
    _decode_step_split(torch, cfg, p, logits2.argmax(-1), caches, dev)
    return counts, len(done), len(done) * (max_new - 1)


def _check_counts(counts: dict, want: dict) -> None:
    print("launches: " + ", ".join(f"{k} {counts[k]} (want {want[k]})"
                                   for k in COUNTED))
    if counts != want:
        raise AssertionError("the serving path did not run every layer "
                             "through its kernels")


def _decode_step_split(torch, cfg, params, tok, caches, dev) -> None:
    """Where one batch-1 decode step's time goes: the host's enqueue of
    its ops against enqueue plus the device finishing, beside the bytes
    bound of the step (every matmul weight, the cache rows in use and the
    recurrent states read once)."""
    from repro_torch.models import decode_step
    from repro_torch.models.transformer import _cache_length

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
    weights = _tree_bytes(params["groups"]) + _tree_bytes(params["lm_head"])
    length = _cache_length(caches)
    state = 0
    for group in caches:
        for sub in group.values():
            if "k" in sub:       # (count, B, W, K, hd): the rows in use
                k = sub["k"]
                rows = min(length, k.shape[2])
                state += 2 * k.shape[0] * rows * k[0, 0, 0].numel() \
                    * k.element_size()
            else:
                state += _tree_bytes(sub)
    bound = (weights + state) / HBM_BYTES_S * 1e3
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

    from repro_torch.configs import get_config
    from repro_torch.configs.base import LayerGroup
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t_start} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    chosen = kernel_phase(torch, dev)
    reference_phase(torch, dev)
    launches = {}

    def path(name, cfg, lengths, max_seq, want, **kw):
        counts, prefills, steps = serve_phase(torch, dev, cfg, lengths,
                                              max_seq, **kw)
        _check_counts(counts, want(prefills, steps))
        for k, n in counts.items():
            launches.setdefault(k, {})[name] = n
        gc.collect()
        torch.cuda.empty_cache()          # the next model's weights fit

    # phi3-mini: 32 attention layers
    phi3 = get_config(PHI3)
    path(PHI3, phi3, [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 32 * p, "decode_attention": 32 * s,
                       "rglru_scan": 0, "moe_gating": 0})
    # recurrentgemma-2b: 18 RG-LRU and 8 local-attention layers; the
    # 3000-token prompt is masked by the 2048 window and wraps the ring
    path(RG, get_config(RG), [64, 512, 300, 137, 450, 64, 3000], 4096,
         lambda p, s: {"flash_attention": 8 * p, "decode_attention": 8 * s,
                       "rglru_scan": 18 * p, "moe_gating": 0},
         long_prompt=6)
    # llama4-maverick at full width, 1 layer of 48, bf16 weights
    llama4 = dataclasses.replace(
        get_config(LLAMA4), param_dtype="bfloat16",
        groups=(LayerGroup(pattern=("attn",), count=1, ffn="moe"),))
    path(LLAMA4, llama4, [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": p, "decode_attention": s,
                       "rglru_scan": 0, "moe_gating": p + s})

    for name, row in chosen.items():
        row["launches"] = sum(launches[name].values())
        row["launches_by_path"] = launches[name]
    print(f"total: {time.perf_counter() - t_start} s")
    print(json.dumps({"kernels": list(chosen.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
