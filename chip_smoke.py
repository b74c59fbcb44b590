#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the six CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version at the serving
   paths' shapes (phi3-mini, recurrentgemma-2b, llama4-maverick,
   deepseek-v2's MLA heads (q/k 192, v 128) and routing, qwen2-vl's
   GQA and musicgen's D 64), with the scan's and the gating's launch
   shapes — every element within the tolerance of the
   plain version's f32 result (one bf16 rounding for a bf16 output; MoE
   gating's experts, slots and keep identical, gates within 1e-6), median
   time (CUDA events, L2 flushed before each launch), the plain version's
   time, ``torch.nn.functional.scaled_dot_product_attention``'s time on
   the same inputs for the attention kernels (a yardstick only: the port
   never calls it; where Dv != D, the first backend that takes it, named
   in the output; no single PyTorch call computes the scan or the
   routing) and the bound;
4. small-input reference: reduced phi3-mini, recurrentgemma, llama4,
   xLSTM (the reference's canary stack of one mLSTM and one sLSTM block,
   twice), deepseek-v2, qwen2-vl and musicgen served on the card and on
   the CPU (plain kernels) give the same greedy tokens, and on the card
   the decode step replayed from its CUDA graph gives the eager step's
   tokens and logits; qwen2-vl's prefill of stub patch embeddings at
   distinct (t, h, w) positions gives the CPU's logits;
5. serve, seven paths, each through ``repro_torch.launch.serve.serve``
   and the Executor over ``cuda:0`` with random weights from seed 0, 4
   slots and 16 new tokens per request, every decode step replayed from
   its slot's CUDA graph, the launch counts zeroed before and read after
   each (a decode step counts the engine's one eager warm-up step and
   every replay, which adds the launches its graph holds):
   - phi3-mini-3.8b, full width and depth: 6 requests of 64-512 prompt
     tokens, max_seq 1024; flash = 32 × prefills, decode = 32 × decode
     steps;
   - recurrentgemma-2b, full width and depth (f32 weights): the same 6
     requests and one of 3000 tokens (the 2048 window masks its prefill
     and its ring wraps), max_seq 4096; rglru_scan = 18 × prefills, flash
     = 8 × prefills, decode = 8 × decode steps;
   - llama4-maverick-400b-a17b at full width cut to 1 layer of 48 (bf16
     weights), the 6 requests, max_seq 1024; moe_gating = prefills +
     decode steps, flash = prefills, decode = decode steps;
   - xlstm-1.3b, full width and depth (48 blocks, f32), the 6 requests,
     max_seq 1024; no kernel (the reference has none for xLSTM);
   - deepseek-v2-236b at full width cut to 2 layers of 60 (the dense
     first layer and one MoE layer, 160 experts top-6 + 2 shared; f32
     weights), the 6 requests, max_seq 1024; flash = 2 × prefills,
     decode = 2 × decode steps, moe_gating = prefills + decode steps;
   - qwen2-vl-7b, full width and depth (28 layers, M-RoPE, f32), the 6
     text requests, max_seq 1024; flash = 28 × prefills, decode = 28 ×
     decode steps;
   - musicgen-large, full width and depth (48 layers, f32), 6 requests
     of stub EnCodec ids (``make_audio_tokens``), max_seq 1024; flash =
     48 × prefills, decode = 48 × decode steps.
   Every request completes with 16 tokens, a repeated prompt gets the
   same tokens, every decode step was a replay, and a direct prefill and
   decode step give finite logits of the vocabulary's width.  After it,
   one decode step from the same cache state, eager and replayed: their
   logits agree, and each step's time split (eager: host enqueue, enqueue
   plus device and the bytes bound; graphed: the replay's enqueue and
   enqueue plus device).  Each path frees its weights before the next.

6. train, two paths, each through ``repro_torch.launch.train.train``
   (the reference launcher's graph: host(data) → pull(batch) →
   kernel(step) → host(metrics)) and the Executor over ``cuda:0``, random
   weights from seed 0, ``SyntheticSource`` batches, f32 master weights,
   bf16 compute, remat ``full``, eager steps, the launch counts zeroed
   before and read after each:
   - minicpm-2b, full width and depth (40 layers, tied 122753 vocab),
     WSD, B 4 × S 1024, 6 steps; per step flash = 80 (40 forwards and
     40 recomputed ones), flash_bwd = 40;
   - recurrentgemma-2b, full width and depth (26 layers, untied 256000
     vocab), cosine, B 1 × S 3072 (the 2048 window masks), 4 steps; per
     step rglru_scan = 36, rglru_scan_bwd = 18, flash = 16, flash_bwd = 8.
   Losses and gradient norms are finite; printed: the median step time
   past the first (warm-up) step, tokens/s, MFU against 989 TFLOP/s
   (model FLOPs 6·N·T over the matmul parameters plus the attention
   products, recomputation not counted) and peak memory.

Phase 3 also holds the forward's log-sum-exp output and the two
backward kernels (``flash_attention_bwd`` at the two train shapes in
bf16 and a small f32 one, with SDPA's backward as the yardstick and its
backend named; ``rglru_scan_bwd`` at recurrentgemma's train shape in f32
and bf16) against their plain versions.  Phase 4 also trains reduced
minicpm-2b, recurrentgemma and llama4 (f32 compute) for 3 steps on the
card and on the CPU from one state (per-step losses within 1e-4, params
within 1e-4 + 1e-5·|p|, the bounds of ``tests/test_torch_training.py``),
drives reduced phi3-mini's loss down by 0.5 in 12 steps on one repeated
batch, and round-trips a reduced train state through ``async_save`` and
``restore`` bit for bit.

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
import tempfile
import time
import warnings
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
MINICPM = "minicpm-2b"
RG = "recurrentgemma-2b"
LLAMA4 = "llama4-maverick-400b-a17b"
XLSTM = "xlstm-1.3b"
DSV2 = "deepseek-v2-236b"
QWEN2VL = "qwen2-vl-7b"
MUSICGEN = "musicgen-large"


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
    chosen.update(_flash_bwd_cases(torch, dev, randn, flush))
    chosen.update(_rglru_bwd_cases(torch, dev, randn, flush))
    return chosen


def _flash_cases(torch, dev, randn, flush) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain

    chosen = {}
    # phi3-mini (D 96), GQA at G 4 (D 128), llama4's prefill (H 40, K 8,
    # G 5, D 128), recurrentgemma (MQA, D 256, window 2048), deepseek-v2's
    # MLA (q/k 192, v 128), qwen2-vl (H 28, K 4, G 7) and musicgen (D 64)
    for B, H, K, S, D, Dv, win, dt in [
            (1, 32, 32, 128, 96, 96, None, "bfloat16"),
            (1, 32, 32, 512, 96, 96, None, "bfloat16"),
            (1, 32, 32, 1000, 96, 96, None, "bfloat16"),
            (1, 32, 8, 1000, 128, 128, None, "bfloat16"),
            (1, 40, 8, 512, 128, 128, None, "bfloat16"),
            (1, 32, 32, 512, 96, 96, None, "float32"),
            (1, 10, 1, 512, 256, 256, 2048, "bfloat16"),
            (1, 10, 1, 3000, 256, 256, 2048, "bfloat16"),
            (1, 10, 1, 3000, 256, 256, 2048, "float32"),
            (1, 128, 128, 512, 192, 128, None, "bfloat16"),
            (1, 128, 128, 512, 192, 128, None, "float32"),
            (1, 28, 4, 512, 128, 128, None, "bfloat16"),
            (1, 32, 32, 512, 64, 64, None, "bfloat16")]:
        dtype = getattr(torch, dt)
        q, k = (randn((B, S, n, D), dtype) for n in (H, K))
        v = randn((B, S, K, Dv), dtype)
        scale = D ** -0.5
        out = flash_attention(q, k, v, window=win, scale=scale)
        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                    window=win, scale=scale)
        err = _check(torch, "flash_attention", out, ref, dt)
        del ref
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if win is None:
            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale,
                    enable_gqa=H != K)
        else:
            pos = torch.arange(S, device=dev)
            band = (pos[:, None] >= pos[None, :]) \
                & (pos[:, None] - pos[None, :] < win)

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, scale=scale,
                    enable_gqa=H != K)
        lib, backend = _sdpa_ms(torch, sdpa, flush, pinned=Dv != D)
        # each query row sees min(row + 1, window) keys: QK^T over D and
        # PV over Dv
        seen = sum(min(i + 1, win or S) for i in range(S))
        flops = 2 * B * H * (D + Dv) * seen
        nbytes = (B * S * (H + K) * (D + Dv)) * dtype.itemsize
        bound, bound_by = _bounds(nbytes, flops, dt)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention/kernel.py:106",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: flash_attention(
                   q, k, v, window=win, scale=scale), flush),
               "plain_ms": _median_ms(torch, lambda: flash_attention_plain(
                   q, k, v, window=win, scale=scale), flush),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
        print(f"  flash_attention B={B} H={H} K={K} S={S} D={D} Dv={Dv} "
              f"window={win} {dt}: {err} {ATOL} {RTOL[dt]} {row['ms']} "
              f"{row['plain_ms']} {lib} ({backend}) {bound} {bound_by}")
        if (S, K, D, dt) == (512, 32, 96, "bfloat16"):
            chosen["flash_attention"] = row
    return chosen


#: SDPA's backends, in the order tried where one must take Dv != D
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def _sdpa_ms(torch, sdpa, flush, *, pinned: bool) -> tuple[float, str]:
    """SDPA's time on the case (a yardstick only) and the backend that ran:
    PyTorch's own choice, or, ``pinned`` (a value head dim unlike q's,
    which not every backend takes), the first of ``SDPA_BACKENDS`` that
    accepts the inputs."""
    if not pinned:
        return _median_ms(torch, sdpa, flush), "default"
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                with warnings.catch_warnings():   # why a backend declined
                    warnings.simplefilter("ignore", UserWarning)
                    sdpa()
            except RuntimeError:
                continue
            return _median_ms(torch, sdpa, flush), name
    raise AssertionError("no SDPA backend takes the case")


def _decode_cases(torch, dev, randn, flush) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention, decode_attention_plain

    chosen = {}
    # phi3-mini (H = K = 32, D 96); recurrentgemma's ring (H 10, K 1, D
    # 256, S = window 2048); llama4 (H 40, K 8, D 128); deepseek-v2's MLA
    # (H = K = 128, q/k 192, v 128); qwen2-vl (H 28, K 4); musicgen (D 64)
    for B, H, K, S, D, Dv, lens, dt in [
            (1, 32, 32, 1024, 96, 96, [1], "bfloat16"),
            (1, 32, 32, 1024, 96, 96, [517], "bfloat16"),
            (1, 32, 32, 1024, 96, 96, [1024], "bfloat16"),
            (4, 32, 32, 1024, 96, 96, [1024, 517, 64, 1], "bfloat16"),
            (1, 32, 32, 1024, 96, 96, [517], "float32"),
            (1, 10, 1, 2048, 256, 256, [1], "bfloat16"),
            (1, 10, 1, 2048, 256, 256, [1000], "bfloat16"),
            (1, 10, 1, 2048, 256, 256, [2048], "bfloat16"),
            (1, 10, 1, 2048, 256, 256, [1000], "float32"),
            (1, 40, 8, 1024, 128, 128, [517], "bfloat16"),
            (1, 128, 128, 1024, 192, 128, [517], "bfloat16"),
            (1, 128, 128, 1024, 192, 128, [517], "float32"),
            (1, 28, 4, 1024, 128, 128, [517], "bfloat16"),
            (1, 32, 32, 1024, 64, 64, [517], "bfloat16")]:
        dtype = getattr(torch, dt)
        q = randn((B, H, D), dtype)
        k, v = randn((B, S, K, D), dtype), randn((B, S, K, Dv), dtype)
        vl = torch.tensor(lens, dtype=torch.int32, device=dev)
        scale = D ** -0.5
        out = decode_attention(q, k, v, vl, scale=scale)
        ref = decode_attention_plain(q.float(), k.float(), v.float(), vl,
                                     scale=scale)
        err = _check(torch, "decode_attention", out, ref, dt)
        qt = q[:, :, None]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = (torch.arange(S, device=dev)[None, :] < vl[:, None])
        mask = mask[:, None, None, :]
        lib, backend = _sdpa_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=H != K),
            flush, pinned=Dv != D)
        rows = sum(min(n, S) for n in lens)
        nbytes = dtype.itemsize * (rows * K * (D + Dv) + B * H * (D + Dv)) \
            + 4 * B
        bound, bound_by = _bounds(nbytes, 2 * rows * H * (D + Dv), dt)
        row = {"name": "decode_attention", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention/kernel.py:90",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: decode_attention(
                   q, k, v, vl, scale=scale), flush),
               "plain_ms": _median_ms(torch, lambda: decode_attention_plain(
                   q, k, v, vl, scale=scale), flush),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
        print(f"  decode_attention B={B} H={H} K={K} S={S} D={D} Dv={Dv} "
              f"valid_len={lens} {dt}: {err} {ATOL} {RTOL[dt]} {row['ms']} "
              f"{row['plain_ms']} {lib} ({backend}) {bound} {bound_by}")
        if (H, K, D, lens, dt) == (32, 32, 96, [517], "bfloat16"):
            chosen["decode_attention"] = row
    return chosen


def _rglru_cases(torch, dev, randn, flush) -> dict:
    """recurrentgemma's prefill scan (B 1, d_rnn 2560, f32) at a short
    prompt's 64 steps, 512 and 3000, a bf16 case and a ragged batch, each
    with the launch shape the wrapper picks.  No single PyTorch call
    computes the scan, so library_ms is null."""
    from repro_torch.kernels import rglru_scan, rglru_scan_plain
    from repro_torch.kernels.rglru_scan.ops import scan_launch_shape

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = {}
    for B, S, dr, dt in [(1, 64, 2560, "float32"),
                         (1, 512, 2560, "float32"),
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
        shape = scan_launch_shape(B, S, dr, dtype.itemsize, sms)
        print(f"  rglru_scan B={B} S={S} dr={dr} {dt} (route {shape.route}, "
              f"cb {shape.cb}, {shape.blocks} blocks, {shape.stages} stages "
              f"of {shape.rows} steps): {err} {ATOL} {RTOL[dt]} {row['ms']} "
              f"{row['plain_ms']} None {bound} {bound_by}")
        if (S, dt) == (3000, "float32"):
            chosen["rglru_scan"] = row
    return chosen


def _gating_cases(torch, dev, randn, flush) -> dict:
    """llama4's routing (E 128, top-1) at a decode step and a 512-token
    prefill, deepseek-v2's (E 160, top-6) over 4096 tokens at a capacity
    that drops entries and at its serving path's decode step (C 8) and
    512-token prefill (C 24), and tied logits.  eids, slots and keep must equal
    the plain version's; gates within 1e-6.  No single PyTorch call
    computes the routing, so library_ms is null."""
    from repro_torch.kernels import moe_gating, moe_gating_plain
    from repro_torch.kernels.moe_gating.ops import (gating_launch_shape,
                                                    max_cluster_blocks)

    chosen = {}
    for name, T, E, k, C, tied in [
            ("llama4 decode", 1, 128, 1, 8, False),
            ("llama4 prefill", 512, 128, 1, 8, False),
            ("deepseek-v2", 4096, 160, 6, 64, False),
            ("deepseek-v2 decode", 1, 160, 6, 8, False),
            ("deepseek-v2 prefill", 512, 160, 6, 24, False),
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
        nb, threads = gating_launch_shape(T, max_cluster_blocks())
        print(f"  moe_gating {name} T={T} E={E} k={k} C={C} ({nb} blocks of "
              f"{threads} threads): eids/slots/keep identical, {dropped} "
              f"dropped, gates err {err} (tol 1e-6) {row['ms']} "
              f"{row['plain_ms']} None {bound} {bound_by}")
        if name == "llama4 prefill":
            chosen["moe_gating"] = row
    return chosen


def _flash_bwd_cases(torch, dev, randn, flush) -> dict:
    """The forward's log-sum-exp output and the flash backward at the two
    train paths' shapes (minicpm-2b: B 4, S 1024, H = K = 36, D 64;
    recurrentgemma-2b: B 1, S 3072, H 10, K 1, D 256, window 2048; bf16)
    and a small f32 case, against the plain versions on f32 copies of
    the same inputs.  Yardstick: SDPA's backward on the same q, k, v and
    dout (kv heads repeated to H), the backend named.  The bound counts
    the five products a flash backward needs (S again, dP, dV, dK, dQ:
    2.5x the forward's), not the kernel's two recomputations."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain)

    chosen = {}
    for name, B, H, K, S, D, win, dt in [
            ("minicpm-2b", 4, 36, 36, 1024, 64, None, "bfloat16"),
            ("recurrentgemma-2b", 1, 10, 1, 3072, 256, 2048, "bfloat16"),
            ("small", 1, 8, 2, 512, 64, None, "float32")]:
        dtype = getattr(torch, dt)
        q, k = (randn((B, S, n, D), dtype) for n in (H, K))
        v = randn((B, S, K, D), dtype)
        dout = randn((B, S, H, D), dtype)
        scale = D ** -0.5
        out, lse = flash_attention(q, k, v, window=win, scale=scale,
                                   with_lse=True)
        _, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                           window=win, scale=scale,
                                           with_lse=True)
        lse_err = _check(torch, "flash_attention lse", lse, ref_lse,
                         "float32")
        del ref_lse
        got = flash_attention_bwd(q, k, v, out, dout, lse, window=win,
                                  scale=scale)
        want = flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, out, dout)), lse, window=win,
            scale=scale)
        err = max(_check(torch, f"flash_attention_bwd d{n}", g, w, dt)
                  for n, g, w in zip("qkv", got, want))
        del got, want
        lib, backend = _sdpa_bwd_ms(torch, q, k, v, dout, win, scale, flush)
        seen = sum(min(i + 1, win or S) for i in range(S))
        flops = 2 * B * H * 5 * D * seen
        nbytes = dtype.itemsize * B * S * (4 * H * D + 4 * K * D) \
            + 4 * B * H * S
        bound, bound_by = _bounds(nbytes, flops, dt)
        row = {"name": "flash_attention_bwd", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "replaces": "src/repro/models/layers.py:194",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: flash_attention_bwd(
                   q, k, v, out, dout, lse, window=win, scale=scale), flush),
               "plain_ms": _median_ms(torch, lambda: flash_attention_bwd_plain(
                   q, k, v, out, dout, lse, window=win, scale=scale), flush,
                   reps=5),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": lib}
        print(f"  flash_attention_bwd {name} B={B} H={H} K={K} S={S} D={D} "
              f"window={win} {dt}: lse err {lse_err}; {err} {ATOL} "
              f"{RTOL[dt]} {row['ms']} {row['plain_ms']} {lib} (SDPA "
              f"backward, {backend}) {bound} {bound_by}")
        if name == "minicpm-2b":
            chosen["flash_attention_bwd"] = row
    return chosen


def _sdpa_bwd_ms(torch, q, k, v, dout, win, scale, flush):
    """SDPA's backward on (B, H, S, D) copies of the inputs (kv heads
    repeated to H), timed alone from a retained graph, and the first of
    ``SDPA_BACKENDS`` that takes the case (a window needs a mask)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H, K, S = q.shape[2], k.shape[2], q.shape[1]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt, vt = (t.repeat_interleave(H // K, dim=2).transpose(1, 2)
              .contiguous().requires_grad_(True) for t in (k, v))
    dt = dout.transpose(1, 2).contiguous()
    mask = None
    if win is not None:
        pos = torch.arange(S, device=q.device)
        mask = (pos[:, None] >= pos[None, :]) \
            & (pos[:, None] - pos[None, :] < win)
    for name in SDPA_BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                with warnings.catch_warnings():   # why a backend declined
                    warnings.simplefilter("ignore", UserWarning)
                    out = F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                        scale=scale)
                    torch.autograd.grad(out, (qt, kt, vt), dt,
                                        retain_graph=True)
            except RuntimeError:
                continue
            ms = _median_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), dt, retain_graph=True), flush)
            return ms, name
    raise AssertionError("no SDPA backend takes the backward case")


def _rglru_bwd_cases(torch, dev, randn, flush) -> dict:
    """The scan's backward at recurrentgemma's train shape (B 1, S 3072,
    d_rnn 2560) in f32 (bit for bit with the plain version, whose steps
    round as the kernel's) and bf16, with the launch shape the wrapper
    picks.  No single PyTorch call computes it: library_ms is null."""
    from repro_torch.kernels import rglru_scan_bwd, rglru_scan_bwd_plain
    from repro_torch.kernels.rglru_scan.ops import scan_launch_shape

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = {}
    B, S, dr = 1, 3072, 2560
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        dy, h = randn((B, S, dr), dtype), randn((B, S, dr), dtype)
        a = torch.sigmoid(randn((B, S, dr), torch.float32)).to(dtype)
        h0 = randn((B, dr), torch.float32)
        got = rglru_scan_bwd(dy, a, h, h0)
        want = rglru_scan_bwd_plain(dy, a, h, h0)
        err = max(_check(torch, f"rglru_scan_bwd {n}", g, w, dt)
                  for n, g, w in zip(("dx", "da", "dh0"), got, want))
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        if dt == "float32" and not exact:
            raise AssertionError("rglru_scan_bwd: f32 is not bit for bit "
                                 "the plain version")
        nbytes = 5 * B * S * dr * dtype.itemsize + 8 * B * dr
        bound, bound_by = _bounds(nbytes, 3 * B * S * dr, "float32")
        row = {"name": "rglru_scan_bwd", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/rglru_scan_bwd.cu",
               "replaces": "src/repro/models/recurrent.py:91",
               "max_abs_err": err,
               "ms": _median_ms(torch, lambda: rglru_scan_bwd(dy, a, h, h0),
                                flush),
               "plain_ms": _median_ms(
                   torch, lambda: rglru_scan_bwd_plain(dy, a, h, h0), flush,
                   reps=3),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
        shape = scan_launch_shape(B, S, dr, dtype.itemsize, sms, inputs=3,
                                  outputs=2)
        print(f"  rglru_scan_bwd B={B} S={S} dr={dr} {dt} (route "
              f"{shape.route}, cb {shape.cb}, {shape.blocks} blocks, "
              f"{shape.stages} stages of {shape.rows} steps): {err} "
              f"(bit-identical: {exact}) {ATOL} {RTOL[dt]} {row['ms']} "
              f"{row['plain_ms']} None {bound} {bound_by}")
        if dt == "float32":
            chosen["rglru_scan_bwd"] = row
    return chosen


def reference_phase(torch, dev) -> None:
    """Reduced phi3-mini, recurrentgemma, llama4, xLSTM, deepseek-v2 (MLA),
    qwen2-vl (M-RoPE) and musicgen (f32 compute) on the card with the
    kernels and on the CPU with their plain versions: the same greedy
    tokens.  xLSTM runs the reference's canary stack (one mLSTM and one
    sLSTM block, twice): its reduced 16-block stack turns a last-bit
    difference into logit differences past a greedy margin.  On the card,
    a decode step replayed from its CUDA graph gives the eager step's
    tokens and logits bit for bit.  qwen2-vl also prefills stub patch
    embeddings at distinct (t, h, w) positions, card against CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import LayerGroup
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill, reset_cache)
    from repro_torch.serving.graphs import DecodeGraphs

    cpu = torch.device("cpu")
    canary = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)
    for arch in (PHI3, RG, LLAMA4, XLSTM, DSV2, QWEN2VL, MUSICGEN):
        kw = {"groups": canary} if arch == XLSTM else {}
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32", **kw)
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
        # the same steps replayed from a CUDA graph over the slot's cache
        caches = init_cache(cfg, 1, 64, device=dev)
        graphs = DecodeGraphs(cfg, p, [caches], dev)
        reset_cache(cfg, caches)
        logits, caches = prefill(cfg, p, prompt[None].to(dev), caches)
        toks, all_logits = [int(logits[0].argmax())], [logits.cpu()]
        for n in range(8):
            logits = graphs.step(0, toks[-1], len(prompt) + n)
            toks.append(int(logits[0].argmax()))
            all_logits.append(logits.cpu())
        diff = float((torch.cat(all_logits) - gl).abs().max())
        print(f"  graphed decode on the card: tokens {toks}; max logit diff "
              f"to the eager steps {diff}")
        if toks != gt or diff != 0.0:
            raise AssertionError(f"{arch}: the graphed decode steps differ "
                                 f"from the eager ones")
        if arch == QWEN2VL:
            _patch_prefill(torch, cfg, params, prompt, dev)


#: training on the card against the CPU (phase 4): per-step losses and
#: the params after 3 steps at lr 1e-3, the bounds of
#: tests/test_torch_training.py (MODEL_TOL's rtol, STEP_TOL)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL, TRAIN_PARAM_RTOL = 1e-4, 1e-4, 1e-5


def train_reference_phase(torch, dev) -> None:
    """Reduced minicpm-2b, recurrentgemma and llama4 (f32 compute, remat
    full) trained 3 steps from one state on the CPU (plain kernels) and
    on the card (forward and backward kernels, the gating kernel with the
    recomputed gates): the same losses and params.  Reduced phi3-mini
    (bf16 compute) memorises one batch: loss down by 0.5 in 12 steps.  A
    reduced train state on the card survives async_save and restore bit
    for bit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import Executor
    from repro_torch.data import SyntheticSource
    from repro_torch.training import (AdamWConfig, checkpoint,
                                      init_train_state, make_train_step,
                                      wsd_schedule)
    from repro_torch.training.optimizer import leaves

    cpu = torch.device("cpu")
    opt = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    for arch in (MINICPM, RG, LLAMA4):
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32")
        state0 = init_train_state(cfg, torch.Generator().manual_seed(0), cpu)
        runs = []
        for d in (cpu, dev):
            state = _to(torch, _clone(torch, state0), d)
            step = make_train_step(cfg, opt, remat_policy="full")
            losses = []
            for i in range(3):
                b = SyntheticSource(cfg.vocab_size, seed=i).batch(0, 4, 16)
                state, m = step(state, {k: torch.from_numpy(x).to(d)
                                        for k, x in b.items()})
                losses.append(float(m["total_loss"]))
            with torch.no_grad():
                runs.append((losses, _to(torch, state["params"], cpu)))
        (cl, cp), (gl, gp) = runs
        loss_ok = all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                      for a, b in zip(gl, cl))
        excess = max(float(((x - y).abs() - TRAIN_PARAM_ATOL
                            - TRAIN_PARAM_RTOL * y.abs()).max())
                     for x, y in zip(leaves(gp), leaves(cp)))
        diff = max(float((x - y).abs().max())
                   for x, y in zip(leaves(gp), leaves(cp)))
        print(f"reduced {arch} f32 train, 3 steps: cpu losses {cl} cuda "
              f"{gl}; max param diff {diff} (tol {TRAIN_PARAM_ATOL} + "
              f"{TRAIN_PARAM_RTOL}·|p|)")
        if not loss_ok or excess > 0:
            raise AssertionError(f"{arch}: training on the card differs "
                                 f"from the CPU")

    cfg = reduced(get_config(PHI3))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    step = make_train_step(cfg, AdamWConfig(
        schedule=wsd_schedule(3e-4, 5, 50, 10), weight_decay=0.0),
        remat_policy="none")
    b = SyntheticSource(cfg.vocab_size).batch(0, 4, 16)
    batch = {k: torch.from_numpy(x).to(dev) for k, x in b.items()}
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["total_loss"]))
    print(f"reduced {PHI3} bf16 memorisation, 12 steps on one batch: loss "
          f"{losses[0]} -> {losses[-1]}")
    if not losses[-1] < losses[0] - 0.5:
        raise AssertionError("the memorisation loss did not fall by 0.5")

    cfg = reduced(get_config(MINICPM))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        with Executor(num_workers=2, devices=[dev]) as ex:
            checkpoint.async_save(ex, d, 1, state).result(timeout=120)
        restored, _ = checkpoint.restore(d, state)
    same = all(torch.equal(a, b) for a, b in zip(
        leaves(restored), leaves(state)))
    print(f"reduced {MINICPM} async_save -> restore on the card: "
          f"bit-identical {same}")
    if not same:
        raise AssertionError("a restored checkpoint differs from the state")


def _patch_prefill(torch, cfg, params, prompt, dev) -> None:
    """A prefill of stub patch embeddings (a 2 x 4 grid at t = 0) and the
    text after them at t = h = w = 3, 4, ..., card against CPU."""
    from repro_torch.models import cast_params, init_cache, prefill
    from repro_torch.models.frontends import make_patch_embeds

    P, S = cfg.n_visual_tokens, len(prompt)
    emb = make_patch_embeds(torch.Generator().manual_seed(0), 1, P,
                            cfg.d_model, dtype=torch.float32)
    grid = torch.stack([torch.zeros(P, dtype=torch.long),
                        torch.arange(P) // 4, torch.arange(P) % 4])
    text = torch.arange(3, 3 + S).expand(3, S)
    positions = torch.cat([grid, text], dim=1)[:, None]      # (3, 1, P + S)
    out = {}
    for d in (torch.device("cpu"), dev):
        p = _to(torch, cast_params(cfg, params), d)
        caches = init_cache(cfg, 1, 64, device=d)
        logits, _ = prefill(cfg, p, prompt[None].to(d), caches,
                            extra_embeds=emb.to(d),
                            positions=positions.to(d))
        out[d.type] = logits.cpu()
    err = float((out["cpu"] - out["cuda"]).abs().max())
    tok = [int(out[t][0].argmax()) for t in ("cpu", "cuda")]
    print(f"  qwen2-vl prefill of {P} patch embeddings + {S} tokens at "
          f"(t, h, w) positions: cpu token {tok[0]} cuda {tok[1]}; max "
          f"logit diff {err}")
    if tok[0] != tok[1] or err > 1e-3:
        raise AssertionError("qwen2-vl: the card's patch prefill differs "
                             "from the CPU's")


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


#: the kernels whose launches each serve and train phase counts
COUNTED = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating",
           "flash_attention_bwd", "rglru_scan_bwd")
#: the H100's bf16 dense peak, the MFU denominator
MFU_PEAK = PEAK_FLOPS["bfloat16"]


def serve_phase(torch, dev, cfg, lengths, max_seq, *,
                long_prompt=None) -> tuple[dict, int, int]:
    """Serve ``cfg`` (full width, random weights from seed 0) through
    ``serve()`` and the Executor over ``dev``: prompts of ``lengths``
    tokens (the sixth gets the first one's prompt; for the audio stub,
    codebook ids from ``make_audio_tokens``), 16 new tokens each, 4
    slots.  Every request completes, the repeated prompt gets the same
    tokens, every decode step is a graph replay, and a direct prefill (of
    request ``long_prompt``, default the second) and decode step give
    finite logits of the vocabulary's width, the prefill's token the
    engine's.  Returns the kernels' launch counts of the serving run, its
    prefills and its decode steps (the replays and the engine's warm-up
    step)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.launch.serve import serve
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill, reset_cache)
    from repro_torch.models.frontends import make_audio_tokens
    from repro_torch.serving.graphs import DecodeGraphs

    max_new = 16
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    if cfg.frontend == "audio_stub":
        gen = torch.Generator().manual_seed(0)
        prompts = [make_audio_tokens(gen, 1, n, cfg.vocab_size)[0].numpy()
                   for n in lengths]
    else:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    prompts[5] = prompts[0]                   # the same prompt, twice

    for name in COUNTED:
        getattr(kernels, name).launches = 0
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=max_seq, max_new=max_new)
    counts = {name: getattr(kernels, name).launches for name in COUNTED}

    stats = eng.stats()
    graphs = eng.decode_graphs
    tokens = sum(len(r.generated) for r in done)
    print(f"serve {cfg.arch_id} full width ({cfg.n_layers} layers, "
          f"{cfg.param_dtype} weights drawn in {init_s} s): {len(done)} "
          f"requests, {tokens} tokens in {seconds} s = {tokens / seconds} "
          f"tokens/s; ttft p50 {stats['ttft_p50_s']} p99 "
          f"{stats['ttft_p99_s']} s; itl p50 {stats['itl_p50_s']} p99 "
          f"{stats['itl_p99_s']} s; preemptions {stats['preemptions']}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B")
    print(f"decode graphs: {len(graphs.slots)} captured in "
          f"{graphs.capture_seconds} s (warm-up step included, before the "
          f"clock), {graphs.replays} replays; launches per replay "
          f"{graphs.slots[0].launches}")
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
    steps = len(done) * (max_new - 1)
    if graphs.replays != steps:
        raise AssertionError(f"{graphs.replays} replays for {steps} decode "
                             f"steps")

    p = eng.params
    del eng, graphs
    gc.collect()
    i = 1 if long_prompt is None else long_prompt
    caches = init_cache(cfg, 1, max_seq, device=dev)
    graphs = DecodeGraphs(cfg, p, [caches], dev)
    reset_cache(cfg, caches)
    prompt = torch.as_tensor(prompts[i][None], dtype=torch.long, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, p, prompt, caches)
    torch.cuda.synchronize(dev)
    print(f"direct prefill of {prompt.shape[1]} tokens (warm): "
          f"{time.perf_counter() - t0} s")
    # one step from the same cache state, eager on a copy and replayed
    eager = _clone(torch, caches)
    tok = int(logits[0].argmax())
    logits2, eager = decode_step(cfg, p, torch.tensor([tok], device=dev),
                                 eager)
    replayed = graphs.step(0, tok, prompt.shape[1]).clone()
    for name, lg in (("prefill", logits), ("decode", logits2),
                     ("graphed decode", replayed)):
        if tuple(lg.shape) != (1, cfg.vocab_size) \
                or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name} logits: shape {tuple(lg.shape)}, "
                                 f"finite {bool(torch.isfinite(lg).all())}")
    if tok != by_id[i].generated[0]:
        raise AssertionError("a direct prefill disagrees with the engine")
    err = float((replayed - logits2).abs().max())
    print(f"graphed against eager decode step, full width: max logit diff "
          f"{err} (bit-identical: {err == 0.0})")
    _check(torch, "graphed decode step", replayed, logits2, "float32")
    _decode_step_split(torch, cfg, p, int(logits2[0].argmax()), eager,
                       graphs, prompt.shape[1] + 1, dev)
    return counts, len(done), steps + DecodeGraphs.warmup_steps


def _clone(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(torch, v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _check_counts(counts: dict, want: dict) -> None:
    """``want`` names the kernels a path runs; every other one must have
    launched no time."""
    want = {k: 0 for k in COUNTED} | want
    print("launches: " + ", ".join(f"{k} {counts[k]} (want {want[k]})"
                                   for k in COUNTED))
    if counts != want:
        raise AssertionError("the path did not run every layer through its "
                             "kernels")


def _decode_step_split(torch, cfg, params, tok, caches, graphs, pos,
                       dev) -> None:
    """Where one batch-1 decode step's time goes, eager and replayed from
    its graph: the host's enqueue against enqueue plus the device
    finishing, beside the bytes bound of the step (every matmul weight,
    the cache rows in use (MLA's latent and rope rows) and the recurrent
    states read once).  The
    eager steps run on ``caches``, the replays on the graph's own caches,
    both from the position ``pos`` on."""
    from repro_torch.models import decode_step

    def split(step):
        enqueue, total = [], []
        for n in range(10):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step(n)
            t1 = time.perf_counter()
            torch.cuda.synchronize(dev)
            enqueue.append((t1 - t0) * 1e3)
            total.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(enqueue), statistics.median(total)

    state = {"caches": caches}

    def eager(n):
        _, state["caches"] = decode_step(
            cfg, params, torch.tensor([tok], device=dev), state["caches"])

    eager_split = split(eager)
    graphed_split = split(lambda n: graphs.step(0, tok, pos + n))
    weights = _tree_bytes(params["groups"]) + _tree_bytes(
        params.get("lm_head", params["embed"]))
    length = pos + 10
    state_bytes = 0
    for group in caches:
        for sub in group.values():
            # (count, B, W, ...) row caches: the rows in use of k and v,
            # or of MLA's latent c_kv and k_rope
            row_caches = [sub[key] for key in ("k", "v", "c_kv", "k_rope")
                          if key in sub]
            for t in row_caches:
                rows = min(length, t.shape[2])
                state_bytes += t.shape[0] * rows * t[0, 0, 0].numel() \
                    * t.element_size()
            if not row_caches:
                state_bytes += _tree_bytes(sub)
    bound = (weights + state_bytes) / HBM_BYTES_S * 1e3
    print(f"decode step, batch 1, cache length {length}: eager host enqueue "
          f"median {eager_split[0]} ms, enqueue + device median "
          f"{eager_split[1]} ms, bytes bound {bound} ms; graphed replay "
          f"enqueue median {graphed_split[0]} ms, enqueue + device median "
          f"{graphed_split[1]} ms")


def train_phase(torch, dev, cfg, *, batch: int, seq: int,
                steps: int) -> dict:
    """Train ``cfg`` (full width, random weights from seed 0) for
    ``steps`` steps through ``repro_torch.launch.train.train`` and the
    Executor over ``dev``, remat full; losses and gradient norms finite.
    Prints the median step time past the first step, tokens/s, MFU and
    peak memory; returns the kernels' launch counts of the run."""
    import math

    from repro_torch import kernels
    from repro_torch.launch.train import train
    from repro_torch.training.optimizer import leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for name in COUNTED:
        getattr(kernels, name).launches = 0
    out = train(cfg, steps=steps, batch=batch, seq=seq, device=dev,
                remat="full")
    counts = {name: getattr(kernels, name).launches for name in COUNTED}
    peak = torch.cuda.max_memory_allocated(dev)
    params = out["state"]["params"]
    n_params = sum(t.numel() for t in leaves(params))
    # the matmul parameters: all but the embedding lookup, whose table is
    # a matmul again where the head is tied
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else params["embed"].numel())
    losses, gnorms = out["losses"], out["grad_norms"]
    step_s = statistics.median(out["step_seconds"][1:])
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    tokens = batch * seq
    attn = 0
    for g in cfg.groups:
        for mixer in g.pattern:
            if mixer in ("attn", "attn_local"):
                win = cfg.rec.local_window if mixer == "attn_local" else None
                seen = sum(min(i + 1, win or seq) for i in range(seq))
                # QK^T and PV forward, twice that backward
                attn += g.count * 3 * 2 * batch * cfg.n_heads \
                    * 2 * cfg.head_dim_ * seen
    flops = 6 * n_matmul * tokens + attn
    print(f"train {cfg.arch_id} full width ({cfg.n_layers} layers, "
          f"{n_params} params, f32 master, {cfg.compute_dtype} compute, "
          f"remat full), B {batch} x S {seq}, {steps} steps: losses "
          f"{losses}; grad norms {gnorms}; median step (past the first) "
          f"{step_s} s = {tokens / step_s} tokens/s; model FLOPs per step "
          f"{flops} (6·N·T with N = {n_matmul} matmul params, plus "
          f"attention {attn}; recomputation not counted) = MFU "
          f"{flops / step_s / MFU_PEAK} of {MFU_PEAK / 1e12:.0f} TFLOP/s; "
          f"max_memory_allocated {peak} B")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{cfg.arch_id}: a loss or grad norm is not "
                             f"finite")
    return counts


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
    train_reference_phase(torch, dev)
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
    # xlstm-1.3b: 42 mLSTM and 6 sLSTM blocks, f32, no kernel
    path(XLSTM, get_config(XLSTM), [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 0, "decode_attention": 0,
                       "rglru_scan": 0, "moe_gating": 0})
    # deepseek-v2 at full width, 2 layers of 60 (the dense first layer and
    # one MoE layer of 160 experts top-6 + 2 shared), f32 weights: MLA
    # attends at q/k 192, v 128
    dsv2 = get_config(DSV2)
    dsv2 = dataclasses.replace(dsv2, groups=(
        dataclasses.replace(dsv2.groups[0], count=1),
        dataclasses.replace(dsv2.groups[1], count=1)))
    path(DSV2, dsv2, [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 2 * p, "decode_attention": 2 * s,
                       "rglru_scan": 0, "moe_gating": p + s})
    # qwen2-vl-7b: 28 attention layers (M-RoPE, GQA 28/4), f32, text
    # prompts as the reference's engine serves
    path(QWEN2VL, get_config(QWEN2VL), [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 28 * p, "decode_attention": 28 * s,
                       "rglru_scan": 0, "moe_gating": 0})
    # musicgen-large: 48 attention layers (MHA, D 64), f32, prompts of
    # stub EnCodec ids
    path(MUSICGEN, get_config(MUSICGEN), [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 48 * p, "decode_attention": 48 * s,
                       "rglru_scan": 0, "moe_gating": 0})

    def trained(name, cfg, batch, seq, steps, per_step):
        counts = train_phase(torch, dev, cfg, batch=batch, seq=seq,
                             steps=steps)
        _check_counts(counts, {k: n * steps for k, n in per_step.items()})
        for k, n in counts.items():
            launches.setdefault(k, {})[f"{name} train"] = n

    # minicpm-2b: 40 attention layers, each forward once and recomputed
    # once (remat full), one backward
    trained(MINICPM, get_config(MINICPM), 4, 1024, 6,
            {"flash_attention": 80, "flash_attention_bwd": 40})
    # recurrentgemma-2b: 18 RG-LRU and 8 local-attention layers
    trained(RG, get_config(RG), 1, 3072, 4,
            {"rglru_scan": 36, "rglru_scan_bwd": 18, "flash_attention": 16,
             "flash_attention_bwd": 8})

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
