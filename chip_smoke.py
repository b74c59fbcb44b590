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
   GQA and musicgen's D 64; phase 9's twins: reduced phi3-mini's prefill
   and decode at D 16, the ≈100M train_lm's B 8 x S 128 at D 64), the
   flash forward at a q offset (chunked
   prefill: phi3's and deepseek-v2's heads, yardstick SDPA with
   ``causal_lower_right``) and at a device q offset (a chunk of the
   ladder prefill: phi3's heads, 256 rows at 256 over a 1024-row cache,
   bf16, bit-identical to the int offset over the sliced cache, the same
   yardstick on that view), with the scan's and the gating's launch
   shapes — every element within the tolerance of the
   plain version's f32 result (one bf16 rounding for a bf16 output; MoE
   gating's experts, slots and keep identical, gates within 1e-6), median
   time (CUDA events, L2 flushed before each launch), the plain version's
   time, ``torch.nn.functional.scaled_dot_product_attention``'s time on
   the same inputs for the attention kernels (a yardstick only: the port
   never calls it; where Dv != D, the first backend that takes it, named
   in the output; no single PyTorch call computes the scan or the
   routing) and the bound (an f32 flash product at 495/3 TFLOP/s: three
   TF32 products each, ``PEAK_FLOPS["tf32x3"]``); the f32 flash route's
   TF32 rounding against ``cvt.rna.tf32.f32`` over every f32 bit
   pattern, and the kernels SDPA runs at the f32 cases (profiler);
4. small-input reference: reduced phi3-mini, recurrentgemma, llama4,
   xLSTM (the reference's canary stack of one mLSTM and one sLSTM block,
   twice), deepseek-v2, qwen2-vl and musicgen served on the card and on
   the CPU (plain kernels) give the same greedy tokens, and on the card
   the decode step replayed from its CUDA graph gives the eager step's
   tokens and logits, and the prompt replayed as a ladder of graphed
   chunks (32 + 4 + 1: phi3, xLSTM, qwen2-vl, musicgen) or as one graphed
   pass padded to its 64-row bucket (recurrentgemma, past its 32-row
   ring; llama4; deepseek-v2) and the graphed steps give the CPU's tokens
   and logits; qwen2-vl's prefill of stub patch embeddings at distinct
   (t, h, w) positions gives the CPU's logits;
5. serve, seven paths, each through ``repro_torch.launch.serve.serve``
   and the Executor over ``cuda:0`` with random weights from seed 0, 4
   slots and 16 new tokens per request, every decode step replayed from
   its slot's CUDA graph, the launch counts zeroed before and read after
   each (a decode step counts the engine's one eager warm-up step and
   every replay, which adds the launches its graph holds).  phi3,
   xlstm-1.3b, qwen2-vl and musicgen prefill every request as a ladder of
   graphed chunks (``PrefillGraphs``, rungs 2-512; a chunk of one token
   is a replay of the slot's decode graph), and there "prefills" counts
   the chunks of two tokens or more and the ladder's eager warm-up
   chunks (one per rung), "decode steps" also the chunks of one;
   recurrentgemma-2b, llama4 and deepseek-v2 prefill every request as
   one graphed pass padded to a bucket (``BucketPrefillGraphs``, the
   powers of two from 16 to max_seq), and there "prefills" counts the
   requests and the eager warm-up passes (one per bucket):
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
   enqueue plus device).  phi3, deepseek-v2, qwen2-vl and xlstm-1.3b (at
   full width on its canary stack of 4 blocks) also prefill a 512-token
   prompt in two chunks, 200 + 312, and decode 8 greedy tokens, held
   against the one-shot prefill at f32 compute (LOGIT_ATOL, the same
   tokens) and printed at the served bf16; the second chunk's launches
   (flash = the attention layers, through the q offset) are a path of
   their own.  For all seven, on the served engine, the same call's A B
   B A of the eager one-shot prefill (A) against the graphed prefill (B):
   the engine's TTFT and ITL p50/p99, tokens/s and peak memory over the
   requests, the median prefill alone on one slot, the ladder's chunks
   per prompt (or the bucket) and the capture seconds, each graphed
   prefill's device time against its bytes bound (chunks, or one pass,
   × the weights a pass reads), and every graphed prefill bit-identical
   (logits and caches) to the eager chunks of its plan or the eager
   padded prefill of its bucket; then at f32 compute a 437-token
   prompt's ladder (256 + 128 + 32 + 16 + 4 + 1; phi3, qwen2-vl,
   musicgen, xLSTM on its canary stack) or bucket (512; deepseek-v2),
   and recurrentgemma's 3000 tokens in the bucket of 4096, and 8 graphed
   steps within LOGIT_ATOL of the one-shot prefill and its eager steps,
   the same greedy tokens (llama4 has no f32 check: an f32 copy of its
   experts is 64 GB).  Each path frees its weights before the next.

6. train, five paths, each through ``repro_torch.launch.train.train``
   (the reference launcher's graph: host(data) → pull(batch) →
   kernel(step) → host(metrics)) and the Executor over ``cuda:0``, random
   weights from seed 0, ``SyntheticSource`` batches, f32 master weights,
   bf16 compute, remat ``full``, the step a ``TrainStepGraph`` (eager
   at step 1, then one captured CUDA graph replayed: the reference's
   ``jax.jit``), the launch counts zeroed before and read after each
   (step 1 counts its launches, each replay adds its graph's):
   - minicpm-2b, full width and depth (40 layers, tied 122753 vocab),
     WSD, B 4 × S 1024, 6 steps; per step flash = 80 (40 forwards and
     40 recomputed ones), flash_bwd = 40;
   - recurrentgemma-2b, full width and depth (26 layers, untied 256000
     vocab), cosine, B 1 × S 3072 (the 2048 window masks), 4 steps; per
     step rglru_scan = 36, rglru_scan_bwd = 18, flash = 16, flash_bwd = 8;
   - deepseek-v2-236b at full width cut to its first (dense) layer, B 1
     × S 2048, 4 steps; per step flash = 2, flash_bwd = 1 (MLA at q/k
     192, v 128: the bf16 (3, 2) box pair);
   - xlstm-1.3b at full width cut to its first super-block (8 of 48
     blocks: at full depth its f32 gradients overflow at this init), B 1
     × S 512, 3 steps; no kernel;
   - qwen2-vl-7b at full width cut to 4 of 28 layers, B 1 × S 1024, 4
     steps; per step flash = 8, flash_bwd = 4.
   Losses and gradient norms are finite; printed: the cut, the median
   step time past the first (warm-up) step, tokens/s, MFU against 989
   TFLOP/s (model FLOPs 6·N·T over the matmul parameters plus the
   attention and mLSTM products, formula printed, recomputation not
   counted), peak memory and the capture's seconds.  Then, for each of
   the five, the same call's A B B A of the eager step against the
   graphed one, each run from one state (seed-0 params kept on the host,
   fresh AdamW state) over the same batches, remat full: median step
   past the first, tokens/s, MFU, ``max_memory_allocated`` and
   ``max_memory_reserved`` of each run, capture seconds; fails unless
   every run's losses, gradient norms and final params are bit-identical
   to the first eager run's.

7. distributed, held at world size 1: a one-rank NCCL group (in-memory
   store) and the 1x1 ``("data", "model")`` smoke mesh on the card, torn
   down at the end; phi3-mini-3.8b at full width and depth (bf16
   compute, seed-0 weights) as a pipeline of 4 stages of 8 blocks over
   4 microbatches of 1 x 512, scheduled by the Executor over three
   ``DeviceBin(cuda:0)`` stage slots and one live ``MeshBin`` (its pulls
   land as DTensors): each microbatch's logits against ``forward`` at
   the bf16 gate, the same greedy tokens, flash = 128, the wall time,
   the simulated makespan and ``pipeline_schedule_length``;
   ``flash_decode_update`` against the decode kernel at phi3's decode
   shape (cache 1024, at 517), bf16 and f32; ``_moe_shard_map`` against
   ``_moe_local`` on deepseek-v2's MoE layer (E 160, top-6, 2 shared,
   bf16) and 512 tokens, moe_gating = 1.

8. dry-run against the card: ``repro_torch.launch.dryrun`` traces
   phi3-mini-3.8b's decode step (batch 4, a full 1024-row cache, bf16
   weights) and minicpm-2b's train step (B 4 x S 1024, accum 1) on a 1x1
   fake mesh, and the same step functions run on the card: the FLOPs
   equal ``FlopCounterMode``'s count of the real step, the predicted
   peak is 0.95-1.15 of ``max_memory_allocated`` and the roofline bound
   at most 1.05 of the median step (decode_attention = 32, flash = 80
   and flash_bwd = 40 in the real steps); the measured train step is
   the eager one, and the same step replayed from a ``TrainStepGraph``
   is timed beside it against the same bound; the same three checks for
   xlstm-1.3b's prefill at full depth (48 blocks, B 1 x S 512) and its
   8-block train step (phase 6's cut, B 1 x S 512, accum 1), which the
   dry-run traces with each time loop as one op counting its steps
   (``models/loop_op.py``) while ``FlopCounterMode`` counts the real
   step's 512 sLSTM steps; the host time an eager decode kernel call
   takes through its custom op and through its launch function, in
   turns; and llama4-maverick x decode_32k and the three cells the port
   traced last (xlstm-1.3b x prefill_32k and x train_4k, qwen2-vl-7b x
   train_4k) traced on the fake 16x16 mesh by the dry-run's CLI, each in
   a process of its own started before the checks above, their record
   lines printed after them.

9. the paper's applications, through the example twins in
   ``examples_torch/`` (each one's ``main`` with its flags) on ``cuda``:
   (a) Listing 1's saxpy: y == 4 after the push; (b) 32 timing views
   (host extract → pull → 4 logistic-regression GD steps, 512 x 64 →
   push) at workers 1, 2, 4 and 8, every fitted model within rtol 1e-5,
   atol 1e-6 of the same builder run by the port on a CPU bin, views/s
   (three runs at each worker count, each checked, the median's rate);
   (c) the propagation DAG at 10⁵ cells (2·10⁵ pull and kernel tasks,
   fan-in up to 4) at workers 1, 4 and 8: every arrival bit-identical
   to :func:`longest_path`, the build and run seconds, cells/s, wall µs
   per task, the default simulation against the measurement; then one
   more run at 1 worker with ``--profile``, its trace fitted
   (``CostModel.fit``) and the same graph simulated under the fit
   against that run (where the host's time per task goes:
   ``repro_torch.launch.probe_executor``); (d) detailed placement, 8
   iterations x 256 cells, at workers 1, 2 and 4: the objectives within
   rtol 1e-6 of a CPU bin's, the MIS masks identical, iterations/s (as
   in (b), three runs); (e) the serve_lm twin (reduced phi3-mini,
   graphed decode and ladder prefill) with its defaults and with
   ``--bins 2 --scheduler balanced``: every request finishes, every
   prefill is replayed, flash = layers x the ladder's chunks of two
   tokens or more (and its warm-up chunks, one per rung), decode =
   layers x (decode steps and one-token chunks), tok/s, TTFT and ITL;
   (f) the train_lm twin
   with ``--full`` (≈100M parameters, 300 steps, B 8 x 128, remat none;
   its step a ``TrainStepGraph``) checkpointing every 50 steps to a
   temporary directory: the loss falls, the latest checkpoint is step
   300, flash = flash_bwd = 12 x 300, tok/s.

Each kernel's bound in phase 3 comes from its cost formula in the port
(``*_cost`` beside the wrapper, the custom op's FLOP and byte count).
Phase 3 also holds the forward's log-sum-exp output and the two
backward kernels (``flash_attention_bwd`` at the three train shapes in
bf16, on the tensor cores, and in f32 at a small shape, minicpm-2b's and
deepseek-v2's MLA at S 2048, with SDPA's backward as
the yardstick and its backend named, each pass's device time and the
launch shape, and the tensor-core kernels' registers and spills from
the build; ``rglru_scan_bwd`` at recurrentgemma's train shape in f32
and bf16) against their plain versions.  Phase 4 also trains reduced
minicpm-2b, recurrentgemma, llama4, deepseek-v2, xLSTM (canary stack)
and qwen2-vl (patch embeddings in the batch) (f32 compute) for 3 steps
on the card (through a ``TrainStepGraph``: eager step 1, capture, two
replays) and on the CPU from one state (per-step losses within 1e-4,
params within 1e-4 + 1e-5·|p|, the bounds of
``tests/test_torch_training.py``; xLSTM's steps each from the CPU's
state),
drives reduced phi3-mini's loss down by 0.5 in 12 steps on one repeated
batch, and round-trips a reduced train state through ``async_save`` and
``restore`` bit for bit.

The flash kernels' f32 route is counted apart (``F32_PATHS``): every
flash launch of the f32 paths (phase 4's reduced models served and
trained at f32, phase 5's f32 ladders, buckets and chunked prefills)
must go through it, and its rows in the kernels line
(``flash_attention_f32``, ``flash_attention_bwd_f32``) count those.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA device
or without the repository's ``src/repro_torch`` and ``examples_torch``
beside this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s.
#: An f32 attention kernel (flash forward and backward) takes each product
#: as three TF32 products on the tensor cores, so the least time f32-accurate
#: work can take there is three times the work at 495 TFLOP/s (TF32):
#: "tf32x3".  The other f32 kernels are bound by bytes and keep the CUDA
#: cores' 67.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
#: each kernel is held against its plain version on f32 copies of the same
#: inputs, element by element: |out - ref| <= 2e-5 + rtol·|ref|.  2e-5 is
#: the f32 sums taken in another order (as the JAX package's kernel
#: sweeps); a bf16 output adds one rounding to nearest, at most 2^-8 of
#: the value, so rtol is 2e-5 for an f32 output and 2^-8 for a bf16 one
ATOL = 2e-5
RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}
#: two runs of one model at f32 compute that should give the same logits
#: (the card against the CPU; a prompt prefilled in chunks against the
#: whole prompt) differ by at most this much
LOGIT_ATOL = 1e-3
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


def _attention_peak(dt: str) -> str:
    """The ``PEAK_FLOPS`` key of a flash kernel's products in ``dt``."""
    return "tf32x3" if dt == "float32" else dt


def _bounds(flops: float, nbytes: float, dt: str) -> tuple[float, str]:
    """The least time for the work, in ms, and what bounds it: ``flops``
    and ``nbytes`` as a kernel's cost formula gives them (its ops.py
    ``*_cost``, the custom op's count for ``FlopCounterMode`` and the
    dry-run), ``dt`` a key of ``PEAK_FLOPS``."""
    bounds = {"operations": flops / PEAK_FLOPS[dt] * 1e3,
              "bytes": nbytes / HBM_BYTES_S * 1e3}
    bound_by = max(bounds, key=bounds.get)
    return bounds[bound_by], bound_by


def kernel_phase(torch, dev, logs: dict) -> dict:
    """Every kernel case of phase 3; returns the case chosen for each
    kernel's entry of the ``{"kernels": ...}`` line.  ``logs``: the
    build's compiler output per source."""
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    print("kernel cases (name, shape, dtype, max_abs_err, atol, rtol, ms, "
          "plain_ms, library_ms, bound_ms, bound_by):")
    _zero_counts()
    chosen = {}
    chosen.update(_flash_cases(torch, dev, randn, flush))
    _flash_offset_cases(torch, dev, randn, flush)
    _flash_device_offset_case(torch, dev, randn, flush)
    chosen.update(_decode_cases(torch, dev, randn, flush))
    chosen.update(_rglru_cases(torch, dev, randn, flush))
    chosen.update(_gating_cases(torch, dev, randn, flush))
    chosen.update(_flash_bwd_cases(torch, dev, randn, flush,
                                   logs.get("flash_attention_bwd")))
    chosen.update(_rglru_bwd_cases(torch, dev, randn, flush))
    print(f"phase 3's launches of the flash kernels' f32 route (checks and "
          f"timing, not a path): {_read_f32_counts()}")
    return chosen


def _flash_cases(torch, dev, randn, flush) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost

    chosen = {}
    print(f"  the f32 route's TF32 rounding against cvt.rna.tf32.f32 over "
          f"all 2^32 f32 bit patterns: {_tf32_mismatches(torch, dev)} "
          f"finite ones apart")
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
            (1, 32, 32, 512, 64, 64, None, "bfloat16"),
            # phase 9: the serve_lm twin's prefills (reduced phi3-mini: H =
            # K = 4, D 16, prompts of 4-10 tokens) and the train_lm twin's
            # forward (768 x 12: B 8, H = K = 12, S 128, D 64)
            (1, 4, 4, 4, 16, 16, None, "bfloat16"),
            (1, 4, 4, 10, 16, 16, None, "bfloat16"),
            (8, 12, 12, 128, 64, 64, None, "bfloat16")]:
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
        bound, bound_by = _bounds(*flash_attention_cost(q, k, v, win or 0),
                                  _attention_peak(dt))
        row = {"name": "flash_attention" + ("_f32" if dt == "float32"
                                            else ""), "route": "cuda",
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
        if (S, K, D) == (512, 32, 96) and dt in ("bfloat16", "float32"):
            chosen[row["name"]] = row
            if dt == "float32":
                print(f"  SDPA's kernels at this f32 case (profiler): "
                      f"{_kernel_names(torch, sdpa)}")
    return chosen


def _tf32_mismatches(torch, dev) -> int:
    """The finite f32 values the flash kernels' f32 route rounds to TF32
    otherwise than ``cvt.rna.tf32.f32`` (``csrc/flash_attention.cu``
    ``flash_attention_tf32_mismatches``); raises unless none."""
    import ctypes

    from repro_torch.kernels._build import function

    fn = function("flash_attention", "flash_attention_tf32_mismatches",
                  [ctypes.c_void_p, ctypes.c_void_p])
    n = torch.zeros(1, dtype=torch.int64, device=dev)
    if fn(n.data_ptr(), torch.cuda.current_stream(dev).cuda_stream):
        raise RuntimeError("the TF32 rounding check did not launch")
    torch.cuda.synchronize(dev)
    if int(n):
        raise AssertionError(f"the f32 route rounds {int(n)} finite values "
                             f"otherwise than cvt.rna.tf32.f32")
    return int(n)


def _kernel_names(torch, fn) -> list:
    """The CUDA kernels one call of ``fn`` runs, by name, from a
    ``torch.profiler`` trace (which kernel SDPA picks for f32)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type.name == "CUDA" and "memset" not in
                   e.name.lower() and "memcpy" not in e.name.lower()})


def _flash_offset_cases(torch, dev, randn, flush) -> None:
    """The forward at a q offset (chunked prefill: query row i at key
    position q_offset + i, against the first q_offset + Sq rows of a
    1024-row cache, read in place through its strides): phi3's second
    chunk of a 200 + 312 prompt and a 512-token prompt after 512 cached
    tokens, deepseek-v2's MLA heads at the latter, and phi3's f32.
    Yardstick: SDPA with ``causal_lower_right(Sq, Sk)``, the same mask at
    q_offset = Sk - Sq (where Dv != D, the first backend that takes it)."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost

    for B, H, K, Sq, off, D, Dv, dt in [
            (1, 32, 32, 312, 200, 96, 96, "bfloat16"),
            (1, 32, 32, 512, 512, 96, 96, "bfloat16"),
            (1, 128, 128, 512, 512, 192, 128, "bfloat16"),
            (1, 32, 32, 312, 200, 96, 96, "float32")]:
        dtype = getattr(torch, dt)
        Sk = off + Sq
        q = randn((B, Sq, H, D), dtype)
        k = randn((B, 1024, K, D), dtype)[:, :Sk]       # cache views
        v = randn((B, 1024, K, Dv), dtype)[:, :Sk]
        scale = D ** -0.5
        out = flash_attention(q, k, v, scale=scale, q_offset=off)
        ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                    scale=scale, q_offset=off)
        err = _check(torch, "flash_attention at a q offset", out, ref, dt)
        del ref
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bias = causal_lower_right(Sq, Sk)
        lib, backend = _sdpa_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias, scale=scale),
            flush, pinned=Dv != D)
        bound, bound_by = _bounds(
            *flash_attention_cost(q, k, v, q_offset=off), _attention_peak(dt))
        ms = _median_ms(torch, lambda: flash_attention(
            q, k, v, scale=scale, q_offset=off), flush)
        plain = _median_ms(torch, lambda: flash_attention_plain(
            q, k, v, scale=scale, q_offset=off), flush)
        print(f"  flash_attention q_offset={off} B={B} H={H} K={K} Sq={Sq} "
              f"Sk={Sk} D={D} Dv={Dv} {dt}: {err} {ATOL} {RTOL[dt]} {ms} "
              f"{plain} {lib} (SDPA causal_lower_right, {backend}) {bound} "
              f"{bound_by}")


def _flash_device_offset_case(torch, dev, randn, flush) -> None:
    """The forward at a device q offset (a chunk of the ladder prefill:
    the offset read from a (1,) int64 on the card, k and v the cache's
    whole rows, zero past the chunk as after a reset): phi3's heads, a
    rung of 256 at offset 256 over a 1024-row cache, bf16, against the
    plain version at the same device offset and bit for bit against the
    kernel at the int offset over the cache's first 512 rows.  Bound:
    the cost formula over the keys the chunk sees (the first 512 rows);
    yardstick: SDPA with ``causal_lower_right`` on that sliced view."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost

    H = K = 32
    D, Sq, off, rows, dt = 96, 256, 256, 1024, "bfloat16"
    dtype, Sk = getattr(torch, dt), off + Sq
    q = randn((1, Sq, H, D), dtype)
    kc = torch.zeros((1, rows, K, D), dtype=dtype, device=dev)
    vc = torch.zeros((1, rows, K, D), dtype=dtype, device=dev)
    kc[:, :Sk] = randn((1, Sk, K, D), dtype)
    vc[:, :Sk] = randn((1, Sk, K, D), dtype)
    at = torch.full((1,), off, dtype=torch.long, device=dev)
    scale = D ** -0.5
    out = flash_attention(q, kc, vc, scale=scale, q_offset=at)
    ref = flash_attention_plain(q.float(), kc.float(), vc.float(),
                                scale=scale, q_offset=at)
    err = _check(torch, "flash_attention at a device q offset", out, ref, dt)
    del ref
    k, v = kc[:, :Sk], vc[:, :Sk]
    if not torch.equal(out, flash_attention(q, k, v, scale=scale,
                                            q_offset=off)):
        raise AssertionError("flash_attention at a device q offset differs "
                             "from the int offset over the sliced cache")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bias = causal_lower_right(Sq, Sk)
    lib = _median_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bias, scale=scale), flush)
    bound, bound_by = _bounds(*flash_attention_cost(q, k, v, q_offset=off),
                              dt)
    ms = _median_ms(torch, lambda: flash_attention(
        q, kc, vc, scale=scale, q_offset=at), flush)
    plain = _median_ms(torch, lambda: flash_attention_plain(
        q, kc, vc, scale=scale, q_offset=at), flush)
    print(f"  flash_attention device q_offset={off} B=1 H={H} K={K} Sq={Sq} "
          f"cache={rows} D={D} {dt}: {err} {ATOL} {RTOL[dt]} {ms} {plain} "
          f"{lib} (SDPA causal_lower_right on the first {Sk} rows) {bound} "
          f"{bound_by}; bit-identical to the int offset over them")


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
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_cost

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
            (1, 32, 32, 1024, 64, 64, [517], "bfloat16"),
            # phase 9: the serve_lm twin's decode (reduced phi3-mini: H = K
            # = 4, D 16, a slot's 128-row cache, up to 22 tokens), and four
            # such rows in one batch
            (1, 4, 4, 128, 16, 16, [5], "bfloat16"),
            (1, 4, 4, 128, 16, 16, [22], "bfloat16"),
            (4, 4, 4, 128, 16, 16, [128, 22, 5, 1], "bfloat16")]:
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
        # the kernel reads each sequence's valid rows only
        rows = sum(min(n, S) for n in lens)
        bound, bound_by = _bounds(
            *decode_attention_cost(q, k, v, vl, rows=rows), dt)
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
    from repro_torch.kernels.rglru_scan.ops import (rglru_scan_cost,
                                                    scan_launch_shape)

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
        bound, bound_by = _bounds(*rglru_scan_cost(x, a, h0), "float32")
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
                                                    max_cluster_blocks,
                                                    moe_gating_cost)

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
        bound, bound_by = _bounds(*moe_gating_cost(logits, k), "float32")
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


def _flash_bwd_cases(torch, dev, randn, flush, log) -> dict:
    """The forward's log-sum-exp output and the flash backward at the
    train paths' shapes (minicpm-2b: B 4, S 1024, H = K = 36, D 64;
    recurrentgemma-2b: B 1, S 3072, H 10, K 1, D 256, window 2048;
    deepseek-v2's MLA: B 1, S 2048, H = K = 128, D 192, Dv 128; phase
    9's train_lm twin: B 8, S 128, H = K = 12, D 64; bf16) and a small
    f32 case, against the plain versions on f32 copies of
    the same inputs.  Yardstick: SDPA's backward on the same q, k, v and
    dout (kv heads repeated to H), the backend named.  The bound counts
    the five products a flash backward needs (S again and dK, dQ over D;
    dP and dV over Dv: 2.5x the forward's at Dv = D), not the kernels'
    recomputations and bf16 hi/lo splits.  A line of its own per case
    gives the launch shape and each pass's device time (profiler); one
    more, the tensor-core kernels' registers and spills from the build's
    ``-Xptxas -v`` (``log``)."""
    from repro_torch.kernels import (flash_attention, flash_attention_bwd,
                                     flash_attention_bwd_plain,
                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import (
        bwd_launch_shape, flash_attention_bwd_cost)
    from repro_torch.launch.probe_flash_bwd import pass_ms

    print(f"  flash_attention_bwd tensor-core kernels (ptxas): "
          f"{_ptxas_report(log, ('dkdv_tc_kernel', 'dq_tc_kernel'))}")
    chosen = {}
    for name, B, H, K, S, D, Dv, win, dt in [
            ("minicpm-2b", 4, 36, 36, 1024, 64, 64, None, "bfloat16"),
            ("recurrentgemma-2b", 1, 10, 1, 3072, 256, 256, 2048,
             "bfloat16"),
            ("deepseek-v2", 1, 128, 128, 2048, 192, 128, None, "bfloat16"),
            ("train_lm twin --full", 8, 12, 12, 128, 64, 64, None,
             "bfloat16"),
            ("small", 1, 8, 2, 512, 64, 64, None, "float32"),
            ("minicpm-2b", 4, 36, 36, 1024, 64, 64, None, "float32"),
            ("deepseek-v2", 1, 128, 128, 2048, 192, 128, None, "float32")]:
        dtype = getattr(torch, dt)
        q, k = (randn((B, S, n, D), dtype) for n in (H, K))
        v = randn((B, S, K, Dv), dtype)
        dout = randn((B, S, H, Dv), dtype)
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
        lib, backend, sdpa_bwd = _sdpa_bwd_ms(torch, q, k, v, dout, win,
                                              scale, flush)
        bound, bound_by = _bounds(*flash_attention_bwd_cost(
            q, k, v, out, dout, lse, win or 0), _attention_peak(dt))
        row = {"name": "flash_attention_bwd" + ("_f32" if dt == "float32"
                                                else ""), "route": "cuda",
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
              f"Dv={Dv} window={win} {dt}: lse err {lse_err}; {err} {ATOL} "
              f"{RTOL[dt]} {row['ms']} {row['plain_ms']} {lib} (SDPA "
              f"backward, {backend}) {bound} {bound_by}")
        passes = pass_ms(lambda: flash_attention_bwd(
            q, k, v, out, dout, lse, window=win, scale=scale))
        print(f"  flash_attention_bwd {name} passes (device ms a call): "
              f"{passes}; {bwd_launch_shape(D, Dv, dtype)}")
        if name == "minicpm-2b":
            chosen[row["name"]] = row
        if (name, dt) == ("small", "float32"):
            print(f"  SDPA's backward kernels at this f32 case (profiler): "
                  f"{_kernel_names(torch, sdpa_bwd)}")
        del sdpa_bwd
    return chosen


def _ptxas_report(log, kernels) -> str:
    """Registers and spills of each function in ``-Xptxas -v`` output
    whose mangled name holds one of ``kernels``, by name and template
    arguments."""
    if not log:
        return "not compiled in this run"
    found, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = next((k for k in kernels if k in m.group(1)), None)
            args = re.search(r"I(L[^E]*E(?:L[^E]*E)*)E", m.group(1))
            name = None if k is None else k + (
                "<" + ",".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
                if args else "")
        elif name and "spill stores" in line:
            found.append(f"{name}: {line.strip()}")
        elif name and "registers" in line:
            found[-1] += f"; {line.split(':', 1)[1].strip()}"
            name = None
    return " | ".join(found) or "no such function in the log"


def _sdpa_bwd_ms(torch, q, k, v, dout, win, scale, flush):
    """SDPA's backward on (B, H, S, D) copies of the inputs (kv heads
    repeated to H), timed alone from a retained graph, the first of
    ``SDPA_BACKENDS`` that takes the case (a window needs a mask), and a
    call that runs that backward once."""
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
            def once():
                return torch.autograd.grad(out, (qt, kt, vt), dt,
                                           retain_graph=True)
            return _median_ms(torch, once, flush), name, once
    raise AssertionError("no SDPA backend takes the backward case")


def _rglru_bwd_cases(torch, dev, randn, flush) -> dict:
    """The scan's backward at recurrentgemma's train shape (B 1, S 3072,
    d_rnn 2560) in f32 (bit for bit with the plain version, whose steps
    round as the kernel's) and bf16, with the launch shape the wrapper
    picks.  No single PyTorch call computes it: library_ms is null."""
    from repro_torch.kernels import rglru_scan_bwd, rglru_scan_bwd_plain
    from repro_torch.kernels.rglru_scan.ops import (rglru_scan_bwd_cost,
                                                    scan_launch_shape)

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
        bound, bound_by = _bounds(*rglru_scan_bwd_cost(dy, a, h, h0),
                                  "float32")
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
    tokens and logits bit for bit, and the prompt replayed from its
    ``PrefillGraphs`` where the family takes the ladder, else from its
    ``BucketPrefillGraphs`` (37 tokens in the 64-row bucket, past the
    reduced 32-row ring), and the graphed steps give the CPU's tokens,
    logits within LOGIT_ATOL.  qwen2-vl also
    prefills stub patch embeddings at distinct (t, h, w) positions, card
    against CPU."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import LayerGroup
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill, reset_cache)
    from repro_torch.models.transformer import takes_ladder
    from repro_torch.serving.graphs import (BucketPrefillGraphs, DecodeGraphs,
                                            PrefillGraphs)

    cpu = torch.device("cpu")
    canary = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)
    _zero_counts()
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
        if ct != gt or err > LOGIT_ATOL:
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
        # the prompt as the engine serves it on the card: a ladder of
        # graphed chunks (37 = 32 + 4 + 1 on 64 rows), or one graphed
        # pass padded to its bucket (64)
        if takes_ladder(cfg):
            pre = PrefillGraphs(cfg, p, [caches], graphs, 64, dev)
            how = f"ladder prefill {pre.plan(len(prompt))}"
        else:
            pre = BucketPrefillGraphs(cfg, p, [caches], graphs, 64, dev)
            how = f"bucket prefill in {pre.bucket(len(prompt))} rows"
        reset_cache(cfg, caches)
        logits = pre.prefill(0, prompt)
        toks, all_logits = [int(logits[0].argmax())], [logits.cpu()]
        for n in range(8):
            logits = graphs.step(0, toks[-1], len(prompt) + n)
            toks.append(int(logits[0].argmax()))
            all_logits.append(logits.cpu())
        err = float((torch.cat(all_logits) - cl).abs().max())
        print(f"  {how} on the card, graphed: tokens {toks}; max logit diff "
              f"to the cpu's one-shot prefill and steps {err}")
        if toks != ct or err > LOGIT_ATOL:
            raise AssertionError(f"{arch}: the card's graphed prefill "
                                 f"differs from the CPU's prefill")
        if arch == QWEN2VL:
            _patch_prefill(torch, cfg, params, prompt, dev)
    _record_f32("reduced models served at f32 (phase 4)", True)


#: training on the card against the CPU (phase 4): per-step losses and
#: the params after 3 steps at lr 1e-3, the bounds of
#: tests/test_torch_training.py (MODEL_TOL's rtol, STEP_TOL)
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL, TRAIN_PARAM_RTOL = 1e-4, 1e-4, 1e-5
#: a gradient leaf, card against CPU at one state: within this fraction of
#: the leaf's largest element plus TRAIN_LOSS_RTOL·|g| (the bound of
#: tests/test_torch_training.py's GRAD_ATOL and MODEL_TOL)
TRAIN_GRAD_ATOL = 1e-4


def train_reference_phase(torch, dev) -> None:
    """Reduced minicpm-2b, recurrentgemma, llama4, deepseek-v2 (MLA),
    xLSTM (its canary stack) and qwen2-vl (stub patch embeddings in every
    batch) (f32 compute, remat full) trained 3 steps from one state on the
    CPU (plain kernels) and on the card (forward and backward kernels, the
    gating kernel with the recomputed gates; a TrainStepGraph: eager step
    1, capture, two replays): the same losses and params.  xLSTM's card
    steps start each from the CPU's state, copied into the tensors the
    graph reads: its exponential
    gates turn a weight difference Adam's first step makes into more than
    the bound within three steps.  So each of its steps holds the loss,
    every gradient leaf at that state (TRAIN_GRAD_ATOL) and, past the
    first step, the params: Adam's first step is ±lr·g/(|g| + eps), and a
    gradient element whose sum cancels to about eps takes another size
    or sign from f32 sums in another order (on an H100 80GB HBM3 at 700
    W: 1.5e-4 after it, 2.6e-6 and 3.4e-7 after the next two; PERF.md
    §6).  Reduced
    phi3-mini
    (bf16 compute, graphed) memorises one batch: loss down by 0.5 in 12
    steps.  A
    reduced train state on the card survives async_save and restore bit
    for bit."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import LayerGroup
    from repro_torch.core import Executor
    from repro_torch.data import SyntheticSource
    from repro_torch.models.frontends import make_patch_embeds
    from repro_torch.training import (AdamWConfig, TrainStepGraph,
                                      checkpoint, init_train_state,
                                      make_train_step, wsd_schedule)
    from repro_torch.training.optimizer import leaves

    cpu = torch.device("cpu")
    opt = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    canary = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)

    def batch_of(cfg, i):
        b = SyntheticSource(cfg.vocab_size, seed=i).batch(0, 4, 16)
        b = {k: torch.from_numpy(x) for k, x in b.items()}
        if cfg.frontend == "vision_stub":
            b["extra_embeds"] = make_patch_embeds(
                torch.Generator().manual_seed(i), 4, cfg.n_visual_tokens,
                cfg.d_model, dtype=torch.float32)
        return b

    def grad_excess(cfg, params, batch) -> float:
        """The gradients of the loss at ``params`` (a CPU and a card copy
        of one state) against each other: the largest excess over the
        bound, per leaf, across leaves."""
        from repro_torch.models import loss_fn

        grads = []
        for ps, d in zip(params, (cpu, dev)):
            with torch.no_grad():
                tree = _clone(torch, ps)
            for t in leaves(tree):
                t.requires_grad_(True)
            loss, _ = loss_fn(cfg, tree, _to(torch, batch, d),
                              remat_policy="full")
            loss.backward()
            grads.append([t.grad.cpu() for t in leaves(tree)])
        return max(float(((g - c).abs() - TRAIN_GRAD_ATOL * c.abs().max()
                          - TRAIN_LOSS_RTOL * c.abs()).max())
                   for g, c in zip(*grads))

    def excess_and_diff(gp, cp):
        pairs = list(zip(leaves(gp), leaves(cp)))
        return (max(float(((x - y).abs() - TRAIN_PARAM_ATOL
                           - TRAIN_PARAM_RTOL * y.abs()).max())
                    for x, y in pairs),
                max(float((x - y).abs().max()) for x, y in pairs))

    _zero_counts()
    for arch in (MINICPM, RG, LLAMA4, DSV2, XLSTM, QWEN2VL):
        kw = {"groups": canary} if arch == XLSTM else {}
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32", **kw)
        state0 = init_train_state(cfg, torch.Generator().manual_seed(0), cpu)
        devs = (cpu, dev)
        states = [_to(torch, _clone(torch, state0), d) for d in devs]
        steps = [make_train_step(cfg, opt, remat_policy="full") for _ in devs]
        steps[1] = TrainStepGraph(steps[1], states[1])
        (cl, gl), excess, diff, gexcess = ([], []), [], [], []
        for i in range(3):
            batch = batch_of(cfg, i)
            if arch == XLSTM:
                if i:                            # from the CPU's state
                    with torch.no_grad():
                        for x, y in zip(leaves(states[1]),
                                        leaves(states[0])):
                            x.copy_(y)
                gexcess.append(grad_excess(cfg, [s["params"] for s in states],
                                           batch))
            for j, d in enumerate(devs):
                states[j], m = steps[j](states[j], _to(torch, batch, d))
                (cl, gl)[j].append(float(m["total_loss"]))
            if arch == XLSTM or i == 2:
                with torch.no_grad():
                    e, df = excess_and_diff(
                        _to(torch, states[1]["params"], cpu),
                        states[0]["params"])
                excess.append(e)
                diff.append(df)
        if arch == XLSTM:               # Adam's first step: printed only
            excess = excess[1:]
        loss_ok = all(abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
                      for a, b in zip(gl, cl))
        held = ""
        if arch == XLSTM:
            held = (f" (each from the CPU state; gradient excess over "
                    f"{TRAIN_GRAD_ATOL}·max|g| + {TRAIN_LOSS_RTOL}·|g| per "
                    f"step {gexcess}; params held after steps 2-3)")
        print(f"reduced {arch} f32 train, 3 steps{held}: cpu losses {cl} "
              f"cuda {gl} (graphed: capture {steps[1].capture_seconds} s, "
              f"{steps[1].replays} replays); max param diff {diff} (tol "
              f"{TRAIN_PARAM_ATOL} + {TRAIN_PARAM_RTOL}·|p|)")
        if steps[1].replays != 2:
            raise AssertionError(f"{arch}: the card's steps 2-3 were not "
                                 f"replays")
        if not loss_ok or max(excess) > 0 or max(gexcess, default=0) > 0:
            raise AssertionError(f"{arch}: training on the card differs "
                                 f"from the CPU")
    _record_f32("reduced models trained at f32 (phase 4)", True, True)

    cfg = reduced(get_config(PHI3))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    step = TrainStepGraph(make_train_step(cfg, AdamWConfig(
        schedule=wsd_schedule(3e-4, 5, 50, 10), weight_decay=0.0),
        remat_policy="none"), state)
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
    if tok[0] != tok[1] or err > LOGIT_ATOL:
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


def serve_phase(torch, dev, cfg, lengths, max_seq, *, long_prompt=None,
                chunked: bool = False,
                ladder_f32: int = 0) -> tuple[dict, int, int, dict]:
    """Serve ``cfg`` (full width, random weights from seed 0) through
    ``serve()`` and the Executor over ``dev``: prompts of ``lengths``
    tokens (the sixth gets the first one's prompt; for the audio stub,
    codebook ids from ``make_audio_tokens``), 16 new tokens each, 4
    slots.  Every request completes, the repeated prompt gets the same
    tokens, every decode step is a graph replay, and a direct prefill (of
    request ``long_prompt``, default the second) and decode step give
    finite logits of the vocabulary's width, the prefill's token the
    engine's.  ``chunked``: then :func:`chunked_prefill_phase` on the same
    weights.  Every request prefills from the engine's graphs: a family
    the ladder serves (``transformer.takes_ladder``) from its
    ``PrefillGraphs``, the others from their ``BucketPrefillGraphs``;
    then :func:`ladder_ab` on the same engine, and with ``ladder_f32`` (a
    prompt length) :func:`ladder_f32_phase` on the same weights.  Returns
    the kernels' launch counts of the serving run, its prefill passes
    (each launches
    the flash kernel once per attention layer, the scan once per RG-LRU
    layer and the gating once per MoE layer: the ladder's chunks of two
    tokens or more and its eager warm-up chunks, one per rung; or the
    requests' buckets and the eager warm-up passes, one per bucket), its
    decode steps (the replays, the engine's warm-up step and the ladder's
    one-token chunks) and the chunked prefill's second chunk's counts (or
    None)."""
    import numpy as np

    from repro_torch.launch.serve import graph_report, serve
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill, reset_cache)
    from repro_torch.models.frontends import make_audio_tokens
    from repro_torch.serving.graphs import BucketPrefillGraphs, DecodeGraphs

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

    _zero_counts()
    eng, done, seconds = serve(cfg, params, prompts, device=dev, slots=4,
                               max_seq=max_seq, max_new=max_new)
    counts = _read_counts()

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
    print(graph_report(eng))
    ladder = eng.prefill_graphs
    if ladder.prefills != len(done):
        raise AssertionError(f"{ladder.prefills} graphed prefills for "
                             f"{len(done)} requests")
    if isinstance(ladder, BucketPrefillGraphs):
        print(f"prefill buckets: {[ladder.bucket(len(q)) for q in prompts]} "
              f"for prompts of {[len(q) for q in prompts]} tokens; launches "
              f"per replay {ladder.slots[0][ladder.sizes[-1]].launches} "
              f"(every bucket)")
        flash_passes, ones = ladder.prefills + ladder.warmups, 0
    else:
        print(f"prefill ladder: chunks per prompt "
              f"{[len(ladder.plan(len(q))) for q in prompts]} "
              f"({[ladder.plan(len(q)) for q in prompts]}); launches per "
              f"replay {ladder.slots[0][ladder.top].launches} (every rung)")
        flash_passes = ladder.replays + ladder.warmup_chunks
        ones = ladder.decode_chunks
    ladder_ab(torch, dev, eng, prompts, max_new)

    p = eng.params
    del eng, graphs, ladder
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
    chunk = None
    del graphs, caches, eager
    gc.collect()
    if chunked:
        chunk = chunked_prefill_phase(torch, dev, cfg, params, p, max_seq)
    if ladder_f32:
        ladder_f32_phase(torch, dev, cfg, params, max_seq, ladder_f32)
    return (counts, flash_passes, steps + DecodeGraphs.warmup_steps + ones,
            chunk)


def _nearest_rank(xs, pct: float) -> float:
    """The engine's percentile rule (``obs`` histograms): nearest rank."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(len(xs) * pct / 100) - 1)]


def ladder_ab(torch, dev, eng, prompts, max_new: int) -> None:
    """The graphed prefill (a ladder of chunks, or one pass padded to a
    bucket) against the eager one-shot prefill, in the same call, A B B A
    (A eager, B graphed), on the engine just served:

    - the engine itself under a fresh Executor, its ``prefill_graphs``
      set aside for A: the requests of ``prompts`` with ``max_new``
      tokens each per run; TTFT p50/p99 (nearest rank over both runs of
      a mode, from each request's arrival and first token), ITL p50/p99
      (the engine's ``itl_s`` samples of both runs), tokens/s,
      ``max_memory_allocated``; greedy tokens equal between the two runs
      of a mode;
    - the prefill alone on slot 0 (reset before each): the wall of each
      prompt's prefill, ended by a synchronise, the median over both runs
      of a mode;
    - the graphed prefill's device time per prompt (CUDA events, the
      chunks enqueued behind a device sleep), against its bytes bound:
      passes (the ladder's chunks, or 1) × the weights one pass reads at
      the compute dtype / 3.35 TB/s;
    - the graphed logits and every cache bit-identical to the eager
      chunks of the same plan (``eager_ladder``), or the eager padded
      prefill of the same bucket (``eager_bucket``), on fresh caches."""
    from repro_torch.core import Executor
    from repro_torch.models import init_cache, prefill, reset_cache
    from repro_torch.serving.graphs import (BucketPrefillGraphs, eager_bucket,
                                            eager_ladder)

    cfg, p, ladder = eng.cfg, eng.params, eng.prefill_graphs
    bucketed = isinstance(ladder, BucketPrefillGraphs)
    kind = "bucket" if bucketed else "ladder"
    caches = eng._caches[0]
    tokens = [torch.as_tensor(q[None], dtype=torch.long, device=dev)
              for q in prompts]
    served = {"eager": [], "graphed": []}
    alone = {"eager": [], "graphed": []}
    itl = eng.metrics.histogram("itl_s")
    order = ("eager", "graphed", "graphed", "eager")
    with Executor(num_workers=2, devices=[dev]) as ex:
        eng.executor = ex
        for mode in order:
            eng.prefill_graphs = ladder if mode == "graphed" else None
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            n0, i0 = len(eng.completed), len(itl.samples)
            t0 = time.perf_counter()
            for q in prompts:
                eng.submit(q, max_new_tokens=max_new)
            done = eng.run()[n0:]
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            served[mode].append({
                "wall": wall, "tokens": sum(len(r.generated) for r in done),
                "ttft": [r.first_token_s - r.arrival_s for r in done],
                "itl": itl.samples[i0:],
                "gen": [r.generated for r in sorted(done,
                                                    key=lambda r: r.id)],
                "peak": torch.cuda.max_memory_allocated(dev)})
    eng.executor = None
    eng.prefill_graphs = ladder
    for mode in order:
        torch.cuda.reset_peak_memory_stats(dev)
        run = []
        for t in tokens:
            reset_cache(cfg, caches)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if mode == "graphed":
                ladder.prefill(0, t)
            else:
                prefill(cfg, p, t, caches)
            torch.cuda.synchronize(dev)
            run.append(time.perf_counter() - t0)
        alone[mode].append((run, torch.cuda.max_memory_allocated(dev)))
    for mode in ("eager", "graphed"):
        a, b = served[mode]
        if a["gen"] != b["gen"]:
            raise AssertionError(f"{cfg.arch_id}: two {mode} runs of the "
                                 f"same requests gave other tokens")
        ttft, gaps = a["ttft"] + b["ttft"], a["itl"] + b["itl"]
        walls = [x for run, _ in alone[mode] for x in run]
        print(f"{kind} A B B A {cfg.arch_id}, {mode} prefill: TTFT p50 "
              f"{_nearest_rank(ttft, 50)} p99 {_nearest_rank(ttft, 99)} s; "
              f"ITL p50 {_nearest_rank(gaps, 50)} p99 "
              f"{_nearest_rank(gaps, 99)} s; "
              f"tokens/s {[r['tokens'] / r['wall'] for r in served[mode]]}; "
              f"peak GB served {[r['peak'] / 1e9 for r in served[mode]]}, "
              f"prefill alone {[pk / 1e9 for _, pk in alone[mode]]}; "
              f"prefill alone median {statistics.median(walls)} s (per "
              f"prompt, runs {[run for run, _ in alone[mode]]})")
    same = served["eager"][0]["gen"] == served["graphed"][0]["gen"]
    print(f"  greedy tokens of the eager and the graphed runs equal: {same} "
          f"({cfg.compute_dtype}: the {kind} sums in another order than "
          f"the one-shot prefill); capture {ladder.capture_seconds} s")

    weights = _tree_bytes(p["groups"]) + _tree_bytes(
        p.get("lm_head", p["embed"]))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for q, t in zip(prompts, tokens):
        chunks = [ladder.bucket(len(q))] if bucketed else ladder.plan(len(q))
        reset_cache(cfg, caches)
        flush.zero_()
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(50_000_000)         # ~25 ms: the chunks queue
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        ladder.prefill(0, t)
        e.record()
        torch.cuda.synchronize(dev)
        bound = len(chunks) * weights / HBM_BYTES_S * 1e3
        print(f"  graphed prefill of {len(q)} tokens, "
              f"{'bucket' if bucketed else 'chunks'} {chunks}: device "
              f"{s.elapsed_time(e)} ms, bytes bound {bound} ms "
              f"({len(chunks)} x {weights} B of weights)")
    for q, t in zip(prompts, tokens):
        reset_cache(cfg, caches)
        got = ladder.prefill(0, t).clone()
        fresh = init_cache(cfg, 1, ladder.max_seq, device=dev)
        if bucketed:
            want, fresh = eager_bucket(cfg, p, t, fresh,
                                       ladder.bucket(len(q)))
        else:
            want, fresh = eager_ladder(cfg, p, t, fresh, ladder.top)
        same = torch.equal(got, want) and all(
            torch.equal(a, b) for a, b in zip(_leaves(caches),
                                               _leaves(fresh), strict=True))
        if not same:
            raise AssertionError(f"{cfg.arch_id}: the graphed {kind} "
                                 f"prefill of {len(q)} tokens differs from "
                                 f"its eager twin")
    twin = ("padded prefill of the same bucket" if bucketed
            else "chunks of the same plan")
    print(f"  graphed logits and caches bit-identical to the eager {twin} "
          f"for all {len(prompts)} prompts")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if hasattr(tree, "data_ptr") else []


def ladder_f32_phase(torch, dev, cfg, params, max_seq: int,
                     length: int = 437) -> None:
    """The graphed prefill at f32 compute (``params``, the f32 masters,
    and f32 caches) on one slot: a ``length``-token prompt (437: 256 +
    128 + 32 + 16 + 4 + 1 on the ladder at max_seq 1024, or one pass in
    the bucket of 512) replayed from its graphs and 8 greedy steps from
    the slot's decode graph, against the eager one-shot prefill of the
    same prompt and its 8 eager steps: logits within LOGIT_ATOL (where a
    recurrent state carries the prefill's difference into the steps,
    xLSTM and RG-LRU, the prefill's), the same greedy tokens; and the
    graphed prefill's logits bit-identical to its eager twin (the chunks
    of its plan, or the padded prefill of its bucket)."""
    import numpy as np

    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    prefill, reset_cache)
    from repro_torch.models.transformer import takes_ladder
    from repro_torch.serving.graphs import (BucketPrefillGraphs, DecodeGraphs,
                                            PrefillGraphs, eager_bucket,
                                            eager_ladder)

    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = cast_params(c32, params)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, length)), device=dev)
    _zero_counts()
    caches = init_cache(c32, 1, max_seq, dtype=torch.float32, device=dev)
    dec = DecodeGraphs(c32, p32, [caches], dev)
    if takes_ladder(cfg):
        ladder = PrefillGraphs(c32, p32, [caches], dec, max_seq, dev)
        how, kind = f"ladder {ladder.plan(length)}", "ladder"
    else:
        ladder = BucketPrefillGraphs(c32, p32, [caches], dec, max_seq, dev)
        how, kind = f"bucket of {ladder.bucket(length)}", "bucket"
    reset_cache(c32, caches)
    logits = ladder.prefill(0, prompt).clone()
    gt, gl = [int(logits[0].argmax())], [logits]
    for n in range(8):
        logits = dec.step(0, gt[-1], prompt.shape[1] + n).clone()
        gt.append(int(logits[0].argmax()))
        gl.append(logits)
    gl = torch.cat(gl)
    fresh = init_cache(c32, 1, max_seq, dtype=torch.float32, device=dev)
    if kind == "bucket":
        same, _ = eager_bucket(c32, p32, prompt, fresh, ladder.bucket(length))
    else:
        same, _ = eager_ladder(c32, p32, prompt, fresh, ladder.top)
    fresh = init_cache(c32, 1, max_seq, dtype=torch.float32, device=dev)
    logits, fresh = prefill(c32, p32, prompt, fresh)
    ot, ol = [int(logits[0].argmax())], [logits]
    for _ in range(8):
        logits, fresh = decode_step(
            c32, p32, torch.tensor([ot[-1]], device=dev), fresh)
        ot.append(int(logits[0].argmax()))
        ol.append(logits)
    ol = torch.cat(ol)
    err = float((gl - ol).abs().max())
    first = float((gl[0] - ol[0]).abs().max())
    recurrent = any(m in ("mlstm", "slstm", "rglru")
                    for g in cfg.groups for m in g.pattern)
    bitwise = torch.equal(gl[:1], same)
    print(f"{kind} prefill {cfg.arch_id} ({cfg.n_layers} layers), f32, "
          f"{length} tokens graphed as the {how} (captured in "
          f"{ladder.capture_seconds} s): tokens {gt}, one-shot {ot}; max "
          f"logit diff {err}, of the prefill {first} (tol {LOGIT_ATOL}"
          f"{', the prefill held' if recurrent else ''}); bit-identical to "
          f"the eager twin {bitwise}")
    if gt != ot or max(first, 0.0 if recurrent else err) > LOGIT_ATOL \
            or not bitwise:
        raise AssertionError(f"{cfg.arch_id}: the f32 {kind} prefill "
                             f"differs from the one-shot prefill or from "
                             f"its eager twin")
    _record_f32(f"{cfg.arch_id} f32 {kind} prefill ({length} tokens)",
                _attends(cfg))


def _attends(cfg) -> bool:
    """Whether ``cfg`` has a layer that runs the flash kernel."""
    return any(m in ("attn", "attn_local", "mla")
               for g in cfg.groups for m in g.pattern)


def chunked_prefill_phase(torch, dev, cfg, params, served,
                          max_seq: int) -> dict:
    """Chunked prefill (a prompt at a cache offset): one 512-token prompt
    prefilled in two chunks, 200 + 312 (the split falls inside a 128-row
    q tile and a 64-row kv tile), the second at cache offset 200 through
    the flash kernel's q offset, then 8 greedy decode steps, against the
    one-shot prefill of the same prompt and its 8 steps.

    Held at f32 compute (``params``, the f32 masters, and f32 caches):
    the last-token logits of the prefill and of every step within
    LOGIT_ATOL, the tolerance the smoke holds the card's logits to against
    the CPU's, the greedy tokens identical.  Where a recurrent state
    carries the chunks' f32 difference into the steps (xLSTM), the
    steps' logits are printed and the prefill's held: the canary stack's
    gates grow the difference from 6e-5 at the prefill to 3.7e-3 over 8
    steps (on an H100 80GB HBM3 at 700 W, PERF.md §6).  At the served
    bf16 compute (``served``, the engine's cast, bf16 caches: the
    kernel's tensor-core route) it is printed, not held: cuBLAS takes
    other tilings for a 312-row product than for a 512-row one and bf16
    rounds the difference (on the same card: 0.05-0.09 on prefill logits
    up to 5, and deepseek-v2's greedy tokens parting after 3 steps;
    PERF.md §6).  A MoE layer runs
    dropless here (capacity E / k): a dropping router drops other tokens
    from a chunk than from the whole prompt, in the reference too.
    Returns the kernels' launches of the served dtype's second chunk."""
    import numpy as np

    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    prefill)

    if cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 512)), device=dev)

    def run(c, weights, dtype, chunks, counted):
        caches = init_cache(c, 1, max_seq, dtype=dtype, device=dev)
        counts = None
        for i, chunk in enumerate(chunks):
            if counted and i == 1:
                _zero_counts()
            logits, caches = prefill(c, weights, chunk, caches)
            if counted and i == 1:
                counts = _read_counts()
        toks, out = [int(logits[0].argmax())], [logits.float()]
        for _ in range(8):
            logits, caches = decode_step(
                c, weights, torch.tensor([toks[-1]], device=dev), caches)
            toks.append(int(logits[0].argmax()))
            out.append(logits.float())
        return toks, torch.cat(out), counts

    whole, split = [prompt], [prompt[:, :200], prompt[:, 200:]]
    served_f32 = cfg.compute_dtype == "float32"
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = cast_params(c32, params)
    _zero_counts()
    at, al, _ = run(c32, p32, torch.float32, whole, False)
    bt, bl, counts = run(c32, p32, torch.float32, split, served_f32)
    if not served_f32:
        _record_f32(f"{cfg.arch_id} f32 chunked prefill", _attends(cfg))
    err = float((bl - al).abs().max())
    first = float((bl[0] - al[0]).abs().max())
    recurrent = any(m in ("mlstm", "slstm", "rglru")
                    for g in cfg.groups for m in g.pattern)
    print(f"chunked prefill {cfg.arch_id} ({cfg.n_layers} layers), f32: "
          f"one-shot tokens {at}, 200 + 312 {bt}; max logit diff {err}, of "
          f"the prefill {first} (tol {LOGIT_ATOL}"
          f"{', the prefill held' if recurrent else ''})")
    if at != bt or max(first, 0.0 if recurrent else err) > LOGIT_ATOL:
        raise AssertionError(f"{cfg.arch_id}: the chunked prefill differs "
                             f"from the one-shot prefill")
    if not served_f32:
        at, al, _ = run(cfg, served, torch.bfloat16, whole, False)
        bt, bl, counts = run(cfg, served, torch.bfloat16, split, True)
        if not bool(torch.isfinite(bl).all()):
            raise AssertionError(f"{cfg.arch_id}: chunked prefill logits "
                                 f"are not finite")
        print(f"  {cfg.compute_dtype} (printed, not held): one-shot tokens "
              f"{at}, 200 + 312 {bt}; max logit diff "
              f"{float((bl - al).abs().max())} (prefill "
              f"{float((bl[0] - al[0]).abs().max())}), |logits| max "
              f"{float(al.abs().max())}")
    return counts


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


def _mixer_flops(cfg, batch: int, seq: int) -> tuple[int, str]:
    """Model FLOPs a train step spends in products that are not x @ W
    (forward once, backward twice: 3x), and the formula: per attention
    layer 2·B·H·(Dqk + Dv)·seen (QKᵀ and PV; seen = the keys the causal
    mask and the window leave, summed over the rows; MLA's Dqk is nope +
    rope, its Dv v_head_dim), per mLSTM layer 2·B·H·(2·dh·seen_L +
    2·S·dh²) (its chunk's qkᵀ and (S∘W)v over the L-token chunks, and
    the carried state's C0 q and Σ v kᵀ, dh² a token)."""
    total = 0
    for g in cfg.groups:
        for mixer in g.pattern:
            if mixer in ("attn", "attn_local", "mla"):
                win = cfg.rec.local_window if mixer == "attn_local" else None
                seen = sum(min(i + 1, win or seq) for i in range(seq))
                if mixer == "mla":
                    m = cfg.mla
                    dqk, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
                else:
                    dqk = dv = cfg.head_dim_
                total += g.count * 3 * 2 * batch * cfg.n_heads \
                    * (dqk + dv) * seen
            elif mixer == "mlstm":
                di = int(cfg.d_model * cfg.rec.mlstm_proj_factor)
                dh, L = di // cfg.n_heads, min(1024, seq)
                seen = (seq // L) * sum(i + 1 for i in range(L))
                total += g.count * 3 * 2 * batch * cfg.n_heads \
                    * (2 * dh * seen + 2 * seq * dh * dh)
    formula = ("3 x (attention: 2·B·H·(Dqk + Dv)·seen a layer; mLSTM: "
               "2·B·H·(2·dh·seen + 2·S·dh²) a layer)")
    return total, formula


def train_phase(torch, dev, cfg, *, batch: int, seq: int, steps: int,
                cut: str = "nothing cut") -> dict:
    """Train ``cfg`` (full width, random weights from seed 0) for
    ``steps`` steps through ``repro_torch.launch.train.train`` and the
    Executor over ``dev``, remat full (a TrainStepGraph: eager step 1,
    then replays); losses and gradient norms finite.  Prints ``cut`` (how
    the config was cut to fit), the median step time past the first
    step, tokens/s, MFU, peak memory and the capture's seconds; returns
    the kernels' launch counts of the run."""
    import math

    from repro_torch.launch.train import train
    from repro_torch.training.optimizer import leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    out = train(cfg, steps=steps, batch=batch, seq=seq, device=dev,
                remat="full")
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    params = out["state"]["params"]
    n_params = sum(t.numel() for t in leaves(params))
    # the matmul parameters: all but the embedding lookup, whose table is
    # a matmul again where the head is tied
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else params["embed"].numel())
    losses, gnorms = out["losses"], out["grad_norms"]
    step_s = statistics.median(out["step_seconds"][1:])
    capture = out["capture_seconds"]
    del out, params
    gc.collect()
    torch.cuda.empty_cache()
    tokens = batch * seq
    flops, formula = _model_flops(cfg, batch, seq, n_matmul)
    print(f"train {cfg.arch_id} full width ({cfg.n_layers} layers: "
          f"{cut}; {n_params} params, f32 master, {cfg.compute_dtype} "
          f"compute, remat full, graphed), B {batch} x S {seq}, {steps} "
          f"steps: losses {losses}; grad norms {gnorms}; median step (past "
          f"the first) {step_s} s = {tokens / step_s} tokens/s; model "
          f"FLOPs per step {flops} ({formula}) = MFU "
          f"{flops / step_s / MFU_PEAK} of {MFU_PEAK / 1e12:.0f} TFLOP/s; "
          f"max_memory_allocated {peak} B; capture {capture} s")
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{cfg.arch_id}: a loss or grad norm is not "
                             f"finite")
    return counts


def _model_flops(cfg, batch: int, seq: int, n_matmul: int
                 ) -> tuple[int, str]:
    """A train step's model FLOPs and their formula: 6·N·T over the
    matmul parameters plus the mixers' products; recomputation not
    counted."""
    mixer, formula = _mixer_flops(cfg, batch, seq)
    return (6 * n_matmul * batch * seq + mixer,
            f"6·N·T with N = {n_matmul} matmul params, plus the mixers' "
            f"products {mixer} = {formula}; recomputation not counted")


def step_ab(torch, dev, cfg, *, batch: int, seq: int, steps: int) -> None:
    """The same call's A B B A of ``cfg``'s train step, eager (A) against
    a TrainStepGraph (B: eager step 1, capture, replays), remat full.
    Every run starts from one state: the seed-0 params drawn once and
    kept on the host, a fresh AdamW state; and takes the same ``steps``
    SyntheticSource batches.  A step's wall runs from a synchronised
    start to its loss and gradient norm on the host.  Prints, for each
    kind, the median step past the first over its two runs, tokens/s,
    MFU, each run's ``max_memory_allocated`` and ``max_memory_reserved``,
    and the graphs' capture seconds; fails unless every run's losses,
    gradient norms and final params are bit-identical to the first's."""
    from repro_torch.data import SyntheticSource
    from repro_torch.models import init_params
    from repro_torch.training import (AdamWConfig, TrainStepGraph,
                                      cosine_schedule, init_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import leaves

    cpu = torch.device("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    host = _to(torch, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), cpu)
    n_params = sum(t.numel() for t in leaves(host))
    n_matmul = n_params - (0 if cfg.tie_embeddings else host["embed"].numel())
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in SyntheticSource(
        cfg.vocab_size, seed=0).batch(i, batch, seq).items()}
        for i in range(steps)]
    opt = AdamWConfig(schedule=cosine_schedule(3e-4, 100, 1000))
    first, rows = None, {"eager": [], "graphed": []}
    for kind in ("eager", "graphed", "graphed", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = _to(torch, host, dev)
        state = {"params": params, "opt": init_opt_state(params)}
        step = make_train_step(cfg, opt, remat_policy="full")
        if kind == "graphed":
            step = TrainStepGraph(step, state)
        seconds, metrics = [], []
        for b in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, b)
            metrics.append(torch.stack([m["total_loss"],
                                        m["grad_norm"]]).tolist())
            seconds.append(time.perf_counter() - t0)
        final = [t.detach().cpu() for t in leaves(state["params"])]
        if first is None:
            first = (metrics, final)
        elif metrics != first[0] or not all(
                torch.equal(a, b) for a, b in zip(final, first[1])):
            raise AssertionError(f"{cfg.arch_id}: a {kind} run's losses, "
                                 f"grad norms or params differ from the "
                                 f"first eager run's")
        rows[kind].append({
            "seconds": seconds, "metrics": metrics,
            "allocated": torch.cuda.max_memory_allocated(dev),
            "reserved": torch.cuda.max_memory_reserved(dev),
            "capture": getattr(step, "capture_seconds", None)})
        del state, params, step, final, m
    del first, host, batches
    gc.collect()
    torch.cuda.empty_cache()
    flops, _ = _model_flops(cfg, batch, seq, n_matmul)
    parts = []
    for kind, runs in rows.items():
        med = statistics.median(t for r in runs for t in r["seconds"][1:])
        parts.append(
            f"{kind}: median step {med} s = {batch * seq / med} tokens/s, "
            f"MFU {flops / med / MFU_PEAK}, per run step s "
            f"{[r['seconds'] for r in runs]}, max_memory_allocated "
            f"{[r['allocated'] for r in runs]} B, max_memory_reserved "
            f"{[r['reserved'] for r in runs]} B"
            + (f", capture {[r['capture'] for r in runs]} s"
               if kind == "graphed" else ""))
    print(f"train step A/B {cfg.arch_id}, B {batch} x S {seq}, {steps} steps "
          f"a run, runs eager, graphed, graphed, eager from one state: "
          f"losses and grad norms {rows['eager'][0]['metrics']} and final "
          f"params bit-identical in all four; " + "; ".join(parts))


def distributed_phase(torch, dev, card: str) -> dict:
    """Phase 7, the distributed layer held at world size 1: a one-rank
    NCCL group and the 1x1 smoke mesh on ``dev`` (no fallback; torn down
    at the end), then :func:`pipeline_case`, :func:`flash_decode_case`
    and :func:`moe_ep_case`.  Returns the launch counts of the pipeline
    run and of the expert-parallel call."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    if dist.is_initialized():
        raise AssertionError("a process group is up before the distributed "
                             "phase")
    t0 = time.perf_counter()
    mesh = make_smoke_mesh(dev)
    print(f"[{card}] distributed: {dist.get_backend()} group of "
          f"{dist.get_world_size()} rank, mesh {mesh} up in "
          f"{time.perf_counter() - t0} s")
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError("the smoke mesh is not an NCCL mesh on the card")
    try:
        pipe = pipeline_case(torch, dev, card, mesh)
        flash_decode_case(torch, dev, card, mesh)
        moe = moe_ep_case(torch, dev, card, mesh)
    finally:
        dist.destroy_process_group()
    return {"pipeline": pipe, "moe": moe}


def _zero_counts():
    from repro_torch import kernels
    for name in COUNTED:
        getattr(kernels, name).launches = 0
    kernels.flash_attention.f32_launches = 0
    kernels.flash_attention_bwd.f32_launches = 0


def _read_counts() -> dict:
    from repro_torch import kernels
    return kernels.launch_counts(COUNTED)


def _read_f32_counts() -> dict:
    from repro_torch import kernels
    return kernels.launch_counts(kernels.F32_ROUTES)


#: the f32 paths' launches of the flash kernels' f32 route, by path
F32_PATHS: dict = {}


def _record_f32(path: str, forward: bool, backward: bool = False) -> None:
    """The flash launches since the last ``_zero_counts()``, an f32 path's:
    each went through the f32 route, and the route ran (forward,
    ``backward``) where the path attends.  Kept in ``F32_PATHS``."""
    counts, f32 = _read_counts(), _read_f32_counts()
    fwd, bwd = f32["flash_attention_f32"], f32["flash_attention_bwd_f32"]
    print(f"  {path}: the f32 route's launches: flash {fwd} of "
          f"{counts['flash_attention']}, flash_bwd {bwd} of "
          f"{counts['flash_attention_bwd']}")
    if fwd != counts["flash_attention"] or bwd != counts[
            "flash_attention_bwd"] or (forward and not fwd) or (
            backward and not bwd):
        raise AssertionError(f"{path}: a flash launch missed the f32 route")
    F32_PATHS[path] = f32


def pipeline_case(torch, dev, card: str, mesh) -> dict:
    """phi3-mini-3.8b at full width and depth, bf16 compute, seed-0
    weights, cut into 4 stages of 8 blocks (stage 0 also embeds, stage 3
    also norms and projects), 4 microbatches of B 1 x S 512, through
    ``build_pipeline_graph`` and the Executor (``DEFAULT_SCHED``) over
    ``stage_bins`` of three ``DeviceBin(cuda:0)`` and one live 1x1
    ``MeshBin``.  Each stage's weights are a host tree (bf16 CPU
    tensors) pulled leaf by leaf.  Each microbatch's logits against
    ``forward`` of it alone at the bf16 gate, the same greedy token at the
    last position; 128 flash launches (32 blocks x 4 microbatches); the
    mesh slice ran a stage.  Prints the wall time, the simulated makespan
    of the same placement and ``pipeline_schedule_length``."""
    import numpy as np

    from repro_torch.configs import DEFAULT_SCHED, get_config
    from repro_torch.core import Executor
    from repro_torch.core.graph import map_tree
    from repro_torch.distributed.pipeline import (build_pipeline_graph,
                                                  pipeline_schedule_length)
    from repro_torch.models import cast_params, forward, init_params
    from repro_torch.models.transformer import pipeline_stages
    from repro_torch.sched import (CostModel, DeviceBin, MeshBin, simulate,
                                   stage_bins)

    cfg = get_config(PHI3)
    params = cast_params(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stages = pipeline_stages(cfg, params, 4)
    for st in stages:
        st.params = map_tree(lambda t: t.cpu(), st.params)
    host_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, cfg.vocab_size, size=(1, 512)) for _ in range(4)]
    (mesh_bin,) = MeshBin.from_mesh(mesh)
    pool = stage_bins([DeviceBin(dev), DeviceBin(dev), DeviceBin(dev),
                       mesh_bin])
    out: list = []
    G = build_pipeline_graph(stages, mbs, collect=out)
    _zero_counts()
    t0 = time.perf_counter()
    with Executor(num_workers=DEFAULT_SCHED.host_workers, devices=pool,
                  scheduler=DEFAULT_SCHED.policy) as ex:
        ex.run(G).result(timeout=600)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = _read_counts()
    placement = {n.id: n.device for n in G.nodes if n.device is not None}
    on = {n.state["stage"]: n.device.label for n in G.nodes
          if n.state.get("stage") is not None and n.name.startswith("f[")}
    costs = [st.cost for st in stages]
    sim = simulate(G, placement, pool, cost_model=CostModel()).makespan
    bound = pipeline_schedule_length(len(stages), len(mbs), costs)
    print(f"[{card}] pipeline {cfg.arch_id} full width ({cfg.n_layers} "
          f"blocks, {cfg.compute_dtype} compute) in 4 stages x 4 "
          f"microbatches of 1 x 512: stages on "
          f"{on}, costs {costs}; wall {wall} s (weight pulls included; "
          f"host copies of the weights made in {host_s} s before it); "
          f"simulated makespan of the same placement {sim} s (default "
          f"CostModel); pipeline_schedule_length {bound} cost units")
    if mesh_bin.label not in {v.split(":", 1)[1] for v in on.values()}:
        raise AssertionError("no stage ran on the mesh slice")
    _check_counts(counts, {"flash_attention": 128})
    t0 = time.perf_counter()
    for n, tokens in enumerate(mbs):
        want, _ = forward(cfg, params, torch.as_tensor(tokens, device=dev))
        got = torch.as_tensor(out[n], device=dev)
        err = _check(torch, f"pipeline microbatch {n}", got, want,
                     "bfloat16")
        same = int(got[0, -1].argmax()) == int(want[0, -1].argmax())
        print(f"[{card}] microbatch {n}: logits {tuple(got.shape)} max abs "
              f"diff to forward {err} (bitwise: {bool(torch.equal(got, want))}"
              f"); greedy last token {int(got[0, -1].argmax())} vs "
              f"{int(want[0, -1].argmax())}")
        if not same:
            raise AssertionError("the pipeline's greedy token differs from "
                                 "forward's")
    print(f"[{card}] forward of the 4 microbatches one by one: "
          f"{time.perf_counter() - t0} s (comparison included)")
    del params, stages, G, out
    gc.collect()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()                      # the pinned staging buffers
    return counts


def flash_decode_case(torch, dev, card: str, mesh) -> None:
    """``flash_decode_update`` at world size 1 at phi3's decode shape (B
    1, H = K = 32, D 96, cache 1024, writing row 517), bf16 and f32,
    against the decode kernel over the cache with the row written, at the
    gate of the decode rows in phase 3; the cache rows updated in place
    are the row written.  Times both."""
    from repro_torch.distributed.flash_decode import flash_decode_update
    from repro_torch.kernels import decode_attention

    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    B, H, K, D, S, length = 1, 32, 32, 96, 1024, 517
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        q, kn, vn = randn(B, 1, H, D), randn(B, 1, K, D), randn(B, 1, K, D)
        kc, vc = randn(B, S, K, D), randn(B, S, K, D)
        kw, vw = kc.clone(), vc.clone()
        kw[:, length], vw[:, length] = kn[:, 0], vn[:, 0]
        valid = torch.full((B,), length + 1, dtype=torch.int32, device=dev)
        want = decode_attention(q[:, 0], kw, vw, valid)
        pos = torch.tensor([length], device=dev)
        kg, vg = kc.clone(), vc.clone()
        out, _, _ = flash_decode_update(q, kn, vn, kg, vg, pos, mesh=mesh,
                                        baxes=("data",), maxis="model")
        name = f"flash_decode_update {str(dtype)[6:]}"
        err = _check(torch, name, out[:, 0], want.float(), str(dtype)[6:])
        if not (torch.equal(kg, kw) and torch.equal(vg, vw)):
            raise AssertionError(f"{name}: the cache update differs")
        ms = _median_ms(torch, lambda: flash_decode_update(
            q, kn, vn, kg, vg, pos, mesh=mesh, baxes=("data",),
            maxis="model"), flush)
        kernel_ms = _median_ms(torch, lambda: decode_attention(
            q[:, 0], kw, vw, valid), flush)
        print(f"[{card}] {name} at world size 1, B {B} H {H} K {K} D {D} "
              f"cache {S} at {length}: max abs err to the decode kernel "
              f"{err} (atol {ATOL} + {RTOL[str(dtype)[6:]]}·|ref|); "
              f"{ms} ms (plain torch, 3 NCCL all_reduce included) vs the "
              f"decode kernel {kernel_ms} ms (CUDA events, L2 flushed)")


def moe_ep_case(torch, dev, card: str, mesh) -> dict:
    """``_moe_shard_map`` at world size 1 on deepseek-v2's MoE layer at
    full width (E 160, top-6, 2 shared experts, bf16 weights drawn from
    seed 0) and 512 bf16 tokens, against ``_moe_local`` plus the shared
    experts at the bf16 gate; its gating launch is counted (the
    comparison's is not)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.layers import ffn_forward

    cfg = dataclasses.replace(get_config(DSV2), param_dtype="bfloat16")
    cdt = torch.bfloat16
    p = M.init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev, 1)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict)
             else v[0]) for k, v in p.items()}
    x = torch.randn((1, 512, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(cdt)
    _zero_counts()
    got, _ = M._moe_shard_map(cfg, p, x, cdt, mesh, ("data",), "model")
    torch.cuda.synchronize(dev)
    counts = _read_counts()
    want, _ = M._moe_local(cfg, p, x, cdt)
    want = want + ffn_forward(cfg, p["shared"], x)
    err = _check(torch, "expert-parallel MoE", got, want.float(), "bfloat16")
    times = {}
    for name, fn in (("_moe_shard_map", lambda: M._moe_shard_map(
            cfg, p, x, cdt, mesh, ("data",), "model")),
            ("_moe_local", lambda: M._moe_local(cfg, p, x, cdt))):
        fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize(dev)
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    # the dispatch buffer's all_to_all alone, on the card's clock
    buf = torch.zeros((cfg.moe.n_experts, M.capacity(cfg, 512),
                       cfg.d_model), dtype=cdt, device=dev)
    a2a_ms = _median_ms(torch, lambda: M._all_to_all(buf, mesh, "model", 0,
                                                     1), flush=buf, reps=5)
    print(f"[{card}] _moe_shard_map at world size 1, deepseek-v2 MoE layer "
          f"(E {cfg.moe.n_experts}, top-{cfg.moe.top_k}, "
          f"{cfg.moe.n_shared} shared; bf16) on 512 tokens: max abs diff to "
          f"_moe_local + shared {err} (bitwise: {bool(torch.equal(got, want))}"
          f"); {times['_moe_shard_map']} ms a call (shared experts and 2 "
          f"NCCL all_to_all included) vs _moe_local {times['_moe_local']} "
          f"ms (shared experts not included); host clock over 5 calls; "
          f"one all_to_all of the {tuple(buf.shape)} bf16 dispatch buffer "
          f"{a2a_ms} ms (CUDA events)")
    _check_counts(counts, {"moe_gating": 1})
    del p, x, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return counts


#: phase 8's bands: the dry-run's peak memory over the card's (an
#: undercount is unsafe: the dry-run's purpose is to say a cell fits),
#: and the most its bound may exceed the measured step (past it a count
#: is wrong: no step beats its bound)
MEMORY_BAND = (0.95, 1.15)
MAX_ROOFLINE_SHARE = 1.05
#: the dry-run cells the port traced last (the reference traces all 32):
#: xLSTM's time loops as ops counting their steps, qwen2-vl's loss over
#: masked visual positions
LAST_CELLS = [(XLSTM, "prefill_32k"), (XLSTM, "train_4k"),
              (QWEN2VL, "train_4k")]


def prediction_phase(torch, dev, card: str) -> dict:
    """Phase 8: the dry-run (``repro_torch.launch.dryrun``) against the
    card.  (a) Four cells that fit one card, traced on a 1x1 fake mesh and
    run for real with the same step function: phi3-mini-3.8b's decode
    step at batch 4 against a 1024-row cache (bf16 weights, every row
    valid), minicpm-2b's train step at B 4 x S 1024 (accum 1, remat
    full: phase 6's), xlstm-1.3b's prefill at full depth (B 1 x S 512,
    bf16 weights, f32 compute) and its train step cut to its first
    super-block (8 of 48 blocks: phase 6's cut, B 1 x S 512, accum 1),
    whose time loops the trace counts as one op each.  Fails unless the
    FLOPs equal ``FlopCounterMode``'s count of the real step (which takes
    the kernels' custom ops by their formulas; xLSTM's loops step by
    step), the predicted peak over ``max_memory_allocated`` lies in
    MEMORY_BAND (the memory the process held before the cell, the
    cuBLAS workspaces among it, is added to the prediction and printed)
    and the bound over the measured median step is at most
    MAX_ROOFLINE_SHARE.  The measured step is the eager one (the function
    the dry-run traces); the train step replayed from a TrainStepGraph is
    timed after it and held to the same bound.  Then what the custom op
    adds to an eager call (:func:`_dispatch_cost`).  (b) llama4-maverick x
    decode_32k (MoE, GQA with kv heads replicated over the model axis)
    and :data:`LAST_CELLS` on the fake 16x16 mesh as the CLI traces them,
    each in a process of its own beside (a) (they need the host only);
    their record lines.  Returns the launch counts of the real steps, by
    path."""
    # the 16x16 cells trace on the host alone: each in a process of its
    # own, beside the checks on the card, read after them
    out = tempfile.mkdtemp(prefix="dryrun_")
    t_full = time.perf_counter()
    full = [_start_cell(arch, shape, out)
            for arch, shape in [(LLAMA4, "decode_32k"), *LAST_CELLS]]
    try:
        launches = _card_cells(torch, dev, card)
        _dispatch_cost(torch, dev, card)
        for proc in full:
            _read_cell(proc, card, out)
    finally:
        for proc in full:
            proc.kill()
            proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    print(f"[{card}] llama4 decode_32k and {len(LAST_CELLS)} cells traced "
          f"on the fake 16x16 mesh, each in its own process, all done "
          f"{time.perf_counter() - t_full} s after they started")
    return launches


def _card_cells(torch, dev, card: str) -> dict:
    """Phase 8 (a): each cell traced on a 1x1 fake mesh and run for real,
    held to the FLOPs, MEMORY_BAND and MAX_ROOFLINE_SHARE; returns the
    launch counts of the real steps, by path."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    launches = {}
    xlstm = get_config(XLSTM)
    block = dataclasses.replace(xlstm, groups=(
        dataclasses.replace(xlstm.groups[0], count=1),))
    for arch, cfg, shape, ov, reps in [
            (PHI3, get_config(PHI3),
             ShapeConfig("decode_b4_c1024", 1024, 4, "decode"), None, 20),
            (MINICPM, get_config(MINICPM),
             ShapeConfig("train_b4_s1024", 1024, 4, "train"), {"accum": 1},
             3),
            (XLSTM, xlstm, ShapeConfig("prefill_b1_s512", 512, 1,
                                       "prefill"), None, 3),
            (f"{XLSTM} (8 of 48 blocks)", block,
             ShapeConfig("train_b1_s512", 512, 1, "train"), {"accum": 1},
             3)]:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(cfg, shape, mesh_shape=(1, 1),
                              extra_overrides=ov)
        traced = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        fn, args = _real_cell(torch, dev, cfg, shape, ov)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        torch.cuda.synchronize()
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        step = statistics.median(times)
        graphed = _graphed_median(torch, fn, args, reps) \
            if shape.kind == "train" else None
        roof = rec["roofline"]
        want = rec["memory"]["per_device_total"] + base
        t_bound = max(roof["t_compute_s"], roof["t_memory_s"],
                      roof["t_collective_s"])
        flops = counter.get_total_flops()
        tag = f"{arch} {shape.name}"
        print(f"[{card}] dry-run vs card, {tag} (traced in {traced} s, "
              f"overrides {rec['overrides']}):")
        print(f"  flops: predicted {int(roof['flops_per_chip'])}, "
              f"FlopCounterMode {flops}; kernel launches {counts}")
        print(f"  peak memory: predicted {want} (dry-run "
              f"{rec['memory']['per_device_total']} + held before "
              f"{base}), max_memory_allocated {peak}, ratio {want / peak}")
        print(f"  roofline: t_bound {t_bound} s ({roof['bottleneck']}; "
              f"t_compute {roof['t_compute_s']}, t_memory "
              f"{roof['t_memory_s']}), measured step (eager) median "
              f"{step} s of {reps}, share {t_bound / step}")
        if graphed is not None:
            print(f"  graphed step (TrainStepGraph, capture "
                  f"{graphed[1]} s): median {graphed[0]} s of {reps} "
                  f"replays, share {t_bound / graphed[0]}")
            if t_bound / graphed[0] > MAX_ROOFLINE_SHARE:
                raise AssertionError(f"{tag}: the bound {t_bound} s is "
                                     f"{t_bound / graphed[0]} of the "
                                     f"graphed step: a count is wrong")
        if int(roof["flops_per_chip"]) != flops:
            raise AssertionError(f"{tag}: the dry-run counts "
                                 f"{roof['flops_per_chip']} FLOPs, the card "
                                 f"{flops}")
        if not MEMORY_BAND[0] <= want / peak <= MEMORY_BAND[1]:
            raise AssertionError(f"{tag}: predicted peak {want} is "
                                 f"{want / peak} of the card's {peak}, "
                                 f"outside {MEMORY_BAND}")
        if t_bound / step > MAX_ROOFLINE_SHARE:
            raise AssertionError(f"{tag}: the bound {t_bound} s is "
                                 f"{t_bound / step} of the measured step "
                                 f"{step} s: a count is wrong")
        for k, n in counts.items():
            launches.setdefault(k, {})[f"{tag} (dry-run check)"] = n
        del fn, args
        gc.collect()
        torch.cuda.empty_cache()

    return launches


def _start_cell(arch: str, shape: str, out: str):
    """The dry-run's CLI for one cell on the fake 16x16 mesh, started in a
    process of its own that writes the record and its output under
    ``out``."""
    cell = f"{arch}__{shape}__pod1"
    with open(Path(out) / f"{cell}.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], stdout=log,
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    proc.cell = cell
    return proc


def _read_cell(proc, card: str, out: str) -> None:
    """Waits for a :func:`_start_cell` process and prints its record line,
    whether the cell fits, its memory and its collectives; raises if the
    cell did not trace."""
    proc.wait(timeout=600)
    text = (Path(out) / f"{proc.cell}.log").read_text()
    line = next((ln for ln in text.splitlines() if ln.startswith("OK ")),
                None)
    if proc.returncode or line is None:
        raise AssertionError(f"dry-run of {proc.cell}: exit "
                             f"{proc.returncode}\n{text[-6000:]}")
    rec = json.loads((Path(out) / f"{proc.cell}.json").read_text())
    print(f"[{card}] {line}")
    print(f"  fits {rec['fits']}, memory {rec['memory']}, collectives "
          f"{rec['collectives']['counts']}")


def _graphed_median(torch, fn, args, reps: int) -> tuple[float, float]:
    """The train step ``fn(state, batch)`` through a TrainStepGraph: one
    call (eager step and capture), then ``reps`` replays each ended by a
    synchronise.  Returns (median replay seconds, capture seconds)."""
    from repro_torch.training import TrainStepGraph

    graph = TrainStepGraph(fn, args[0])
    graph(*args)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        graph(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), graph.capture_seconds


def _dispatch_cost(torch, dev, card: str, calls: int = 200) -> None:
    """What the custom op adds to an eager kernel call on the host: the
    decode kernel at phi3's batch-1 decode shape, ``calls`` launches
    through the custom op (the route a traced call takes), the wrapper
    (an eager call: the launch function) and the launch function itself,
    in turns, host clock over each run ended by a synchronise; µs a
    call."""
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention.ops import _decode_launch

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 32, 96), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((1, 1024, 32, 96), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    vl = torch.tensor([517], dtype=torch.int32, device=dev)
    runs = {"custom op": lambda: torch.ops.repro_torch.decode_attention(
                q, k, v, vl, 96 ** -0.5),
            "wrapper": lambda: decode_attention(q, k, v, vl),
            "launch function": lambda: _decode_launch(q, k, v, vl,
                                                      96 ** -0.5)}
    us = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)] * 2:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            runs[name]()
        torch.cuda.synchronize()
        us[name].append((time.perf_counter() - t) / calls * 1e6)
    print(f"[{card}] eager decode_attention call, host µs (median of 4 "
          f"runs of {calls}, in turns): "
          + ", ".join(f"{n} {statistics.median(u)}" for n, u in us.items()))


def _real_cell(torch, dev, cfg, shape, ov):
    """The step function of a dry-run cell and real inputs for it on
    ``dev``: random weights from seed 0 (bf16 for serving, as the
    dry-run's), random tokens, caches of the cell's length."""
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.training import init_train_state

    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    if shape.kind == "train":
        fn = dryrun.step_fn(cfg, shape, remat_policy="full",
                            accum=int((ov or {}).get("accum", 1)))
        state = init_train_state(cfg, gen, dev)
        return fn, (state, {"tokens": tokens, "labels": tokens})
    fn = dryrun.step_fn(cfg, shape)
    params = init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                         gen, dev)
    caches = dryrun.serve_caches(cfg, shape, device=dev)
    batch = ({"token": tokens[:, 0]} if shape.kind == "decode"
             else {"tokens": tokens})
    return fn, (params, batch, caches)


#: phase 9: the view pipelines at the builder's sizes (512 x 64, 4 GD
#: steps); the propagation DAG at the scale the reference builder
#: documents (10⁵ cells: 2·10⁵ pull and kernel tasks); detailed placement
#: at the reference example's defaults (8 iterations x 256 cells)
VIEWS = 32
DAG_VIEWS, DAG_CELLS_PER_VIEW = 1000, 100
PLACE_ITERS = 8
#: the logistic-regression models fitted on the card against the CPU's
#: (f32, TF32 off; the sums of the two matrix-vector products in another
#: order), and the placement objective (a sum of 256 f32 row maxima)
VIEW_RTOL, VIEW_ATOL = 1e-5, 1e-6
PLACE_RTOL = 1e-6
#: runs of each short application (views, placement) at each worker
#: count: each is checked, each one's seconds printed, the median's rate
#: reported (a run takes 10-400 ms with the executor's set-up, so one
#: stall of the host moves a single run's rate many times over)
APP_RUNS = 3
TRAIN_CKPT_EVERY = 50


def _examples():
    """The port's example twins (``examples_torch/`` beside this script)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import examples_torch.detailed_placement as detailed_placement
    import examples_torch.quickstart as quickstart
    import examples_torch.serve_lm as serve_lm
    import examples_torch.timing_analysis as timing_analysis
    import examples_torch.train_lm as train_lm
    return quickstart, timing_analysis, detailed_placement, serve_lm, train_lm


def longest_path(G):
    """The plain longest path over a propagation DAG's own edges, in cell
    order, independent of the executor: a cell's arrival is the largest
    arrival among the kernels it depends on (0.0 for none) plus its
    ``cost``, which is its delay.  Cells only depend on earlier cells.
    Reads nothing but node types, edges and costs, so it takes either
    package's graph."""
    import numpy as np

    cells = [n for n in G.nodes if n.type.value == "kernel"]
    pos = {n.id: i for i, n in enumerate(cells)}
    out = [0.0] * len(cells)
    for i, n in enumerate(cells):
        ups = [out[pos[d.id]] for d in n.dependents if d.id in pos]
        out[i] = (max(ups) if ups else 0.0) + n.state["cost"]
    return np.array(out)


def saxpy_case(card: str) -> None:
    """Phase 9 (a): Listing 1's saxpy twin on the card pushes y == 4."""
    quickstart = _examples()[0]
    _, y = quickstart.main(["--device", "cuda"])
    if not (y == 4.0).all():
        raise AssertionError("saxpy: y != 4 after the push")
    print(f"[{card}] saxpy (Listing 1) on the card: y == 4.0 in all "
          f"{y.size} elements after the push")


def views_case(card: str) -> None:
    """Phase 9 (b): 32 view pipelines (host extract → pull → logistic
    regression, 4 GD steps → push) at workers 1, 2, 4 and 8,
    ``APP_RUNS`` runs each; every fitted model against the same builder
    run by the port on a CPU bin."""
    import os

    import numpy as np

    ta = _examples()[1]
    cores = os.cpu_count()
    ref = np.stack(ta.main(["--views", str(VIEWS), "--workers", "4",
                            "--device", "cpu"])[0]["models"])
    for w in (1, 2, 4, 8):
        runs = [ta.main(["--views", str(VIEWS), "--workers", str(w)])[0]
                for _ in range(APP_RUNS)]
        err = 0.0
        for run in runs:
            models = np.stack(run["models"])
            err = max(err, float(np.abs(models - ref).max()))
            if not (models != 0).any(axis=1).all() or not np.allclose(
                    models, ref, rtol=VIEW_RTOL, atol=VIEW_ATOL):
                raise AssertionError(f"timing views: the card's models "
                                     f"differ from the CPU's (max diff {err})")
        total = statistics.median(r["seconds"] for r in runs)
        alone = statistics.median(r["run_seconds"] for r in runs)
        print(f"[{card}] timing views, workers {w} ({cores} cores): {VIEWS} "
              f"views, median of {APP_RUNS} runs {total} s = {VIEWS / total}"
              f" views/s (the run alone {alone} s = {VIEWS / alone} views/s;"
              f" runs {[r['seconds'] for r in runs]} s); simulated makespan "
              f"{runs[0]['sim'].makespan} s; max |model - cpu model| {err}")


def _dag_report(card: str, run: dict, label: str) -> None:
    """Hold one propagation-DAG run's arrivals against
    :func:`longest_path` bit for bit and print its numbers."""
    import numpy as np

    G = run["graph"]
    t0 = time.perf_counter()
    want = longest_path(G)
    plain_s = time.perf_counter() - t0
    got = run["arrivals"]
    n, tasks = len(got), len(G)
    same = got.dtype == want.dtype and np.array_equal(got, want)
    sim = run["sim"].makespan
    print(f"[{card}] propagation DAG{label}, workers {run['workers']}: "
          f"{n} cells ({tasks} tasks) built in {run['build_seconds']} s, "
          f"run in {run['run_seconds']} s = {n / run['run_seconds']} "
          f"cells/s, {run['run_seconds'] / tasks * 1e6} wall µs per task "
          f"({n / run['seconds']} cells/s with the executor's set-up, "
          f"placement and simulation, {run['seconds']} s); simulated "
          f"makespan {sim} s against {run['run_seconds']} s measured "
          f"(x{sim / run['run_seconds']}); worst arrival {got.max()}; "
          f"bit-identical to the plain longest path ({plain_s} s): {same}")
    if not same:
        bad = int(np.sum(got != want)) if got.shape == want.shape else n
        raise AssertionError(f"propagation DAG: {bad} arrivals differ from "
                             f"the plain longest path")


def dag_case(dev, card: str) -> None:
    """Phase 9 (c): the propagation DAG at 10⁵ cells at workers 1, 4 and
    8, then the profile-guided loop: one more run at 1 worker with
    ``--profile``, a ``CostModel`` fitted from its trace
    (``CostModel.fit(load_trace(...))``) and the simulation of the same
    graph and placement under it, against that run's measurement."""
    import os

    from repro_torch.sched import (CostModel, get_scheduler, load_trace,
                                   simulate)

    ta = _examples()[1]
    argv = ["--views", str(DAG_VIEWS), "--cells-per-view",
            str(DAG_CELLS_PER_VIEW)]
    for w in (1, 4, 8):
        run = ta.main(argv + ["--workers", str(w)])[0]
        _dag_report(card, run, "")
        del run
        gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "dag_trace.json")
        run = ta.main(argv + ["--workers", "1", "--profile", trace])[0]
        _dag_report(card, run, " (profiled)")
        G, devices = run["graph"], [dev]
        model = CostModel.fit(load_trace(trace))
        placement = get_scheduler(ta.DEFAULT_SCHED.policy).schedule(
            G, devices)
        sim = simulate(G, placement, devices, cost_model=model,
                       host_workers=1).makespan
    measured = run["profiler"].makespan()
    print(f"[{card}] profile-guided loop, workers 1: the simulation under "
          f"the CostModel fitted from the run's trace predicts {sim} s "
          f"against {run['run_seconds']} s measured "
          f"(x{sim / run['run_seconds']}; the trace's own makespan "
          f"{measured} s)")
    del run, G
    gc.collect()


def _mis_masks(G) -> list:
    from repro_torch.core import KernelTask
    return [KernelTask(n).host_result() for n in G.nodes
            if n.name.startswith("mis[")]


def placement_case(card: str) -> None:
    """Phase 9 (d): detailed placement at 8 iterations x 256 cells at
    workers 1, 2 and 4, ``APP_RUNS`` runs each: every run's objective
    trace within PLACE_RTOL of a CPU bin's run of the same builder and
    its MIS masks identical."""
    import numpy as np

    dp = _examples()[2]
    ref = dp.main(["--device", "cpu"])
    ref_masks = _mis_masks(ref["graph"])
    for w in (1, 2, 4):
        runs = [dp.main(["--workers", str(w)]) for _ in range(APP_RUNS)]
        diff = 0.0
        for run in runs:
            masks = _mis_masks(run["graph"])
            obj = np.array(run["objective"])
            diff = max(diff, float(np.max(np.abs(obj / ref["objective"]
                                                 - 1))))
            same = len(masks) == len(ref_masks) == PLACE_ITERS and all(
                np.array_equal(a, b) for a, b in zip(masks, ref_masks))
            if not same or not np.allclose(obj, ref["objective"],
                                           rtol=PLACE_RTOL, atol=0):
                raise AssertionError("detailed placement: the card's run "
                                     "differs from the CPU's")
        dt = statistics.median(r["seconds"] for r in runs)
        print(f"[{card}] detailed placement, workers {w}: {PLACE_ITERS} "
              f"iterations, median of {APP_RUNS} runs {dt} s = "
              f"{PLACE_ITERS / dt} iterations/s (runs "
              f"{[r['seconds'] for r in runs]} s); simulated makespan "
              f"{runs[0]['sim'].makespan} s; objective max rel diff to the "
              f"cpu's {diff}; MIS masks identical in every run")


def serve_lm_case(card: str) -> dict:
    """Phase 9 (e): the serve_lm twin with its defaults and with ``--bins
    2 --scheduler balanced``: every request finishes, flash = layers x
    prefills and decode = layers x decode steps (the replays and the
    engine's warm-up step) as phase 5 counts them, every prefill replayed
    from the ladder (flash = layers x its chunks of two tokens or more and
    its warm-up chunks, its one-token chunks decode steps).  Returns the
    counts by run."""
    from repro_torch.launch.serve import graph_report
    from repro_torch.serving.graphs import DecodeGraphs

    serve_lm = _examples()[3]
    launches = {}
    for argv in ([], ["--bins", "2", "--scheduler", "balanced"]):
        _zero_counts()
        eng, done, dt = serve_lm.main(argv)
        counts = _read_counts()
        s = eng.stats()
        tokens = sum(len(r.generated) for r in done)
        name = "serve_lm twin" + (" " + " ".join(argv) if argv else "")
        print(f"[{card}] {name}: {len(done)} requests, {tokens} tokens in "
              f"{dt} s = {tokens / dt} tok/s; ttft p50 {s['ttft_p50_s']} "
              f"p99 {s['ttft_p99_s']} s; itl p50 {s['itl_p50_s']} p99 "
              f"{s['itl_p99_s']} s; kv moves {s['kv_moves']}")
        if not all(r.done for r in done) or s["preemptions"]:
            raise AssertionError(f"{name}: a request did not finish or was "
                                 f"preempted")
        graphs, ladder = eng.decode_graphs, eng.prefill_graphs
        if graphs.replays != sum(len(r.generated) - 1 for r in done):
            raise AssertionError(f"{name}: a decode step was not a replay")
        if ladder.prefills != len(done):
            raise AssertionError(f"{name}: a prefill was not replayed")
        print(f"[{card}] {name}: {graph_report(eng)}")
        layers = eng.cfg.n_layers
        _check_counts(counts, {
            "flash_attention": layers * (ladder.replays
                                         + ladder.warmup_chunks),
            "decode_attention": layers * (graphs.replays
                                          + DecodeGraphs.warmup_steps
                                          + ladder.decode_chunks)})
        for k, n in counts.items():
            launches.setdefault(k, {})[name] = n
        del eng, graphs, ladder
        gc.collect()
    return launches


def train_lm_case(torch, dev, card: str) -> dict:
    """Phase 9 (f): the train_lm twin with ``--full`` (≈100M parameters,
    300 steps, B 8 x S 128) through its task graph, its step a
    TrainStepGraph (one eager step, 299 replays): the loss falls, the
    latest checkpoint is the last multiple of ``--ckpt-every``, flash =
    flash_bwd = layers x steps (remat none).  Returns the counts."""
    import math

    train_lm = _examples()[4]
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts()
        out = train_lm.main(["--full", "--ckpt-dir", tmp, "--ckpt-every",
                             str(TRAIN_CKPT_EVERY)])
        counts = _read_counts()
    losses, steps, layers = out["losses"], out["steps"], out["cfg"].n_layers
    tokens = steps * 8 * 128
    print(f"[{card}] train_lm twin --full ({out['cfg'].param_count()} "
          f"params, {layers} layers): {steps} steps in {out['seconds']} s = "
          f"{tokens / out['seconds']} tok/s; loss {losses[0]} -> "
          f"{losses[-1]}; latest checkpoint step {out['latest_step']}; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} B; "
          f"step graph captured in {out['capture_seconds']} s")
    if out["capture_seconds"] is None:
        raise AssertionError("train_lm twin: the step was not graphed")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError("train_lm twin: the loss did not fall")
    if out["latest_step"] != steps // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY:
        raise AssertionError(f"train_lm twin: latest checkpoint step "
                             f"{out['latest_step']}")
    _check_counts(counts, {"flash_attention": layers * steps,
                           "flash_attention_bwd": layers * steps})
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return {k: {"train_lm twin --full": n} for k, n in counts.items()}


def apps_phase(torch, dev, card: str) -> dict:
    """Phase 9: the paper's applications through the port's example twins
    (``examples_torch/``) on the card.  Returns the launch counts of the
    serve_lm and train_lm runs, by path."""
    saxpy_case(card)
    views_case(card)
    dag_case(dev, card)
    placement_case(card)
    launches = serve_lm_case(card)
    for k, by_path in train_lm_case(torch, dev, card).items():
        launches.setdefault(k, {}).update(by_path)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    for part in ("src/repro_torch", "examples_torch"):
        if not (ROOT / part).is_dir():
            print(f"chip_smoke: {part} is missing beside this script",
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
    from repro_torch.models import init_params

    t_start = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t_start} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    chosen = kernel_phase(torch, dev, logs)
    reference_phase(torch, dev)
    train_reference_phase(torch, dev)
    launches = {}

    def path(name, cfg, lengths, max_seq, want, chunk_want=None, **kw):
        counts, prefills, steps, chunk = serve_phase(
            torch, dev, cfg, lengths, max_seq, chunked=chunk_want is not None,
            **kw)
        _check_counts(counts, want(prefills, steps))
        for k, n in counts.items():
            launches.setdefault(k, {})[name] = n
        if chunk is not None:
            # the second chunk, at cache offset 200: every attention layer
            # through the flash kernel's q offset
            _check_counts(chunk, chunk_want)
            for k, n in chunk.items():
                launches[k][f"{name} chunked prefill"] = n
        gc.collect()
        torch.cuda.empty_cache()          # the next model's weights fit

    # phi3-mini: 32 attention layers
    phi3 = get_config(PHI3)
    path(PHI3, phi3, [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 32 * p, "decode_attention": 32 * s,
                       "rglru_scan": 0, "moe_gating": 0},
         chunk_want={"flash_attention": 32}, ladder_f32=437)
    # recurrentgemma-2b: 18 RG-LRU and 8 local-attention layers; the
    # 3000-token prompt is masked by the 2048 window and wraps the ring.
    # Bucketed: p = the 7 requests' passes + 9 warm-up passes (buckets
    # 16-4096); its f32 check pads 3000 tokens to 4096 past the ring
    path(RG, get_config(RG), [64, 512, 300, 137, 450, 64, 3000], 4096,
         lambda p, s: {"flash_attention": 8 * p, "decode_attention": 8 * s,
                       "rglru_scan": 18 * p, "moe_gating": 0},
         long_prompt=6, ladder_f32=3000)
    # llama4-maverick at full width, 1 layer of 48, bf16 weights; bucketed:
    # p = the 6 requests' passes + 7 warm-up passes (buckets 16-1024); no
    # f32 check (an f32 copy of its 128 experts is 64 GB)
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
    # its chunked prefill at full width on the canary stack (one mLSTM
    # and one sLSTM block, twice): with random weights the 48-block stack
    # moves its logits by ~6 when the embedding is scaled by 1 + 1e-7
    # (launch/probe_xlstm.py), so no two summation orders agree there
    canary = dataclasses.replace(get_config(XLSTM), groups=(
        LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),))
    weights = init_params(canary, torch.Generator(device=dev).manual_seed(0),
                          dev)
    chunk = chunked_prefill_phase(torch, dev, canary, weights, weights, 1024)
    _check_counts(chunk, {})
    ladder_f32_phase(torch, dev, canary, weights, 1024)
    for k, n in chunk.items():
        launches[k][f"{XLSTM} canary chunked prefill"] = n
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    # deepseek-v2 at full width, 2 layers of 60 (the dense first layer and
    # one MoE layer of 160 experts top-6 + 2 shared), f32 weights: MLA
    # attends at q/k 192, v 128; bucketed: p = the 6 requests' passes + 7
    # warm-up passes
    dsv2 = get_config(DSV2)
    dsv2 = dataclasses.replace(dsv2, groups=(
        dataclasses.replace(dsv2.groups[0], count=1),
        dataclasses.replace(dsv2.groups[1], count=1)))
    path(DSV2, dsv2, [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 2 * p, "decode_attention": 2 * s,
                       "rglru_scan": 0, "moe_gating": p + s},
         chunk_want={"flash_attention": 2, "moe_gating": 1}, ladder_f32=437)
    # qwen2-vl-7b: 28 attention layers (M-RoPE, GQA 28/4), f32, text
    # prompts as the reference's engine serves
    path(QWEN2VL, get_config(QWEN2VL), [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 28 * p, "decode_attention": 28 * s,
                       "rglru_scan": 0, "moe_gating": 0},
         chunk_want={"flash_attention": 28}, ladder_f32=437)
    # musicgen-large: 48 attention layers (MHA, D 64), f32, prompts of
    # stub EnCodec ids
    path(MUSICGEN, get_config(MUSICGEN), [64, 512, 300, 137, 450, 64], 1024,
         lambda p, s: {"flash_attention": 48 * p, "decode_attention": 48 * s,
                       "rglru_scan": 0, "moe_gating": 0}, ladder_f32=437)

    def trained(name, cfg, batch, seq, steps, per_step, cut="nothing cut"):
        counts = train_phase(torch, dev, cfg, batch=batch, seq=seq,
                             steps=steps, cut=cut)
        _check_counts(counts, {k: n * steps for k, n in per_step.items()})
        for k, n in counts.items():
            launches.setdefault(k, {})[f"{name} train"] = n
        step_ab(torch, dev, cfg, batch=batch, seq=seq, steps=steps)

    # minicpm-2b: 40 attention layers, each forward once and recomputed
    # once (remat full), one backward
    trained(MINICPM, get_config(MINICPM), 4, 1024, 6,
            {"flash_attention": 80, "flash_attention_bwd": 40})
    # recurrentgemma-2b: 18 RG-LRU and 8 local-attention layers
    trained(RG, get_config(RG), 1, 3072, 4,
            {"rglru_scan": 36, "rglru_scan_bwd": 18, "flash_attention": 16,
             "flash_attention_bwd": 8})
    # deepseek-v2 at full width cut to its first (dense) layer: MLA at q/k
    # 192, v 128, through the bf16 (3, 2) flash forward and backward; one
    # MoE layer's 3.8 G expert weights at 16 bytes a parameter do not fit
    # beside it
    dsv2 = get_config(DSV2)
    trained(DSV2, dataclasses.replace(dsv2, groups=(
        dataclasses.replace(dsv2.groups[0], count=1),)), 1, 2048, 4,
        {"flash_attention": 2, "flash_attention_bwd": 1},
        cut="cut to its first, dense layer of 60")
    # xlstm-1.3b at full width cut to its first super-block (7 mLSTM
    # and 1 sLSTM block of 48), f32, no kernel (the reference has none);
    # sLSTM is a loop over time.  At full depth the reference's init
    # overflows the f32 gradients (NaN) at S 512: the residual stream
    # reaches ~6e4 in the first super-block (launch/probe_xlstm.py)
    xlstm = get_config(XLSTM)
    trained(XLSTM, dataclasses.replace(xlstm, groups=(
        dataclasses.replace(xlstm.groups[0], count=1),)), 1, 512, 3, {},
        cut="cut to its first super-block, 8 of 48 blocks: at full depth "
            "the f32 gradients overflow (NaN) at this init")
    # qwen2-vl-7b cut to 4 of its 28 layers (7.6 G parameters at 16 bytes
    # do not fit), text tokens as the launcher feeds them
    qwen = get_config(QWEN2VL)
    trained(QWEN2VL, dataclasses.replace(qwen, groups=(
        dataclasses.replace(qwen.groups[0], count=4),)), 1, 1024, 4,
        {"flash_attention": 8, "flash_attention_bwd": 4},
        cut="cut to 4 of 28 layers")

    # the distributed layer at world size 1 (phase 7)
    dist = distributed_phase(torch, dev, card)
    for k, n in dist["pipeline"].items():
        launches[k][f"{PHI3} pipeline, 4 stages (world size 1)"] = n
    for k, n in dist["moe"].items():
        launches[k][f"{DSV2} expert-parallel MoE (world size 1)"] = n
    # the dry-run held against the card (phase 8)
    for k, by_path in prediction_phase(torch, dev, card).items():
        launches.setdefault(k, {}).update(by_path)
    # the paper's applications through the example twins (phase 9)
    for k, by_path in apps_phase(torch, dev, card).items():
        launches.setdefault(k, {}).update(by_path)

    # the f32 route's rows: the f32 paths of phases 4 and 5
    for path, counts in F32_PATHS.items():
        for k, n in counts.items():
            launches.setdefault(k, {})[path] = n
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
