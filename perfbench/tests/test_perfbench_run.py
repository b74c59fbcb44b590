"""Whole runs of each kind of cell on the CPU at a tiny size, with the
harness's look for a card skipped: the result's fields, a sound run
coming out correct, each fault the comparison must catch coming out not
correct, and the import check; the command itself refusing to measure
without a card.  One test runs a short cell on the card."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, program, spec
from perfbench.tests.conftest import ROOT

BENCH = spec.load()
#: the tiny size of a dense configuration; a file's ``tiny`` takes its place
SMALL = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=256)
TINY_TRAFFIC = {
    "closed_loop": dict(clients=4, pool=16, warmup_prompt=8,
                        prompt=dict(dist="lognormal", median=16, sigma=0.6,
                                    min=4, max=40),
                        output=dict(dist="uniform", min=8, max=40),
                        check=dict(max_requests=3, min_tokens=40)),
    "open_loop": dict(rate_per_s=12.0, warmup_prompt=8, drain_s=30,
                      prompt=dict(dist="lognormal", median=30, sigma=0.6,
                                  min=8, max=80),
                      output=dict(dist="uniform", min=2, max=6),
                      check=dict(max_requests=8, min_tokens=30)),
    "train": dict(batch=2, seq=16),
}
#: the tiny runs' own limits, set as a cell's are: above the sound runs'
#: largest reading and under the fp8 control's smallest, over seeds
#: 2**31 + 9, 5, 77 and 1234567 on the CPU (logit gap 0.020 / 0.14; loss
#: 1.1e-4 / 5.3e-4; the gradient and the change are held too)
TINY_LIMITS = {"widest_logit_gap": {"limit": 0.05},
               "loss_gap": {"limit": 3e-4}, "grad_norm_gap": {"limit": 7e-3},
               "delta_norm_gap": {"limit": 2.5e-3}}


def tiny(workload: str, **over) -> spec.Cell:
    cell = spec.cell(BENCH, workload)
    c = {**cell.config, **cell.config.get("tiny", SMALL)}
    if "serve" in c:
        c["serve"] = dict(c["serve"], slots=2, max_seq=128)
    t = {**cell.traffic, **TINY_TRAFFIC[cell.traffic["kind"]], **over}
    return dataclasses.replace(cell, config=c, traffic=t,
                               limits=TINY_LIMITS)


def run(cell, seed=2**31 + 9, seconds=1.0, **kw) -> dict:
    ctx = harness.Ctx(cell, seed, seconds, False, torch.device("cpu"),
                      time.monotonic(), log=lambda *a: None, **kw)
    return harness.run_cell(ctx)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_tiny_run_is_correct_and_has_every_field(workload):
    out = run(tiny(workload))
    assert out["correct"] is True, out["check"]
    assert list(out)[-2:] == ["check", "readings"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   spec.cell(BENCH, workload).end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 1


@pytest.mark.parametrize("fault", ["token", "stale_cache"])
def test_a_serving_fault_makes_the_run_not_correct(fault, monkeypatch):
    cell = tiny("phi3.serve.decode")
    if fault == "stale_cache":
        # the decode step returns its cache unchanged: the step runs on a
        # copy of it, so the new key and value rows are lost
        from repro_torch.models import transformer
        real = transformer.decode_step

        def stale(cfg, params, token, caches, pos=None):
            copy = [{k: {n: (t.clone() if isinstance(t, torch.Tensor)
                             else t) for n, t in sub.items()}
                     for k, sub in gc.items()} for gc in caches]
            logits, _ = real(cfg, params, token, copy, pos)
            for gc in caches:
                for sub in gc.values():
                    sub["length"] = sub["length"] + 1
            return logits, caches
        monkeypatch.setattr(transformer, "decode_step", stale)
    else:
        # decoded tokens altered where they are produced: every 7th
        # decode step's logits put another token first (7 is prime to
        # the slot count, so every slot's requests get altered tokens,
        # whichever the comparison samples)
        from repro_torch.models import transformer
        real, calls = transformer.decode_step, []

        def altered(cfg, params, token, caches, pos=None):
            logits, caches = real(cfg, params, token, caches, pos)
            calls.append(1)
            if len(calls) % 7 == 0:
                logits = logits.clone()
                best = logits[0].argmax()
                logits[0, (best + 1) % logits.shape[1]] = logits[0, best] + 1
            return logits, caches
        monkeypatch.setattr(transformer, "decode_step", altered)
    out = run(cell)
    assert out["correct"] is False
    assert out["check"]["widest_logit_gap"]["value"] > 0.05


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_a_training_fault_makes_the_run_not_correct(fault, monkeypatch):
    cell = tiny("minicpm.train.s4096")
    if fault == "unchanged_state":
        real = program.train_step

        def frozen(c, cfg, state, device):
            step = real(c, cfg, state, device)

            def no_update(st, batch):
                saved = [t.clone() for t in _leaves(st)]
                st, metrics = step(st, batch)
                with torch.no_grad():
                    for t, s in zip(_leaves(st), saved):
                        t.copy_(s)
                return st, metrics
            return no_update
        monkeypatch.setattr(program, "train_step", frozen)
        out = run(cell)
    else:
        out = run(cell, fault="half_batch")
    assert out["correct"] is False
    bad = {k for k, v in out["check"].items() if v["value"] > v["limit"]}
    assert bad, out["check"]


def _leaves(state):
    from repro_torch.training.optimizer import leaves
    return leaves(state["params"]) + leaves(state["opt"]["m"]) \
        + leaves(state["opt"]["v"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_fp8_control_is_not_correct_at_the_tiny_size(workload):
    # the control stands in the program's place: the harness, not a look
    # at its readings, finds it not correct
    out = run(tiny(workload), control=True)
    assert out["correct"] is False, out["check"]
    assert any(v["value"] > v["limit"] for v in out["check"].values())
    sound = run(tiny(workload))
    assert sound["correct"] is True, sound["check"]


def test_the_import_check_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.models", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["repro.models"]) == ["repro"]
    assert harness.forbidden_modules(["jax._src.core", "flax"]) == \
        ["flax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, time, torch\n"
            "from perfbench.tests.test_perfbench_run import tiny, run\n"
            "from perfbench import harness\n"
            "run(tiny('phi3.serve.prompt'), seconds=0.5)\n"
            "run(tiny('minicpm.train.s512'), seconds=0.5)\n"
            "print('FORBIDDEN', harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_the_command_refuses_to_measure_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "phi3.serve.decode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "needs 1 CUDA device" in p.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode there")


@pytest.mark.cuda
def test_a_short_decode_run_on_the_card_is_correct(card):
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "phi3.serve.decode", "--seed", "77", "--seconds",
                        "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
