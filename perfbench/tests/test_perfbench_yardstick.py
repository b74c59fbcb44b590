"""The generator, the statistics, the frozen cost formulas and the
metric readers' arithmetic, on the CPU."""
import math
import statistics

import numpy as np
import pytest
import torch

from perfbench import costs, spec, stats, traffic
from perfbench.trace import Trace, union_us

MIX = {"prompt": {"dist": "lognormal", "median": 256, "sigma": 0.6,
                  "min": 32, "max": 1024},
       "output": {"dist": "uniform", "min": 256, "max": 1024},
       "rate_per_s": 4.0, "pool": 64, "trace_seed": 1}
SEEDS = [0, 7, 2**31 + 5, 3 * 2**40 + 11, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_traffic_is_the_same_for_the_same_seed(seed):
    a = traffic.open_loop(MIX, 30, seed, 32064)
    b = traffic.open_loop(MIX, 30, seed, 32064)
    assert [(r.due, r.max_new, r.prompt.tolist()) for r in a] == \
        [(r.due, r.max_new, r.prompt.tolist()) for r in b]
    job = {"batch": 2, "seq": 16}
    x = traffic.Batches(job, seed, 100).batch(3, 2, 16)
    y = traffic.Batches(job, seed, 100).batch(3, 2, 16)
    assert all((x[k] == y[k]).all() for k in x)


def test_every_seed_gets_the_same_sizes_and_gaps_in_its_own_order():
    # every seed replays the one schedule the mix's trace_seed draws:
    # the same sizes and arrivals in the same order, other token ids
    runs = [traffic.open_loop(MIX, 30, s, 32064) for s in SEEDS]
    plans = {tuple((len(r.prompt), r.max_new, r.due) for r in run)
             for run in runs}
    assert len(plans) == 1
    assert len({run[0].prompt.tobytes() for run in runs}) == len(SEEDS)
    run = runs[0]
    due = [r.due for r in run]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 30
    assert all(32 <= len(r.prompt) <= 1024 and 256 <= r.max_new <= 1024
               for r in run)
    # another trace_seed is another schedule
    other = traffic.open_loop(dict(MIX, trace_seed=2), 30, SEEDS[0], 32064)
    assert [r.due for r in other] != due


def test_every_seed_replays_one_schedule_from_its_own_block():
    # i.i.d. draws, not quantiles: log-normal prompts with their median
    # and their clipped tail, uniform answers, Poisson arrivals (mean gap
    # 1 / rate, exponential: its standard deviation the mean)
    mix = dict(MIX, pool=20000)
    pool = traffic.closed_pool(mix, 3, 100)
    lengths = np.array([len(r.prompt) for r in pool])
    assert statistics.median(lengths) == pytest.approx(256, rel=0.03)
    assert (lengths == 1024).mean() == pytest.approx(0.0105, abs=0.003)
    assert (lengths == 32).mean() == pytest.approx(0.0003, abs=0.0003)
    outs = np.array([r.max_new for r in pool])
    assert outs.min() == 256 and outs.max() == 1024
    assert outs.mean() == pytest.approx(640, rel=0.02)
    assert len(set(lengths[:64].tolist())) > 40
    gaps = np.diff(traffic.arrivals(MIX, 5000.0), prepend=0.0)
    assert gaps.mean() == pytest.approx(0.25, rel=0.03)
    assert gaps.std() == pytest.approx(0.25, rel=0.05)
    # each part from a stream of its own: a longer window or pool keeps
    # the first requests, and another rate scales the same arrivals
    short = traffic.closed_pool(dict(MIX, pool=8), 3, 100)
    assert [(len(r.prompt), r.max_new) for r in short] == \
        [(len(r.prompt), r.max_new) for r in pool[:8]]
    t4 = traffic.arrivals(MIX, 30.0)
    t8 = traffic.arrivals(dict(MIX, rate_per_s=8.0), 30.0)
    assert t8[:len(t4) // 2] == pytest.approx(t4[:len(t4) // 2] / 2)
    assert traffic.arrivals(MIX, 60.0)[:len(t4)] == pytest.approx(t4)


def test_batches_rows_differ_and_the_half_batch_fault_masks_half():
    job = {"batch": 8, "seq": 64}
    b = traffic.Batches(job, 5, 1000)
    s0, s1 = b.batch_at(0), b.batch_at(1)
    assert not (s0["tokens"] == s1["tokens"]).all()
    assert len({r.tobytes() for r in s0["tokens"]}) == 8
    assert (s0["labels"][:, :-1] == s0["tokens"][:, 1:]).all()
    half = traffic.Batches(job, 5, 1000, fault="half_batch").batch_at(0)
    assert (half["labels"][4:] == -100).all()
    assert (half["labels"][:4] == s0["labels"][:4]).all()


def test_the_check_sample_holds_the_longest_and_meets_its_budget():
    pool = [(i, 10, n) for i, n in enumerate([5, 300, 40, 40, 40, 2])]
    out = traffic.check_sample(pool, 9, max_requests=3, min_tokens=350)
    assert out[0] == (1, 10, 300) and len(out) == 3
    out = traffic.check_sample(pool, 9, max_requests=6, min_tokens=100)
    assert out[0] == (1, 10, 300) and len(out) == 1
    assert traffic.check_sample([], 9, max_requests=3, min_tokens=1) == []


def test_percentiles_and_rates_take_every_sample_and_the_whole_window():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(xs[::-1], 50) == 50
    # a request that never got a token is a sample too, and the worst
    assert stats.percentile([0.1] * 9 + [math.inf], 95) == math.inf
    assert stats.percentile([0.1] * 19 + [math.inf], 90) == 0.1
    assert stats.rate(120, 30.0) == 4.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    with pytest.raises(ValueError):
        stats.percentile([], 50)
    assert stats.lateness_p95([0, 1, 2], [0.5, 1.0, 2.25]) == 0.5


def _port_formulas():
    from repro_torch.kernels.decode_attention.ops import decode_attention_cost
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cost, flash_attention_cost)
    return flash_attention_cost, flash_attention_bwd_cost, \
        decode_attention_cost


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,off,dtype", [
    (1, 512, 512, 32, 32, 96, 0, torch.bfloat16),
    (1, 64, 1088, 32, 32, 96, 1024, torch.bfloat16),
    (2, 128, 128, 8, 2, 64, 0, torch.float32),
    (4, 1024, 1024, 36, 36, 64, 0, torch.bfloat16),
])
def test_the_frozen_costs_equal_the_programs(B, Sq, Sk, H, K, D, off, dtype):
    fwd, bwd, dec = _port_formulas()
    meta = dict(device="meta", dtype=dtype)
    q = torch.empty(B, Sq, H, D, **meta)
    k = torch.empty(B, Sk, K, D, **meta)
    e = torch.empty((), dtype=dtype).element_size()
    assert costs.flash_attention_cost(B, Sq, Sk, H, K, D, D, elem=e,
                                      q_offset=off) == \
        fwd(q, k, k, q_offset=off)
    assert costs.flash_attention_cost(B, Sq, Sk, H, K, D, D, elem=e,
                                      with_lse=True) == \
        fwd(q, k, k, with_lse=True)
    if Sq == Sk:
        assert costs.flash_attention_bwd_cost(B, Sq, H, K, D, D, elem=e) == \
            bwd(q, k, k, q, q, None)
    qd = torch.empty(B, H, D, **meta)
    vl = torch.empty(B, dtype=torch.int32, device="meta")
    rows = B * min(Sk, off + 1)
    assert costs.decode_attention_cost(B, Sk, H, K, D, D, rows=rows,
                                       elem=e) == dec(qd, k, k, vl, rows=rows)


@pytest.mark.parametrize("name,B,S", [("phi3-mini-3.8b", 2, 256),
                                      ("minicpm-2b", 1, 4096),
                                      ("minicpm-2b", 8, 512)])
def test_the_frozen_model_flops_equal_chip_smokes(name, B, S):
    import chip_smoke
    from repro_torch.configs import get_config
    c = spec.cell(spec.load(), next(
        w["name"] for w in spec.load()["workloads"]
        if w["config"] == name)).config
    cfg = get_config(c["arch"])
    n_matmul = cfg.param_count() - (0 if cfg.tie_embeddings
                                    else cfg.vocab_size * cfg.d_model)
    assert costs.param_count(c) == cfg.param_count()
    assert costs.train_step_flops(c, B, S) == \
        chip_smoke._model_flops(cfg, B, S, n_matmul)[0]
    assert costs.mixer_flops(c, B, S) == chip_smoke._mixer_flops(cfg, B, S)[0]


def test_roofline_and_mfu_arithmetic_on_known_counts():
    # bytes-bound: 3.35e9 bytes take 1 ms; FLOP-bound: 989e9 FLOPs 1 ms
    assert costs.bound_seconds(1.0, 3.35e9) == pytest.approx(1e-3)
    assert costs.bound_seconds(989e9, 1.0) == pytest.approx(1e-3)
    c = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 16, "vocab_size": 10, "n_layers": 3,
         "tie_embeddings": False}
    per_layer = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    assert costs.layer_matmul_params(c) == per_layer
    # a token at position 5 sees 6 keys: 2·H·(hd + hd)·6 a layer
    assert costs.forward_token_flops(c, 5, head=False) == \
        3 * (2 * per_layer + 2 * 2 * 8 * 6)
    assert costs.forward_token_flops(c, 5, head=True) == \
        costs.forward_token_flops(c, 5, head=False) + 2 * 8 * 10
    assert costs.prompt_flops(c, 4) == sum(
        costs.forward_token_flops(c, p, head=False) for p in range(4)) \
        + 2 * 8 * 10


def _trace_doc(base_ns, kernels, launches):
    ev = [{"cat": "kernel", "name": n, "ts": ts, "dur": d,
           "args": {"correlation": corr}} for n, ts, d, corr in kernels]
    ev += [{"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts,
            "dur": 1, "args": {"correlation": corr}} for corr, ts in launches]
    return {"baseTimeNanoseconds": base_ns, "traceEvents": ev}


def test_the_readers_on_a_known_trace():
    base = 1_000_000_000_000
    # two decode steps at positions 99 and 199 (spans in wall-clock ns),
    # each a graph launch of one decode kernel of 10 µs and one GEMV of
    # 90 µs; an idle gap of 800 µs between them
    spans = [("decode", base + 1_000_000, base + 1_050_000, {"pos": 99}),
             ("decode", base + 2_000_000, base + 2_050_000, {"pos": 199}),
             ("client", base + 1_100_000, base + 1_990_000, {})]
    doc = _trace_doc(base, [
        ("(anonymous namespace)::decode_kernel(Params)", 1100, 10, 1),
        ("gemv", 1110, 90, 1),
        ("(anonymous namespace)::decode_kernel(Params)", 2010, 10, 2),
        ("gemv", 2020, 90, 2)], [(1, 1010), (2, 2010)])
    t = Trace(doc, base + 1_000_000, base + 3_000_000, spans)
    assert t.window_s == pytest.approx(2e-3)
    assert t.busy_s() == pytest.approx(200e-6)
    c = {"n_layers": 1, "n_heads": 2, "n_kv_heads": 2, "head_dim": 4,
         "d_model": 8, "d_ff": 16, "vocab_size": 10, "tie_embeddings": False,
         "serve": {"max_seq": 256}}
    from perfbench.harness import Run
    run = Run("x.decode", c, {}, t, {})
    ms = spec.metric_reader("decode_device_ms_per_token.decode")(run)
    assert ms == pytest.approx(0.1)
    bound = sum(costs.bound_seconds(*costs.decode_attention_cost(
        1, 256, 2, 2, 4, 4, rows=p + 1)) for p in (99, 199))
    share = spec.metric_reader("decode_attn_roofline.decode")(run)
    assert share == pytest.approx(100 * bound / 20e-6)
    idle = spec.metric_reader("device_idle.train")(run)
    assert idle == pytest.approx(90.0)
    gaps = dict(t.idle_gaps())
    assert gaps["client"] == pytest.approx(810e-6)
    assert sum(gaps.values()) == pytest.approx(1.8e-3)
    assert spec.metric_reader("serve_mfu.decode")(run) is None
    run.counters = {"untraced_flops": 989e12, "untraced_s": 2.0}
    assert spec.metric_reader("serve_mfu.decode")(run) == pytest.approx(50)
    assert spec.metric_reader("flash_fwd_roofline.prompt")(run) is None
    assert t.device_ops()[0] == ["gemv", pytest.approx(180e-6)]
    assert union_us(np.array([0.0, 5, 20]), np.array([10.0, 8, 25])) == 15


def test_the_train_mfu_reader_takes_the_untraced_steps():
    from perfbench.harness import Run
    c = spec.cell(spec.load(), "minicpm.train.s4096")
    flops = costs.train_step_flops(c.config, 1, 4096)
    run = Run("t", c.config, c.traffic, None,
              {"untraced_steps": 10, "untraced_s": 10 * flops / 989e12 * 4})
    assert spec.metric_reader("train_mfu")(run) == pytest.approx(25)


def test_the_chunk_counter_reader():
    from perfbench.harness import Run
    read = spec.metric_reader("ladder_chunks_per_prompt.prompt")
    assert read(Run("p", {}, {}, None, {"prefills": 4, "replays": 18})) \
        == 4.5
    assert read(Run("p", {}, {}, None, {"prefills": None,
                                         "replays": None})) is None


def test_the_check_holds_compared_numbers_and_reports_the_rest():
    from perfbench import check
    # every number is held: one with no limit, or with any other entry,
    # is beside None and fails
    limits = {"a": {"limit": 1.0}, "b": {"compared": False, "lower": 2.0}}
    checks = check.hold({"a": 0.5, "b": 3.0, "c": 0.1}, limits)
    assert checks == {"a": (0.5, 1.0), "b": (3.0, None), "c": (0.1, None)}
    assert not check.within(checks)
    assert check.within({"a": (0.5, 1.0)})
    assert not check.within({"a": (math.inf, 1.0)})
    assert not check.within({})
    # the worst leaf, over the larger of its norm and the median leaf's;
    # a leaf whose reference gradient is nought to rounding is left out
    assert check.norm_gaps([1.1, 2.0, 5.0], [1.0, 2.0, 4.0],
                           [1.0, 1e-9, 1.0]) == pytest.approx([0.05, 0.25])
    assert check.norm_gaps([0.0, 2.0, 4.0], [1.0, 2.0, 4.0],
                           [1.0, 1.0, 1.0]) == pytest.approx([0.5, 0, 0])
    nums = check.trained(
        {"losses": [1.0, 2.2], "grad_norms": [0.0, 2.0, 4.0],
         "delta_norms": [1.0, 1.0, 1.0]},
        {"losses": [1.0, 2.0], "grad_norms": [1.0, 2.0, 4.0],
         "delta_norms": [1.0, 1.0, 2.0]})
    assert nums == pytest.approx({"loss_gap": 0.1, "grad_norm_gap": 0.5,
                                  "delta_norm_gap": 0.5})
