"""The DeepSeek-V2 cell's files on the CPU: its plain reference against
the program at the file's tiny size with every published mechanism on
(prefill, then decode through the latent cache, against the reference's
full forward), the share of the experts against the uncut reference
layer, the weights' tree, the file's counts against the port's, the
frozen gating cost against the program's, and the cell's readers on a
known trace."""
import dataclasses

import pytest
import torch

from perfbench import costs, gating_cost, program, spec
from perfbench.harness import Run
from perfbench.reference import deepseek_v2 as ref
from perfbench.tests.test_perfbench_yardstick import _trace_doc
from perfbench.trace import Trace

BENCH = spec.load()
CELL = "deepseek-v2.serve.decode"
CPU = torch.device("cpu")


def _file() -> dict:
    return spec.cell(BENCH, CELL).config


def _tiny(**over) -> dict:
    c = _file()
    return {**c, **c["tiny"], "compute_dtype": "float32",
            "param_dtype": "float32", **over}


def _served(c: dict, cfg, seed: int = 2**33 + 7):
    """(the program's logits, the reference's) of a prefill of 70 tokens
    and 10 decode steps through the program's latent cache, f32."""
    from repro_torch.models import transformer
    params = ref.draw_params(c, seed, CPU, matmul_dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, c["vocab_size"], (1, 70), generator=g)
    caches = transformer.init_cache(cfg, 1, 96, dtype=torch.float32,
                                    device=CPU)
    logits, caches = transformer.prefill(cfg, params, prompt, caches)
    seq, got = prompt[0].tolist(), [logits[0]]
    for _ in range(10):
        tok = int(got[-1].argmax())
        seq.append(tok)
        lg, caches = transformer.decode_step(
            cfg, params, torch.tensor([tok]), caches)
        got.append(lg[0])
    return torch.stack(got), ref.logits(c, params, torch.tensor(seq))[69:]


def test_reference_matches_the_programs_prefill_and_decode():
    """Every new field on (16 experts in 4 groups, top 4 of the best 2,
    gates x2.5 unnormalised, 4 held, dropless; latent norms; YaRN whose
    correction range splits the tiny rope's frequencies), f32 compute:
    the program's prefill of 70 tokens and 10 decode steps through its
    latent cache against the reference's one forward pass, past the 64
    original positions YaRN stretches."""
    c = _tiny()
    got, want = _served(c, program.model_config(c))
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("kind, fault", [
    ("moe", {"routed_scale": 1.0}),
    ("moe", {"renormalize": True, "routed_scale": 1.0}),
    ("moe", {"topk_groups": 4}),
    ("moe", {"n_groups": 1, "topk_groups": 1}),
    ("mla", {"latent_norms": False}),
    ("mla", {"yarn_factor": 1.0}),
], ids=["gates_not_scaled", "gates_renormalised", "groups_not_limited",
        "no_groups", "no_latent_norms", "no_yarn"])
def test_a_program_that_drops_a_published_setting_departs(kind, fault):
    """The program run with one published setting dropped, the reference
    with the file's: the comparison above fails, by more than ten times
    its tolerance (at this size each departs by 30 times or more, the
    sound program by under a hundredth of it)."""
    c = _tiny()
    cfg = program.model_config(c)
    bad = dataclasses.replace(
        cfg, **{kind: dataclasses.replace(getattr(cfg, kind), **fault)})
    got, want = _served(c, bad)
    assert (got - want).abs().max() > 10 * (2e-4 + 1e-4 * want.abs().max())


def test_the_shares_of_the_experts_add_up_to_the_uncut_reference_layer():
    """Four chips each holding one group of 4 of the 16 experts (the
    program's layer, told which it holds): their routed parts, with the
    shared expert once, equal the reference's layer holding all 16."""
    from repro_torch.models import layers, moe
    whole = _tiny(moe=dict(_tiny()["moe"], experts_held=16))
    params = ref.draw_params(whole, 5, CPU, matmul_dtype=torch.float32)
    lw = next(w for f, w in ref.layers(whole, params) if f == "moe")["ffn"]
    n = torch.randn(23, whole["d_model"], generator=torch.Generator()
                    .manual_seed(8))
    want = ref.moe(whole, lw, n, "f32")
    cfg = program.model_config(_tiny())
    total = layers.ffn_forward(cfg, lw["shared"], n[None])[0]
    for s in range(4):
        # chip s holds group s: its experts first in its index order, the
        # groups' scores keeping their ranks
        perm = torch.cat([torch.arange(4 * s, 4 * s + 4),
                          torch.arange(0, 4 * s), torch.arange(4 * s + 4, 16)])
        held = {"router": lw["router"][:, perm],
                "experts": {k: w[4 * s:4 * s + 4]
                            for k, w in lw["experts"].items()}}
        part, _ = moe._moe_dropless(cfg, held, n[None], torch.float32)
        total = total + part[0]
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_the_weights_are_the_ports_tree_drawn_from_the_seed():
    from repro_torch.models import transformer
    c = _tiny()
    cfg = program.model_config(c)
    a = ref.draw_params(c, 2**40 + 1, CPU, matmul_dtype=torch.bfloat16)
    b = ref.draw_params(c, 2**40 + 1, CPU, matmul_dtype=torch.bfloat16)
    d = ref.draw_params(c, 2**40 + 2, CPU, matmul_dtype=torch.bfloat16)
    meta = transformer.param_specs(cfg)

    def paths(tree, pre=()):
        if isinstance(tree, dict):
            return [p for k, v in tree.items() for p in paths(v, pre + (k,))]
        if isinstance(tree, list):
            return [p for i, v in enumerate(tree)
                    for p in paths(v, pre + (i,))]
        return [pre]
    assert sorted(map(str, paths(a))) == sorted(map(str, paths(meta)))
    for p in paths(a):
        assert ref.get(a, p).shape == ref.get(meta, p).shape, p
        assert torch.equal(ref.get(a, p), ref.get(b, p))
        if ref.get(a, p).abs().sum() > 0:
            assert not torch.equal(ref.get(a, p), ref.get(d, p))
    experts = a["groups"][1]["sub0"]["ffn"]["experts"]["w_gate"]
    assert experts.shape == (2, 4, 64, 32)        # held experts only


def test_the_fp8_control_departs_from_the_reference():
    c = dict(_file(), **_file()["tiny"])
    params = ref.draw_params(c, 2, CPU, matmul_dtype=torch.bfloat16)
    ids = torch.randint(0, c["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(0))
    gap = (ref.logits(c, params, ids)
           - ref.logits(c, params, ids, mode="fp8")).abs().max()
    assert 0.02 < gap < 5.0


def test_the_files_counts_equal_the_ports():
    c = _file()
    cfg = program.model_config(c)
    assert cfg.moe.held == 20 and cfg.n_layers == 30
    assert costs.param_count(c) == cfg.param_count()
    assert costs.param_count(c, active=True) == cfg.active_param_count()
    # the held share: 6 · 20 / 160 of a token's routed experts
    expert = 3 * c["d_model"] * c["moe"]["d_ff_expert"]
    whole = dict(c, moe={k: v for k, v in c["moe"].items()
                         if k != "experts_held"})
    assert costs.param_count(whole, active=True) \
        - costs.param_count(c, active=True) == 29 * expert * 6 * 140 // 160
    # the published numbers at the top level but the experts held here
    # (BENCHMARK.json's reduced); the router keeps the published width
    source = c["source_keys"]
    assert {k for k, v in source.items() if c[k] != v} == \
        {"n_routed_experts"}
    entry = next(x for x in BENCH["configs"] if x["name"] ==
                 spec.cell(BENCH, CELL).config_name)
    assert entry["reduced"] == c["reduced"] == ["n_routed_experts"]
    assert c["n_routed_experts"] == c["moe"]["experts_held"] == 20
    assert c["moe"]["n_experts"] == source["n_routed_experts"] == 160


def test_the_published_yarn_and_routing_are_the_files():
    c = _file()
    m, e, rs = c["mla"], c["moe"], c["source_keys"]["rope_scaling"]
    assert (m["yarn_factor"], m["yarn_original_max"], m["yarn_beta_fast"],
            m["yarn_beta_slow"], m["yarn_mscale"],
            m["yarn_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"], rs["mscale_all_dim"])
    assert ref.softmax_scale(m) == pytest.approx(0.114722, abs=1e-6)
    s = c["source_keys"]
    assert (e["n_groups"], e["topk_groups"], e["routed_scale"],
            e["renormalize"], e["top_k"], e["n_shared"]) == (
        s["n_group"], s["topk_group"], s["routed_scaling_factor"],
        s["norm_topk_prob"], s["num_experts_per_tok"], s["n_shared_experts"])
    assert c["norm_eps"] == s["rms_norm_eps"]


@pytest.mark.parametrize("T,E,k,G,kg,dropless", [
    (1, 160, 6, 8, 3, True), (1024, 160, 6, 8, 3, True),
    (8192, 160, 6, 8, 3, False), (512, 128, 1, 1, 1, False),
    (37, 16, 4, 4, 2, True)])
def test_the_frozen_gating_cost_equals_the_programs(T, E, k, G, kg,
                                                    dropless):
    from repro_torch.kernels.moe_gating.ops import moe_gating_cost
    logits = torch.empty((T, E), dtype=torch.float32, device="meta")
    assert gating_cost.moe_gating_cost(
        T, E, k, n_groups=G, topk_groups=kg, dropless=dropless) == \
        moe_gating_cost(logits, k, 0 if dropless else 8, G, kg,
                        dropless=dropless)


def test_the_cells_readers_on_a_known_trace():
    base = 1_000_000_000_000
    # a decode step at position 99 (one decode kernel of 10 µs, one
    # gating kernel of 5 µs) and a prefill of a 100-token prompt in a
    # bucket of 128 (one gating kernel of 20 µs)
    spans = [("decode", base + 1_000_000, base + 1_050_000, {"pos": 99}),
             ("prefill", base + 2_000_000, base + 2_500_000,
              {"length": 100, "chunks": [128]})]
    doc = _trace_doc(base, [
        ("void (anonymous namespace)::decode_kernel<bf16>(Params)", 1100, 10,
         1),
        ("void (anonymous namespace)::gating_kernel<8>(float const*)", 1120,
         5, 1),
        ("void (anonymous namespace)::gating_kernel<8>(float const*)", 2100,
         20, 2)], [(1, 1010), (2, 2010)])
    t = Trace(doc, base + 1_000_000, base + 3_000_000, spans)
    c = _file()
    run = Run(CELL, c, {}, t, {})
    share = spec.metric_reader("mla_decode_attn_roofline.dsv2")(run)
    bound = 30 * costs.bound_seconds(*costs.decode_attention_cost(
        1, 8192, 128, 128, 192, 128, rows=100))
    assert share == pytest.approx(100 * bound / 10e-6)
    gating = spec.metric_reader("moe_gating_roofline.dsv2")(run)
    bounds = [29 * costs.bound_seconds(*gating_cost.moe_gating_cost(
        T, 160, 6, n_groups=8, topk_groups=3, dropless=True))
        for T in (1, 128)]
    assert gating == pytest.approx(100 * sum(bounds) / 25e-6)
    assert spec.metric_reader("decode_device_ms_per_token.decode")(run) == \
        pytest.approx(0.015)
    assert spec.metric_reader("serve_mfu.decode")(run) is None
    run.counters = {"untraced_flops": 989e12, "untraced_s": 4.0}
    assert spec.metric_reader("serve_mfu.decode")(run) == pytest.approx(25)
    # a run with no trace reads nothing, and raises nothing
    empty = Run(CELL, c, {}, None, {})
    for name in ("mla_decode_attn_roofline.dsv2", "moe_gating_roofline.dsv2",
                 "decode_device_ms_per_token.decode"):
        assert spec.metric_reader(name)(empty) is None


def test_the_traffic_fits_the_slots_caches():
    """The longest prompt with the longest answer fits a slot's cache, so
    the engine turns no request away."""
    mix = spec.cell(BENCH, CELL).traffic
    assert mix["prompt"]["max"] + mix["output"]["max"] \
        <= _file()["serve"]["max_seq"]
