"""A configuration file describes the layer stack: the port's config that
``program.model_config`` builds from it and the FLOPs ``costs`` counts
for it, on the CPU.  The two dense files of the benchmark give the
config and the integers they gave before the files could declare a
stack (pinned below); a test file writes deepseek-v2-236b's MLA and MoE
stack at published widths."""
import dataclasses
import json

import pytest

from perfbench import costs, program, spec
from perfbench.tests import test_perfbench_run

CONFIGS = spec.HERE / "configs"
DEEPSEEK = spec.HERE / "tests" / "data" / "deepseek-v2-236b.json"


def _file(path) -> dict:
    return json.loads(path.read_text())


def _port(arch: str, **over):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **over)


def _dense(arch, d, L, H, hd, f, V, tied):
    from repro_torch.configs.base import LayerGroup
    return _port(arch, d_model=d, n_heads=H, n_kv_heads=H, d_ff=f,
                 vocab_size=V, head_dim=hd, rope_theta=10000.0, norm_eps=1e-5,
                 tie_embeddings=tied, compute_dtype="bfloat16",
                 param_dtype="float32",
                 groups=(LayerGroup(pattern=("attn",), count=L, ffn="dense"),))


#: the config each dense file built before it could declare a stack
DENSE = {"phi3-mini-3.8b": ("phi3-mini-3.8b", 3072, 32, 32, 96, 8192, 32064,
                            False),
         "minicpm-2b": ("minicpm-2b", 2304, 40, 36, 64, 5760, 122753, True)}

#: the integers each ``costs`` function gave for the dense files before
#: they could declare a stack: mixer and train-step FLOPs by (batch,
#: seq), a token's by (position, head), a prompt's by length
PINNED = {
    "phi3-mini-3.8b": {
        "layer_matmul_params": 113246208,
        "param_count": 3821079552,
        "mixer_flops": {(1, 4096): 9898020569088, (8, 512): 1239366500352,
                        (2, 256): 77611401216, (1, 1): 1179648},
        "train_step_flops": {(1, 4096): 101384120696832,
                             (8, 512): 92725466628096,
                             (2, 256): 11513373917184, (1, 1): 22336653312},
        "forward_token_flops": {
            (0, False): 7248150528, (0, True): 7445151744,
            (1, False): 7248543744, (1, True): 7445544960,
            (255, False): 7348420608, (255, True): 7545421824,
            (1023, False): 7650410496, (1023, True): 7847411712,
            (4095, False): 8858370048, (4095, True): 9055371264},
        "prompt_flops": {1: 7445151744, 32: 232332853248,
                         256: 1868558106624, 1024: 7628260245504,
                         3584: 28502304620544, 4096: 32986351140864},
    },
    "minicpm-2b": {
        "layer_matmul_params": 61046784,
        "param_count": 2724880896,
        "mixer_flops": {(1, 4096): 9279394283520, (8, 512): 1161906094080,
                        (2, 256): 72760688640, (1, 1): 1105920},
        "train_step_flops": {(1, 4096): 76246067183616,
                             (8, 512): 68128578994176,
                             (2, 256): 8443594801152, (1, 1): 16350391296},
        "forward_token_flops": {
            (0, False): 4884111360, (0, True): 5449757184,
            (1, False): 4884480000, (1, True): 5450125824,
            (255, False): 4978114560, (255, True): 5543760384,
            (1023, False): 5261230080, (1023, True): 5826875904,
            (4095, False): 6393692160, (4095, True): 6959337984},
        "prompt_flops": {1: 5449757184, 32: 157040054784,
                         256: 1262930563584, 1024: 5194980463104,
                         3584: 19872160879104, 4096: 23097507254784},
    },
}


@pytest.mark.parametrize("name", sorted(DENSE))
def test_a_dense_file_builds_the_config_it_built_before(name):
    c = _file(CONFIGS / f"{name}.json")
    assert "layers" not in c
    assert program.model_config(c) == _dense(*DENSE[name])


@pytest.mark.parametrize("name,fn", [(n, f) for n in sorted(PINNED)
                                     for f in PINNED[n]])
def test_a_dense_file_costs_the_integers_it_cost_before(name, fn):
    c = _file(CONFIGS / f"{name}.json")
    want = PINNED[name][fn]
    if not isinstance(want, dict):
        got = getattr(costs, fn)(c)
        assert got == want and type(got) is int
        return
    for args, value in want.items():
        if fn == "forward_token_flops":
            got = costs.forward_token_flops(c, args[0], head=args[1])
        else:
            got = getattr(costs, fn)(c, *(args if isinstance(args, tuple)
                                          else (args,)))
        assert got == value and type(got) is int, (args, got, value)


def test_a_file_with_mla_and_moe_groups_builds_the_ports_deepseek_v2():
    from repro_torch.configs.base import reduced
    c = _file(DEEPSEEK)
    dtypes = dict(compute_dtype=c["compute_dtype"],
                  param_dtype=c["param_dtype"])
    cfg = program.model_config(c)
    assert cfg == _port("deepseek-v2-236b", **dtypes)
    assert [g.ffn for g in cfg.groups] == ["dense", "moe"]
    # its tiny size is the port's own smoke-test cut of the model
    assert program.model_config({**c, **c["tiny"]}) == dataclasses.replace(
        reduced(cfg), **dtypes)


@pytest.mark.parametrize("B,S", [(1, 4096), (8, 512), (2, 37)])
def test_the_deepseek_v2_file_costs_what_the_port_and_the_smoke_count(B, S):
    import chip_smoke
    c = _file(DEEPSEEK)
    cfg = program.model_config(c)
    assert costs.param_count(c) == cfg.param_count()
    assert costs.param_count(c, active=True) == cfg.active_param_count()
    assert costs.mixer_flops(c, B, S) == chip_smoke._mixer_flops(cfg, B, S)[0]
    # a token's matmul FLOPs with every expert held: 2 per active
    # parameter but the embedding, the head and the norm scales
    d, V, L, H = cfg.d_model, cfg.vocab_size, cfg.n_layers, cfg.n_heads
    norms = sum(g.count * (d + d) for g in cfg.groups) + d
    matmul = 2 * (cfg.active_param_count() - 2 * V * d - norms)
    m = cfg.mla
    attention = L * 2 * H * (m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim) \
        * (S + 1)
    assert costs.forward_token_flops(c, S, head=False) == matmul + attention
    assert costs.forward_token_flops(c, S, head=True) == \
        matmul + attention + 2 * d * V


def test_a_chip_that_holds_a_share_of_the_experts_counts_its_routed_work():
    # 20 of 160 experts here (an 8-way expert-parallel layer): a token's
    # expected routed work on this chip is 6 · 20 / 160 experts a layer
    c = _file(DEEPSEEK)
    share = dict(c, moe=dict(c["moe"], experts_held=20))
    expert = 3 * c["d_model"] * c["moe"]["d_ff_expert"]
    assert costs.ffn_params(share, "moe", active=True) == \
        costs.ffn_params(c, "moe", active=True) - expert * 6 * 140 // 160
    assert costs.forward_token_flops(c, 99, head=True) - \
        costs.forward_token_flops(share, 99, head=True) == \
        59 * 2 * expert * 6 * 140 // 160
    assert costs.param_count(share) == costs.param_count(c)


@pytest.mark.parametrize("kind", ["slstm", "rglru", "mlstm", "attn_local"])
def test_a_mixer_no_formula_counts_is_refused_by_name(kind):
    c = _file(CONFIGS / "phi3-mini-3.8b.json")
    c["layers"] = [{"pattern": ["attn"], "count": 2, "ffn": "dense"},
                   {"pattern": [kind, "attn"], "count": 15, "ffn": "dense"}]
    with pytest.raises(ValueError, match=f"layer group 1 .*'{kind}'"):
        program.model_config(c)
    with pytest.raises(ValueError, match=kind):
        costs.prompt_flops(c, 16)


def test_a_stack_that_is_not_n_layers_or_lacks_a_counted_key_is_refused():
    c = _file(DEEPSEEK)
    with pytest.raises(ValueError, match="n_layers 61"):
        program.model_config(dict(c, n_layers=61))
    mla = {k: v for k, v in c["mla"].items() if k != "q_lora_rank"}
    with pytest.raises(ValueError, match=r"mla\.q_lora_rank"):
        program.model_config(dict(c, mla=mla))
    layers = [c["layers"][0], dict(c["layers"][1], ffn=["moe", "dense"])]
    with pytest.raises(ValueError, match="2 feed-forwards for 1 mixers"):
        program.model_config(dict(c, layers=layers))


def test_a_key_the_port_lacks_raises_the_ports_type_error():
    c = _file(DEEPSEEK)
    with pytest.raises(TypeError, match="n_expert"):
        program.model_config(dict(c, moe=dict(c["moe"], n_expert=160)))
    layers = [dict(c["layers"][0], stride=2), c["layers"][1]]
    with pytest.raises(TypeError, match="stride"):
        program.model_config(dict(c, layers=layers))


def test_a_files_tiny_takes_the_place_of_the_dense_small_size(monkeypatch):
    cell = spec.cell(test_perfbench_run.BENCH, "phi3.serve.decode")
    own = dict(test_perfbench_run.SMALL, n_layers=3)
    monkeypatch.setattr(spec, "cell", lambda bench, w: dataclasses.replace(
        cell, config=dict(cell.config, tiny=own)))
    assert test_perfbench_run.tiny("phi3.serve.decode").config["n_layers"] \
        == 3
    monkeypatch.undo()
    assert test_perfbench_run.tiny("phi3.serve.decode").config["n_layers"] \
        == test_perfbench_run.SMALL["n_layers"]
