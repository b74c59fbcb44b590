"""DeepSeek-V2's published mechanisms in the port, on the CPU: the
group-limited routing with scaled gates (the gating kernel's plain
version) against a brute-force enumeration, ties included; the dropless
rows; YaRN's numbers at the published values; a device holding a share
of the experts routes dropless only; the engine's device counters; the
bucketed prefill's plan; and, with every new setting at its default,
the outputs the port gave before the settings existed, bit for bit (the
model against its plain reference: ``perfbench/tests/
test_perfbench_dsv2.py``).  No JAX here."""
import dataclasses
import hashlib
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MLAConfig, MoEConfig
from repro_torch.kernels import moe_gating_plain
from repro_torch.kernels.moe_gating.ops import (moe_gating,
                                                moe_gating_dropless,
                                                moe_gating_dropless_plain)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer
from repro_torch.obs.device_counters import DeviceCounters, counting
from repro_torch.serving import ServingEngine
from repro_torch.serving.graphs import (BucketPrefillGraphs, PrefillGraphs,
                                        buckets, top_rung)

#: DeepSeek-V2's published routing and YaRN (its config.json)
DSV2_MOE = dict(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536,
                n_groups=8, topk_groups=3, renormalize=False,
                routed_scale=16.0)
DSV2_MLA = MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                     qk_rope_dim=64, v_head_dim=128, latent_norms=True,
                     yarn_factor=40.0, yarn_original_max=4096,
                     yarn_beta_fast=32.0, yarn_beta_slow=1.0,
                     yarn_mscale=0.707, yarn_mscale_all_dim=0.707)


def _brute_route(p: np.ndarray, k: int, G: int, kg: int, scale: float):
    """Each token's experts and gates by enumeration: every group's score
    and every expert's prob ranked by (value descending, index
    ascending), in Python."""
    T, E = p.shape
    gs = E // G
    eids, gates = [], []
    for t in range(T):
        score = [max(p[t, g * gs:(g + 1) * gs]) for g in range(G)]
        kept = sorted(range(G), key=lambda g: (-score[g], g))[:kg]
        cand = [e for e in range(E) if e // gs in kept]
        top = sorted(cand, key=lambda e: (-p[t, e], e))[:k]
        eids.append(top)
        gates.append([p[t, e] * scale for e in top])
    return np.array(eids), np.array(gates, dtype=np.float32)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("T,E,k,G,kg", [(37, 160, 6, 8, 3), (50, 16, 4, 4, 2),
                                        (20, 64, 8, 8, 1), (9, 12, 3, 1, 1)])
def test_group_limited_routing_matches_a_brute_force_enumeration(
        T, E, k, G, kg, tied):
    rng = np.random.default_rng(T + E + tied)
    logits = (rng.integers(0, 3, (T, E)) if tied
              else rng.standard_normal((T, E)) * 3).astype(np.float32)
    x = torch.from_numpy(logits)
    eids, gates, slots, keep = moe_gating_plain(
        x, top_k=k, capacity=4, n_groups=G, topk_groups=kg,
        renormalize=False, scale=2.5)
    p = torch.softmax(x, dim=-1).numpy()
    want_e, want_g = _brute_route(p, k, G, kg, 2.5)
    np.testing.assert_array_equal(eids.numpy(), want_e)
    np.testing.assert_allclose(gates.numpy(), want_g, rtol=1e-6, atol=0)
    # first come, first served: each expert's entries in (token, k) order
    flat = want_e.reshape(-1)
    pos = np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])
    np.testing.assert_array_equal(keep.numpy().reshape(-1), pos < 4)
    np.testing.assert_array_equal(slots.numpy().reshape(-1),
                                  flat * 4 + np.where(pos < 4, pos, 0))


@pytest.mark.parametrize("held", [0, 4, 16])
def test_dropless_rows_sort_the_entries_by_expert(held):
    rng = np.random.default_rng(held)
    x = torch.from_numpy(rng.integers(0, 4, (41, 16)).astype(np.float32))
    eids, gates, rows, keep, ends = moe_gating_dropless_plain(
        x, top_k=4, held=held, n_groups=4, topk_groups=2,
        renormalize=False, scale=2.5)
    want = moe_gating_plain(x, top_k=4, capacity=41, n_groups=4,
                            topk_groups=2, renormalize=False, scale=2.5)
    assert torch.equal(eids, want[0]) and torch.equal(gates, want[1])
    flat = eids.reshape(-1).numpy()
    order = sorted(range(flat.size), key=lambda i: (flat[i], i))
    expect = np.empty(flat.size, dtype=np.int64)
    expect[order] = np.arange(flat.size)
    np.testing.assert_array_equal(rows.reshape(-1).numpy(), expect)
    np.testing.assert_array_equal(keep.numpy(), eids.numpy() < held)
    np.testing.assert_array_equal(ends.numpy(), np.cumsum(
        np.bincount(flat, minlength=16)))
    # the wrapper's plain route, and the custom op's CPU kernel
    for got in (moe_gating_dropless(x, top_k=4, held=held, n_groups=4,
                                    topk_groups=2, renormalize=False,
                                    scale=2.5),
                torch.ops.repro_torch.moe_gating_dropless(x, 4, held, 4, 2,
                                                          False, 2.5)):
        assert all(torch.equal(a, b) for a, b in zip(got, (eids, gates, rows,
                                                           keep, ends)))


@pytest.mark.parametrize("kw", [dict(n_groups=3), dict(n_groups=4,
                                                       topk_groups=5),
                                dict(n_groups=8, topk_groups=1)])
def test_routing_the_kernel_cannot_take_is_refused(kw):
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((2, 16)), top_k=4, capacity=8, **kw)


def test_yarn_at_the_published_values():
    assert L.yarn_correction_range(64, 1e4, 32, 1, 4096) == (10, 23)
    assert L.mla_softmax_scale(DSV2_MLA) == pytest.approx(0.114722, abs=1e-6)
    assert L.yarn_mscale(40, 0.707) == pytest.approx(1.2608, abs=1e-4)
    f = L.yarn_freqs(DSV2_MLA, 64, 1e4)
    plain = L.rope_freqs(64, 1e4)
    # below the range extrapolated (RoPE's own), above interpolated (/40)
    torch.testing.assert_close(f[:11], plain[:11], rtol=1e-6, atol=0)
    torch.testing.assert_close(f[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert all(plain[i] / 40 < f[i] < plain[i] for i in range(11, 23))
    # cos and sin scaled by mscale(40, 0.707) / mscale(40, 0.707) = 1: a
    # YaRN rotation keeps the norm
    x = torch.randn(1, 5, 2, 64)
    pos = torch.arange(5)[None] * 1000
    cfg = types.SimpleNamespace(mla=DSV2_MLA, rope_theta=1e4)
    torch.testing.assert_close(L.mla_rope(cfg, x, pos).norm(dim=-1),
                               x.norm(dim=-1))


def _tiny(**moe_over):
    """reduced deepseek-v2 in f32 with the published mechanisms on: 16
    experts in 4 groups, top 4 of 2 groups, gates x2.5, dropless; latent
    norms; YaRN over 64 original positions at factor 4."""
    base = reduced(get_config("deepseek-v2-236b"))
    moe = dataclasses.replace(base.moe, **{
        **dict(n_experts=16, top_k=4, n_groups=4, topk_groups=2,
               renormalize=False, routed_scale=2.5, dropless=True),
        **moe_over})
    mla = dataclasses.replace(base.mla, latent_norms=True, yarn_factor=4.0,
                              yarn_original_max=64, yarn_mscale=1.0,
                              yarn_mscale_all_dim=0.707)
    return dataclasses.replace(base, moe=moe, mla=mla,
                               compute_dtype="float32",
                               param_dtype="float32")


def test_a_held_share_routes_dropless_only():
    cfg = _tiny(experts_held=4, dropless=False)
    p = transformer.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="dropless"):
        transformer.forward(cfg, p, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="4 of 16"):
        M._moe_shard_map(cfg, {}, None, torch.float32, None, (), "model")


def test_the_published_routing_trains():
    """Under autograd the gates are recomputed from the router's logits
    (scaled, not renormalised), so the router gets its gradient."""
    cfg = _tiny(experts_held=4)
    p = transformer.init_params(cfg, device="cpu")
    for leaf in (p["groups"][1]["sub0"]["ffn"]["router"],
                 p["groups"][1]["sub0"]["mixer"]["kv_norm"]):
        leaf.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (2, 12))
    loss, _ = transformer.loss_fn(cfg, p, {"tokens": tok, "labels": tok},
                                  remat_policy="none")
    loss.backward()
    for leaf in (p["groups"][1]["sub0"]["ffn"]["router"],
                 p["groups"][1]["sub0"]["mixer"]["kv_norm"]):
        assert leaf.grad is not None and bool(leaf.grad.abs().sum() > 0)


def test_the_engine_counts_held_entries_on_the_device():
    cfg = _tiny(experts_held=4)
    p = transformer.init_params(cfg, device="cpu")
    eng = ServingEngine(cfg, p, max_slots=2, max_seq=64,
                        device=torch.device("cpu"))
    rng = np.random.default_rng(6)
    for n in (9, 20, 5):
        eng.submit(rng.integers(0, cfg.vocab_size, n), max_new_tokens=6)
    eng.run()
    st = eng.stats()
    moe_layers = 2
    steps = 3 * 5                     # each request: prefill, 5 decodes
    assert st["moe_layer_calls_prefill"] == 3 * moe_layers
    assert st["moe_layer_calls_decode"] == steps * moe_layers
    assert st["moe_dropped_entries"] == 0
    assert 0 <= st["moe_held_entries_decode"] <= steps * moe_layers * 4
    assert 0 < st["moe_prefill_max_rows"] <= 20
    assert st["moe_held_entries_prefill"] >= st["moe_prefill_max_rows"]
    # a model without MoE keeps none
    dense = reduced(get_config("phi3-mini-3.8b"))
    eng = ServingEngine(dense, transformer.init_params(dense, device="cpu"),
                        max_slots=1, max_seq=32, device=torch.device("cpu"))
    assert eng.device_counters is None
    assert not any(k.startswith("moe_") for k in eng.stats())


def test_the_capacity_path_counts_its_drops():
    cfg = reduced(get_config("llama4-maverick-400b-a17b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.25), compute_dtype="float32",
        param_dtype="float32")
    p = transformer.init_params(cfg, device="cpu")
    counters = DeviceCounters(M.COUNTERS, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (1, 200))
    with counting(counters):
        transformer.forward(cfg, p, tok)
    dropped = counters.read()["moe_dropped_entries"]
    per_layer = 200 * cfg.moe.top_k - cfg.moe.n_experts * M.capacity(cfg,
                                                                     200)
    layers = sum(g.count for g in cfg.groups)
    assert dropped >= layers * per_layer > 0


def test_device_counters_add_and_keep_the_maximum():
    c = DeviceCounters(("a", "b"), "cpu")
    c.add("a", 3)
    c.add("a", torch.tensor(4))
    c.maximum("b", torch.tensor(7))
    c.maximum("b", torch.tensor(2))
    assert c.read() == {"a": 7, "b": 7}
    c.reset()
    assert c.read() == {"a": 0, "b": 0}


@pytest.mark.parametrize("L_", [1, 15, 16, 17, 100, 128])
def test_the_bucketed_prefill_plans_one_pass_of_its_bucket(L_):
    """What ``perfbench/serve.py`` reads of ``pre.plan(L)``: the row
    counts of the prompt's passes, as the ladder gives its chunks."""
    ladder = PrefillGraphs.plan(types.SimpleNamespace(top=top_rung(128)), L_)
    bucketed = BucketPrefillGraphs.plan(
        types.SimpleNamespace(sizes=buckets(128)), L_)
    for plan in (ladder, bucketed):
        assert isinstance(plan, list) and all(
            isinstance(r, int) and r >= 1 for r in plan)
    assert sum(ladder) == L_
    assert bucketed == [next(b for b in buckets(128) if b >= L_)]


def test_the_settings_are_init_only_and_replace_takes_them():
    """The published settings are attributes, not fields: a config's
    fields stay the reference package's one for one."""
    m = MoEConfig(**DSV2_MOE, experts_held=20, dropless=True)
    assert dataclasses.asdict(m) == dataclasses.asdict(MoEConfig(
        n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536))
    assert (m.held, m.n_groups, m.routed_scale, m.dropless) == \
        (20, 8, 16.0, True)
    r = dataclasses.replace(m, top_k=4)
    assert (r.top_k, r.held, r.n_groups, r.routed_scale, r.dropless) == \
        (4, 20, 8, 16.0, True)
    assert dataclasses.replace(m, experts_held=40).held == 40
    assert dataclasses.asdict(DSV2_MLA) == dataclasses.asdict(MLAConfig(
        kv_lora_rank=512, q_lora_rank=1536))
    assert DSV2_MLA.yarn_factor == 40.0 and MLAConfig().yarn_factor == 1.0


@pytest.mark.parametrize("a, b", [
    (MoEConfig(**DSV2_MOE), MoEConfig(**{**DSV2_MOE, "routed_scale": 1.0})),
    (MoEConfig(**DSV2_MOE), MoEConfig(**DSV2_MOE, experts_held=20)),
    (DSV2_MLA, dataclasses.replace(DSV2_MLA, latent_norms=False)),
], ids=["routed_scale", "experts_held", "latent_norms"])
def test_configs_that_differ_in_a_setting_differ(a, b):
    """``==``, ``hash`` and ``repr`` see the init-only settings, and the
    configs that hold them (and their ``reduced`` sizes) too."""
    assert a != b and hash(a) != hash(b) and repr(a) != repr(b)
    assert a == dataclasses.replace(a) and hash(a) == hash(
        dataclasses.replace(a))
    kind = "moe" if isinstance(a, MoEConfig) else "mla"
    base = get_config("deepseek-v2-236b")
    ca, cb = (dataclasses.replace(base, **{kind: x}) for x in (a, b))
    assert ca != cb and reduced(ca) != reduced(cb)


def test_active_params_count_the_held_share():
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              moe=MoEConfig(**DSV2_MOE, experts_held=20))
    whole = dataclasses.replace(cfg, moe=MoEConfig(**DSV2_MOE))
    expert = 3 * cfg.d_model * 1536
    assert whole.active_param_count() - cfg.active_param_count() == \
        59 * expert * 6 * 140 // 160
    assert cfg.param_count() == whole.param_count()


#: sha256 of reduced deepseek-v2's and llama4's f32 logits (a 12-token
#: prefill, 3 decode steps, the full forward over 15 tokens; init seed 0;
#: one CPU thread), as the port gave them before the routing, latent-norm
#: and YaRN fields existed: the fields' defaults change nothing
DEFAULT_DIGESTS = {
    "deepseek-v2-236b":
        "30435c609e5cb103c3ccc7d6164cfe9cdfd4c8080cf9b3133593ca1b69b4ae89",
    "llama4-maverick-400b-a17b":
        "78a537238143844dda09a135b9ce62ee7d41158c1cf591e549a1d2f9093726cd",
}


@pytest.mark.parametrize("arch", sorted(DEFAULT_DIGESTS))
def test_every_new_field_at_its_default_gives_the_outputs_of_before(arch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  compute_dtype="float32",
                                  param_dtype="float32")
        p = transformer.init_params(cfg, device="cpu")
        tok = torch.arange(15).reshape(1, 15) * 17 % cfg.vocab_size
        caches = transformer.init_cache(cfg, 1, 32, dtype=torch.float32,
                                        device="cpu")
        h = hashlib.sha256()
        lg, caches = transformer.prefill(cfg, p, tok[:, :12], caches)
        h.update(lg.numpy().tobytes())
        for i in range(12, 15):
            lg, caches = transformer.decode_step(cfg, p, tok[:, i], caches)
            h.update(lg.numpy().tobytes())
        full, _ = transformer.forward(cfg, p, tok)
        h.update(full.numpy().tobytes())
    finally:
        torch.set_num_threads(threads)
    assert h.hexdigest() == DEFAULT_DIGESTS[arch]
    assert math.isfinite(float(full.abs().max()))
