"""The bucketed prefill (``repro_torch.serving.graphs``
``BucketPrefillGraphs``) on the CPU: its buckets, its refusals, and the
eager padded prefill (``prefill(..., valid=, capacity=)``, the twin of a
captured bucket) of recurrentgemma (a ring of 32 rows), llama4 (MoE) and
deepseek-v2 (MLA and MoE) against the JAX package's one-shot prefill of
the real tokens alone and its greedy decode steps.  Reduced configs, f32
compute and f32 caches on both sides, ``TOL`` as
``tests/test_torch_prefill.py`` has it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import list_archs  # noqa: E402
from repro.models import decode_step, init_cache, init_params, prefill  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.kernels import moe_gating  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import graphs as tg  # noqa: E402
from test_torch_prefill import (CPU, EAGER, MAX_LEN, PROMPTS, TOL, XLSTM,  # noqa: E402
                                _cfgs, _NoHostSync, _np, _tensors)

#: the families the buckets serve on the card (the ladder serves the rest)
BUCKET = EAGER
#: a capacity factor at which a prompt's own capacity drops entries that
#: its bucket's would keep (the reduced configs route dropless)
DROPPING = 1.5


def _family(arch, **moe_kw):
    """(jcfg, tcfg, jax params, port params), the MoE config replaced by
    ``moe_kw`` on both sides."""
    jcfg, tcfg = _cfgs(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_kw))
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


def _prompt(vocab, L):
    return np.random.default_rng(L).integers(0, vocab, (1, L)).astype(
        np.int32)


def _fresh(tcfg):
    return tm.init_cache(tcfg, 1, MAX_LEN, dtype=torch.float32, device=CPU)


def _read_rows_close(got, want, L):
    """Every cache row and state decode reads, port against reference: a
    row cache's (k/v, MLA's c_kv/k_rope) rows below min(L, W), a ring's
    all W once L >= W, a recurrent state whole; the host length L."""
    assert len(got) == len(want)
    for gg, wg in zip(got, want):
        assert set(gg) == set(wg)
        for key in wg:
            assert set(gg[key]) == set(wg[key])
            for name, w in wg[key].items():
                g = gg[key][name]
                if name == "length":
                    assert g == L
                    np.testing.assert_array_equal(np.asarray(w), L)
                elif name in ("k", "v", "c_kv", "k_rope"):
                    n = min(L, g.shape[2])
                    np.testing.assert_allclose(
                        _np(g)[:, :, :n], np.asarray(w)[:, :, :n], **TOL,
                        err_msg=f"{key}.{name}")
                else:
                    np.testing.assert_allclose(_np(g), np.asarray(w), **TOL,
                                               err_msg=f"{key}.{name}")


def _padded_against_reference(jcfg, tcfg, jp, tp, L):
    """The padded prefill of an L-token prompt in its bucket of the
    48-row caches against the reference's one-shot prefill of the L
    tokens: logits, every cache row and state decode reads, every pad row
    finite; then 4 greedy decode steps, the same logits and tokens."""
    prompt = _prompt(jcfg.vocab_size, L)
    bucket = tg._bucket_of(tg.buckets(MAX_LEN), L)
    tlog, tc = tg.eager_bucket(tcfg, tp, torch.from_numpy(prompt).long(),
                               _fresh(tcfg), bucket)
    jlog, jc = prefill(jcfg, jp, jnp.asarray(prompt),
                       init_cache(jcfg, 1, MAX_LEN, dtype=jnp.float32))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _read_rows_close(tc, jax.tree.map(np.asarray, jc), L)
    assert all(bool(torch.isfinite(t).all()) for t in _tensors(tc))
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert int(tlog[0].argmax()) == int(tok[0])
    for _ in range(4):
        jlog, jc = decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert int(tlog[0].argmax()) == int(tok[0])


# ---------------------------------------------------------------------------
# the buckets and the refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_seq,want", [
    (2, [2]), (10, [10]), (16, [16]), (17, [16, 17]), (48, [16, 32, 48]),
    (64, [16, 32, 64]), (1024, [16, 32, 64, 128, 256, 512, 1024]),
    (4096, [16, 32, 64, 128, 256, 512, 1024, 2048, 4096])])
def test_buckets_are_the_powers_of_two_from_16_then_max_seq(max_seq, want):
    sizes = tg.buckets(max_seq)
    assert sizes == want
    for L in range(1, max_seq + 1):
        b = tg._bucket_of(sizes, L)
        assert b >= L and all(s < L for s in sizes if s < b)
    with pytest.raises(ValueError, match=f"{max_seq + 1} tokens"):
        tg._bucket_of(sizes, max_seq + 1)


@pytest.mark.parametrize("max_seq", [0, 1])
def test_buckets_refuse_caches_of_fewer_than_two_rows(max_seq):
    with pytest.raises(ValueError, match=f"caches of {max_seq} rows"):
        tg.buckets(max_seq)


def test_the_buckets_take_every_family_but_xlstm():
    """Every family the ladder does not take pads to a bucket, so on the
    card every family's prefill is graphed."""
    for arch in list_archs():
        for cfg in (tconfigs.get_config(arch),
                    tconfigs.reduced(tconfigs.get_config(arch))):
            assert tt.takes_buckets(cfg) == (arch != XLSTM), arch
            assert tt.takes_ladder(cfg) or tt.takes_buckets(cfg), arch
            assert tt.takes_ladder(cfg) == (arch not in BUCKET), arch


def test_bucket_graphs_need_a_cuda_device():
    _, tcfg = _cfgs("recurrentgemma-2b")
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    caches = [tm.init_cache(tcfg, 1, MAX_LEN, device=CPU)]
    with pytest.raises(ValueError, match="CUDA device"):
        tg.BucketPrefillGraphs(tcfg, params, caches, None, MAX_LEN, CPU)


def test_a_padded_prompt_is_refused_off_fresh_batch_1_caches():
    """A padded prompt runs at batch 1 and S >= 2 on caches at length 0,
    with the true length's capacity where there is MoE; xLSTM's states
    would carry on through the pads."""
    _, tcfg = _cfgs("llama4-maverick-400b-a17b")
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    valid, cap = torch.tensor([2]), torch.tensor([8])
    tokens = torch.tensor([[3, 4, 5, 0]])
    with pytest.raises(ValueError, match="capacity"):
        tm.prefill(tcfg, params, tokens, _fresh(tcfg), valid=valid)
    with pytest.raises(ValueError, match="batch 1"):
        tm.prefill(tcfg, params, tokens.repeat(2, 1), tm.init_cache(
            tcfg, 2, MAX_LEN, dtype=torch.float32, device=CPU),
            valid=valid, capacity=cap)
    with pytest.raises(ValueError, match="fresh caches"):
        tm.prefill(tcfg, params, tokens, tt.set_length(_fresh(tcfg), 3),
                   valid=valid, capacity=cap)
    with pytest.raises(ValueError, match="S >= 2"):
        tm.prefill(tcfg, params, tokens[:, :1], _fresh(tcfg),
                   valid=torch.tensor([1]), capacity=cap)
    _, xcfg = _cfgs(XLSTM)
    xp = tm.init_params(xcfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(NotImplementedError, match="padded prompt"):
        tm.prefill(xcfg, xp, tokens, _fresh(xcfg), valid=valid)


@pytest.mark.parametrize("arch", BUCKET)
def test_the_cpu_engine_prefills_the_bucket_families_eagerly(arch):
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    eng = ServingEngine(tcfg, params, max_slots=2, max_seq=32, device=CPU)
    assert eng.decode_graphs is None and eng.prefill_graphs is None
    eng.submit(np.arange(3, 10), max_new_tokens=2)
    assert all(len(r.generated) == 2 for r in eng.run())


# ---------------------------------------------------------------------------
# the padded prefill against the reference's one-shot prefill
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=BUCKET)
def family(request):
    """(jcfg, tcfg, jax params, port params)."""
    return _family(request.param)


@pytest.mark.parametrize("L", PROMPTS)
def test_padded_prefill_matches_the_reference_one_shot(family, L):
    """Prompts of 1, 2, 7, 21 and 37 tokens in buckets of 16, 16, 16, 32
    and 48 rows: shorter than, equal to and longer than recurrentgemma's
    32-row ring (37 tokens in 48 rows wrap it, each slot taking the last
    real row of its residue)."""
    _padded_against_reference(*family, L)


@pytest.mark.parametrize("arch,L", [("llama4-maverick-400b-a17b", 37),
                                    ("deepseek-v2-236b", 21),
                                    ("deepseek-v2-236b", 37)])
def test_padded_prefill_keeps_the_true_lengths_capacity(arch, L,
                                                        monkeypatch):
    """At capacity factor 1.5 the prompt's own capacity C(L) is below its
    bucket's C(B) and drops real entries that C(B) keeps: the padded
    prefill masks them (``keep`` by slot < C(L)), so it still matches the
    reference's one-shot prefill, which routes at C(L)."""
    jcfg, tcfg, jp, tp = _family(arch, capacity_factor=DROPPING)
    bucket = tg._bucket_of(tg.buckets(MAX_LEN), L)
    assert tmoe.capacity(tcfg, L) < tmoe.capacity(tcfg, bucket)
    masked = []
    dispatch = tmoe._group_dispatch

    def spy(cfg, router_w, xg, cdt, aux=False, valid=None):
        out = dispatch(cfg, router_w, xg, cdt, aux, valid)
        C = tmoe.capacity(cfg, xg.shape[0])
        eids, _, slots, keep = moe_gating(xg.float() @ router_w,
                                          top_k=cfg.moe.top_k, capacity=C)
        at = slots.reshape(-1).long() - eids.reshape(-1).long() * C
        src = torch.arange(xg.shape[0]).repeat_interleave(cfg.moe.top_k)
        masked.append(int((keep.reshape(-1) & (src < L)
                           & (at >= tmoe.capacity(cfg, L))).sum()))
        return out

    monkeypatch.setattr(tmoe, "_group_dispatch", spy)
    _padded_against_reference(jcfg, tcfg, jp, tp, L)
    assert sum(masked) > 0, masked


@pytest.mark.parametrize("arch", BUCKET)
def test_padded_prefill_can_be_captured(arch):
    """The padded prefill of a 37-token prompt in its 48-row bucket reads
    no device value on the host and makes no host tensor, and every cache
    tensor keeps its address (a captured bucket reads those addresses)."""
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    tokens = torch.zeros((1, MAX_LEN), dtype=torch.long)
    tokens[:, :37] = torch.arange(3, 40) % tcfg.vocab_size
    valid = torch.full((1,), 37, dtype=torch.long)
    cap = torch.full((1,), tg._moe_capacity(tcfg, 37), dtype=torch.long)
    caches = _fresh(tcfg)
    ptrs = [t.data_ptr() for t in _tensors(caches)]
    with _NoHostSync():
        logits, out = tm.prefill(tcfg, params, tokens, caches, valid=valid,
                                 capacity=cap)
    assert [t.data_ptr() for t in _tensors(out)] == ptrs
    want, _ = tm.prefill(tcfg, params, tokens[:, :37], _fresh(tcfg))
    torch.testing.assert_close(logits, want, **TOL)
