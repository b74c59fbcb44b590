"""The port's decoder against the JAX package's: reduced phi3-mini,
recurrentgemma, llama4, the dense families (minicpm-2b, deepseek-coder-33b,
mistral-large-123b), xLSTM, deepseek-v2 (MLA), qwen2-vl (M-RoPE) and
musicgen at f32 compute, with the JAX parameters carried over through
``params_from_numpy``, give the same logits and greedy tokens; the
RG-LRU, MoE, MLA, mLSTM and sLSTM blocks and M-RoPE match on their own;
the stub frontends draw what the reference's draw; the port's own draws
follow the reference's scale rule; a decode step driven by a device
position equals the host-int one."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of one thread per core would crowd the timing-
# sensitive runtime tests running beside these
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, list_archs, reduced  # noqa: E402
from repro.configs.base import LayerGroup  # noqa: E402
from repro.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.models import frontends as tfront  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

ARCH = "phi3-mini-3.8b"
RG, LLAMA4 = "recurrentgemma-2b", "llama4-maverick-400b-a17b"
XLSTM = "xlstm-1.3b"
#: the xLSTM stack the value-parity tests run: one mLSTM and one sLSTM
#: block, twice -- the reference's own canary stack
#: (``tests/test_attention.py``).  The reduced config's 16 blocks amplify
#: a last-bit difference into logit differences far past TOL in the
#: reference itself (test_reduced_xlstm_stack_amplifies_a_last_bit_change),
#: so no implementation that is not bit-identical holds that stack at TOL
XLSTM_STACK = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)
#: the dense families the port runs beside phi3 (minicpm ties its head to
#: the embedding)
DENSE = ("minicpm-2b", "deepseek-coder-33b", "mistral-large-123b")
#: MLA with a MoE stack behind a dense first layer, M-RoPE, and the audio
#: backbone (MHA at head dim 64)
DSV2, QWEN2VL, MUSICGEN = "deepseek-v2-236b", "qwen2-vl-7b", "musicgen-large"
LATE = (DSV2, QWEN2VL, MUSICGEN)
CPU = torch.device("cpu")
#: f32 on both sides; the sums run in another order
TOL = dict(atol=1e-4, rtol=1e-4)


def _stack(arch) -> dict:
    """xLSTM's parity stack (``XLSTM_STACK``) for ``_cfgs``."""
    return {"groups": XLSTM_STACK} if arch == XLSTM else {}


def _cfgs(arch=ARCH, **kw):
    """The same reduced config from each package, at f32 compute."""
    return (dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype="float32", **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                                compute_dtype="float32", **kw))


@pytest.fixture(scope="module")
def rig():
    jcfg, tcfg = _cfgs()
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_configs_copied_verbatim():
    assert tconfigs.list_archs() == list_archs()
    for arch in list_archs():
        assert (dataclasses.asdict(tconfigs.get_config(arch))
                == dataclasses.asdict(get_config(arch)))
        assert (dataclasses.asdict(tconfigs.reduced(tconfigs.get_config(arch)))
                == dataclasses.asdict(reduced(get_config(arch))))


def test_init_params_keeps_the_reference_layout(rig):
    jcfg, tcfg, jp, tp = rig
    mine = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert _shapes(mine) == _shapes(jp) == _shapes(tp)
    assert mine["embed"].dtype == torch.float32


def test_params_from_numpy_casts_floats_only():
    tree = {"w": np.ones((2, 3), np.float32), "ids": np.arange(3)}
    out = tm.params_from_numpy(tree, CPU, dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int64


def test_cast_params_casts_matmul_weights_and_keeps_norms(rig):
    _, _, _, tp = rig
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))          # bf16 compute
    out = tm.cast_params(cfg, tp)
    sub = out["groups"][0]["sub0"]
    assert out["embed"].dtype == out["lm_head"].dtype == torch.bfloat16
    assert sub["mixer"]["wq"].dtype == sub["ffn"]["w_down"].dtype \
        == torch.bfloat16
    assert sub["norm1"].dtype == out["final_norm"].dtype == torch.float32


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(10, 20, dtype=np.int32).reshape(2, 5)
    np.testing.assert_allclose(
        tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **TOL)


def test_forward_logits_match(rig):
    jcfg, tcfg, jp, tp = rig
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 13))
    jlog, _, _ = forward(jcfg, jp, jnp.asarray(toks, jnp.int32))
    tlog, _ = tm.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("prompt_len", [1, 11])
def test_prefill_logits_and_greedy_tokens_match(rig, prompt_len):
    jcfg, tcfg, jp, tp = rig
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               prompt_len).astype(np.int32)
    jc = init_cache(jcfg, 1, 32)
    jlog, jc = prefill(jcfg, jp, jnp.asarray(prompt[None]), jc)
    tc = tm.init_cache(tcfg, 1, 32, device=CPU)
    tlog, tc = tm.prefill(tcfg, tp, torch.from_numpy(prompt[None]), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    want, got = [int(jnp.argmax(jlog[0]))], [int(tlog[0].argmax())]
    for _ in range(8):
        jlog, jc = decode_step(jcfg, jp, jnp.asarray([want[-1]], jnp.int32), jc)
        want.append(int(jnp.argmax(jlog[0])))
        tlog, tc = tm.decode_step(tcfg, tp, torch.tensor([got[-1]]), tc)
        got.append(int(tlog[0].argmax()))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert got == want
    assert tc[0]["sub0"]["length"] == prompt_len + 8


def test_a_ring_at_a_cache_offset_still_raises():
    """A local-attention ring takes a prompt at length 0 only: the
    reference's ring prefill assumes it (its second chunk attends to its
    own tokens alone and writes them over ring slots 0..S-1), so its two
    chunks of a 15-token prompt give logits far from its one-shot
    prefill's (ROADMAP.md, Queue 3).  The port raises on a second chunk
    rather than copy that; and on a prompt that does not fit the cache."""
    jcfg, tcfg = _cfgs(RG)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    prompt = jnp.asarray(np.random.default_rng(16).integers(
        0, jcfg.vocab_size, (1, 15)), jnp.int32)
    whole, _ = prefill(jcfg, jp, prompt, init_cache(jcfg, 1, 64, jnp.float32))
    _, jc = prefill(jcfg, jp, prompt[:, :10],
                    init_cache(jcfg, 1, 64, jnp.float32))
    split, _ = prefill(jcfg, jp, prompt[:, 10:], jc)
    assert float(jnp.abs(whole - split).max()) > 1.0
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    tc = tm.init_cache(tcfg, 1, 64, device=CPU)
    _, tc = tm.prefill(tcfg, tp, torch.tensor([[1, 2, 3]]), tc)
    with pytest.raises(NotImplementedError, match="ring"):
        tm.prefill(tcfg, tp, torch.tensor([[4, 5]]), tc)
    _, tcfg = _cfgs(ARCH)
    tp = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    tc = tm.init_cache(tcfg, 1, 8, device=CPU)
    _, tc = tm.prefill(tcfg, tp, torch.tensor([[1, 2, 3, 4, 5]]), tc)
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill(tcfg, tp, torch.tensor([[6, 7, 8, 9]]), tc)


@pytest.mark.parametrize("arch", [ARCH, DSV2, QWEN2VL, XLSTM])
@pytest.mark.parametrize("split", [5, 16])
def test_two_chunk_prefill_matches_reference(arch, split):
    """A 21-token prompt prefilled in two chunks (chunked prefill: the
    second at cache offset ``split``, after the patch embeddings qwen2-vl's
    first chunk carries) against the reference's two chunks, each chunk's
    last-token logits and every cache (f32 on both sides), and against
    the reference's one-shot prefill of the whole prompt, logits, caches
    and 4 greedy decode steps.  xLSTM is held against the one-shot prefill
    only past its first chunk: the reference's mLSTM chunk from a carried
    state is wrong."""
    jcfg, tcfg = _cfgs(arch, **_stack(arch))
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, jcfg.vocab_size, (1, 21)).astype(np.int32)
    emb = None
    if jcfg.frontend == "vision_stub":
        emb = (rng.standard_normal((1, jcfg.n_visual_tokens, jcfg.d_model))
               * 0.02).astype(np.float32)
    jc = init_cache(jcfg, 1, 48, dtype=jnp.float32)
    tc = tm.init_cache(tcfg, 1, 48, dtype=torch.float32, device=CPU)
    for i, chunk in enumerate((prompt[:, :split], prompt[:, split:])):
        extra = emb if i == 0 else None
        jlog, jc = prefill(jcfg, jp, jnp.asarray(chunk), jc,
                           extra_embeds=None if extra is None
                           else jnp.asarray(extra))
        tlog, tc = tm.prefill(tcfg, tp, torch.from_numpy(chunk), tc,
                              extra_embeds=None if extra is None
                              else torch.from_numpy(extra))
        if i == 0 or arch != XLSTM:
            # the reference's second mLSTM chunk reads its state wrongly
            # (test_mlstm_chunk_from_a_state_matches_the_reference_steps)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    if arch != XLSTM:
        assert tt._cache_length(tc) == int(jtr._cache_length(jc))
        _tree_close(tc, jax.tree.map(np.asarray, jc), **TOL)
    # the reference's one-shot prefill of the whole prompt
    jlog, jc = prefill(jcfg, jp, jnp.asarray(prompt),
                       init_cache(jcfg, 1, 48, dtype=jnp.float32),
                       extra_embeds=None if emb is None else jnp.asarray(emb))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _tree_close(tc, jax.tree.map(np.asarray, jc), **TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        jlog, jc = decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert int(tlog[0].argmax()) == int(tok[0])


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# the recurrent (recurrentgemma) and MoE (llama4) families
# ---------------------------------------------------------------------------
def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _tree_close(got[k], want[k], **tol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, **tol)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture(scope="module", params=[RG, LLAMA4, *DENSE, XLSTM, *LATE])
def family(request):
    """(jcfg, tcfg, jax params, port params, jitted JAX prefill/decode)."""
    jcfg, tcfg = _cfgs(request.param, **_stack(request.param))
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    jpre = jax.jit(lambda p, t, c: prefill(jcfg, p, t, c))
    jdec = jax.jit(lambda p, t, c: decode_step(jcfg, p, t, c))
    return jcfg, tcfg, jp, tp, jpre, jdec


def test_family_params_keep_the_reference_layout(family):
    jcfg, tcfg, jp, tp, _, _ = family
    mine = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert _shapes(mine) == _shapes(tp)
    assert _shapes(jax.tree.map(np.asarray, jp)) == _shapes(tp)


def test_norm2_and_ffn_only_where_the_sub_layer_has_an_ffn():
    groups = (LayerGroup(pattern=("rglru", "attn_local"), count=2,
                         ffn=("dense", "none")),)
    jcfg, tcfg = _cfgs(RG, groups=groups)
    jp = jax.tree.map(np.asarray, init_params(jcfg, jax.random.PRNGKey(0)))
    mine = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert _shapes(mine) == _shapes(jp)
    assert set(mine["groups"][0]["sub1"]) == {"norm1", "mixer"}


def test_family_forward_logits_match(family):
    jcfg, tcfg, jp, tp, _, _ = family
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 13))
    jlog, _, _ = forward(jcfg, jp, jnp.asarray(toks, jnp.int32))
    tlog, _ = tm.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("prompt_len,max_len", [
    (11, 32),
    (28, 64),      # recurrentgemma: the ring of 32 wraps during decode
    (40, 64),      # ... and during prefill, which keeps only the tail
])
def test_family_prefill_logits_and_greedy_tokens_match(family, prompt_len,
                                                       max_len):
    """Prefill logits at 1e-4 and 8 greedy decode tokens identical.  The
    caches are f32 on both sides: a bf16 cache rounds values that differ
    in the last f32 bit to different bf16 neighbours."""
    jcfg, tcfg, jp, tp, jpre, jdec = family
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                               prompt_len).astype(np.int32)
    jc = init_cache(jcfg, 1, max_len, dtype=jnp.float32)
    jlog, jc = jpre(jp, jnp.asarray(prompt[None]), jc)
    tc = tm.init_cache(tcfg, 1, max_len, dtype=torch.float32, device=CPU)
    tlog, tc = tm.prefill(tcfg, tp, torch.from_numpy(prompt[None]), tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    want, got = [int(jnp.argmax(jlog[0]))], [int(tlog[0].argmax())]
    for _ in range(8):
        jlog, jc = jdec(jp, jnp.asarray([want[-1]], jnp.int32), jc)
        want.append(int(jnp.argmax(jlog[0])))
        tlog, tc = tm.decode_step(tcfg, tp, torch.tensor([got[-1]]), tc)
        got.append(int(tlog[0].argmax()))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert got == want
    assert tt._cache_length(tc) == int(jtr._cache_length(jc))
    _tree_close(tc, jax.tree.map(np.asarray, jc), **TOL)


def test_cache_length_skips_recurrent_states():
    """recurrentgemma's first sub-cache is an RG-LRU state, which has no
    length: reading the first sub-cache's length was a KeyError."""
    _, tcfg = _cfgs(RG)
    caches = tm.init_cache(tcfg, 1, 16, device=CPU)
    assert "length" not in caches[0]["sub0"]
    assert tt._cache_length(caches) == 0
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    _, caches = tm.prefill(tcfg, params, torch.tensor([[1, 2, 3, 4, 5]]),
                           caches)
    assert tt._cache_length(caches) == 5
    assert tt._cache_length([{"sub0": caches[0]["sub0"]}]) == 0


def test_local_attention_cache_is_a_ring_of_the_window():
    _, tcfg = _cfgs(RG)
    W = tcfg.rec.local_window
    for max_len, rows in ((16, 16), (4 * W, W)):
        caches = tm.init_cache(tcfg, 2, max_len, device=CPU)
        assert caches[0]["sub2"]["k"].shape == (2, 2, rows, 1, tcfg.head_dim_)
        assert caches[1]["sub0"]["h"].dtype == torch.float32


@pytest.mark.parametrize("S", [13, 1])
def test_rglru_forward_matches_reference(S):
    """One RG-LRU block, with a state (prefill of 13, then one decode
    token from the state it left) and, at S = 13, without one."""
    jcfg, tcfg = _cfgs(RG)
    jp = jrec.init_rglru_block(jcfg, jax.random.PRNGKey(3))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    js = jrec.init_rglru_state(jcfg, 2, jnp.float32)
    ts = {k: v[0] for k, v in
          trec.init_rglru_state(tcfg, 2, torch.float32, CPU).items()}
    jout, js = jrec.rglru_forward(jcfg, jp, jnp.asarray(x), js)
    tout, ts = trec.rglru_forward(tcfg, tp, torch.from_numpy(x), ts)
    if S == 1:
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, js = jrec.rglru_forward(jcfg, jp, jnp.asarray(x1), js)
        tout, ts = trec.rglru_forward(tcfg, tp, torch.from_numpy(x1), ts)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _tree_close(ts, js, **TOL)
    assert ts["h"].dtype == torch.float32
    if S == 13:
        jno, _ = jrec.rglru_forward(jcfg, jp, jnp.asarray(x))
        tno, none = trec.rglru_forward(tcfg, tp, torch.from_numpy(x))
        assert none is None
        np.testing.assert_allclose(tno.numpy(), np.asarray(jno), **TOL)


@pytest.mark.parametrize("top_k,capacity_factor,tokens", [
    (1, 8.0, 14),      # llama4's top-1, dropless at this size
    (2, 8.0, 14),
    (2, 0.25, 80),     # 160 entries for 8 experts of capacity 8: drops
])
def test_moe_forward_matches_reference(top_k, capacity_factor, tokens):
    """moe_forward (shared expert and, when asked for, the aux included)
    and the routed part alone (_moe_local) against the reference's
    argsort dispatch."""
    jcfg, tcfg = _cfgs(LLAMA4)
    moe = dataclasses.replace(jcfg.moe, top_k=top_k,
                              capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    tcfg = dataclasses.replace(tcfg, moe=moe)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(4))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(4).standard_normal(
        (2, tokens // 2, jcfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x))
    tout, taux = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x), aux=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # serving asks for no aux: the same output, and nothing computed
    tserve, none = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None
    torch.testing.assert_close(tserve, tout, rtol=0, atol=0)
    jloc, _ = jmoe._moe_local(jcfg, jp, jnp.asarray(x), jnp.float32)
    tloc, _ = tmoe._moe_local(tcfg, tp, torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(tloc.numpy(), np.asarray(jloc), **TOL)
    xt = torch.from_numpy(x.reshape(tokens, -1))
    buf, _, keep, _, _ = tmoe._group_dispatch(
        tcfg, tp["router"], xt, torch.float32)
    jbuf = jmoe._group_dispatch(jcfg, jp["router"], jnp.asarray(xt.numpy()),
                                jnp.float32)[0]
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    assert bool(keep.all()) == (capacity_factor > 1)


def test_cast_params_casts_the_reference_set():
    """Matmul weights, conv taps and shared experts to the compute dtype;
    the RG-LRU gates, lam and the router stay f32, as the reference reads
    them."""
    out = {}
    for arch in (RG, LLAMA4):
        cfg = tconfigs.reduced(tconfigs.get_config(arch))     # bf16 compute
        out[arch] = tm.cast_params(
            cfg, tm.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    rg = out[RG]["groups"][0]["sub0"]["mixer"]
    assert {k for k, v in rg.items() if v.dtype == torch.bfloat16} \
        == {"w_x", "w_gate", "conv_w", "conv_b", "w_out"}
    moe = out[LLAMA4]["groups"][0]["sub0"]["ffn"]
    assert moe["router"].dtype == torch.float32
    assert all(w.dtype == torch.bfloat16 for part in ("experts", "shared")
               for w in moe[part].values())


# ---------------------------------------------------------------------------
# MLA (deepseek-v2), M-RoPE and the stub frontends (qwen2-vl, musicgen)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["none", "prefill", "decode"])
def test_mla_forward_matches_reference(mode):
    """One MLA block (q through the q LoRA, 24-wide q/k heads, 16-wide v
    heads): without a cache on 13 tokens, a 13-token prefill into a
    latent cache, and (decode) one token from the cache it left, with
    the cache's latent and rope rows."""
    jcfg, tcfg = _cfgs(DSV2)
    jp = jl.init_mla(jcfg, jax.random.PRNGKey(9))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(9)
    B, S, W = 2, 13, 32
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    if mode == "none":
        jout, _ = jl.mla_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
        tout, none = tl.mla_forward(tcfg, tp, torch.from_numpy(x),
                                    torch.from_numpy(pos.copy()))
        assert none is None
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        return
    jc = jl.init_mla_cache(jcfg, B, W, jnp.float32)
    tc = {k: v[0] if isinstance(v, torch.Tensor) else v for k, v in
          tl.init_mla_cache(tcfg, B, W, torch.float32, CPU).items()}
    jout, jc = jl.mla_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos), jc)
    tout, tc = tl.mla_forward(tcfg, tp, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), tc)
    if mode == "decode":
        x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        p1 = np.full((B, 1), S)
        jout, jc = jl.mla_forward(jcfg, jp, jnp.asarray(x1), jnp.asarray(p1),
                                  jc)
        step = (torch.tensor([S]), torch.full((B,), S + 1, dtype=torch.int32))
        tout, tc = tl.mla_forward(tcfg, tp, torch.from_numpy(x1),
                                  torch.from_numpy(p1), tc, step=step)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert tc["length"] == int(jc["length"])
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)


@pytest.mark.parametrize("D,sections", [(16, (4, 2, 2)),
                                        (128, (16, 24, 24))])
def test_m_rope_matches_reference(D, sections):
    """Distinct (t, h, w) coordinates per token (a 2x3 patch grid after
    text), each section of frequency pairs turned by its own; and the
    same (3, B, S) positions on the 1-D path, which takes t."""
    rng = np.random.default_rng(10)
    B, S = 2, 9
    x = rng.standard_normal((B, S, 3, D)).astype(np.float32)
    t = np.array([0, 1, 2, 3, 3, 3, 3, 3, 3])
    h = np.array([0, 1, 2, 3, 3, 3, 4, 4, 4])
    w = np.array([0, 1, 2, 3, 4, 5, 3, 4, 5])
    pos = np.stack([np.broadcast_to(c + 7 * b, (S,)) for c in (t, h, w)
                    for b in range(B)]).reshape(3, B, S).astype(np.int32)
    for sec in (sections, ()):
        got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sec)
        want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sec)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError):
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6,
                      sections)


def test_forward_takes_extra_embeds_and_positions():
    """qwen2-vl: patch embeddings prepended to the text with distinct
    M-RoPE positions (forward), and a prefill after patch embeddings at
    the default positions followed by greedy decode steps, against the
    reference."""
    jcfg, tcfg = _cfgs(QWEN2VL)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(11)
    B, P, S = 2, 6, 5
    emb = (rng.standard_normal((B, P, jcfg.d_model)) * 0.02).astype(
        np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    grid = np.stack([np.zeros(P), np.arange(P) // 3, np.arange(P) % 3])
    text = np.broadcast_to(np.arange(3, 3 + S), (3, S))
    pos = np.broadcast_to(np.concatenate([grid, text], 1)[:, None],
                          (3, B, P + S)).astype(np.int32)
    jlog, _, _ = forward(jcfg, jp, jnp.asarray(toks, jnp.int32),
                         extra_embeds=jnp.asarray(emb),
                         positions=jnp.asarray(pos))
    tlog, _ = tm.forward(tcfg, tp, torch.from_numpy(toks),
                         extra_embeds=torch.from_numpy(emb),
                         positions=torch.from_numpy(pos.copy()))
    assert tlog.shape == (B, P + S, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    default, _ = tm.forward(tcfg, tp, torch.from_numpy(toks),
                            extra_embeds=torch.from_numpy(emb))
    assert not torch.allclose(default, tlog)      # the positions mattered
    jc = init_cache(jcfg, B, 32, dtype=jnp.float32)
    jlog, jc = prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), jc,
                       extra_embeds=jnp.asarray(emb))
    tc = tm.init_cache(tcfg, B, 32, dtype=torch.float32, device=CPU)
    tlog, tc = tm.prefill(tcfg, tp, torch.from_numpy(toks), tc,
                          extra_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        jlog, jc = decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert tt._cache_length(tc) == P + S + 4


def test_frontends_draw_the_reference_shapes_dtypes_and_scale():
    gen = torch.Generator().manual_seed(12)
    toks = tfront.make_audio_tokens(gen, 3, 500)
    want = jfront.make_audio_tokens(jax.random.PRNGKey(12), 3, 500)
    assert toks.shape == want.shape and str(toks.dtype) == "torch.int32"
    assert np.dtype(want.dtype) == np.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 2048
    assert len(torch.unique(toks)) > 1000
    small = tfront.make_audio_tokens(gen, 1, 64, vocab=256)
    assert int(small.max()) < 256
    emb = tfront.make_patch_embeds(gen, 2, 256, 64)
    jemb = jfront.make_patch_embeds(jax.random.PRNGKey(12), 2, 256, 64)
    assert emb.shape == jemb.shape and emb.dtype == torch.bfloat16
    assert str(jemb.dtype) == "bfloat16"
    assert abs(float(emb.float().std()) / float(
        np.asarray(jemb, np.float32).std()) - 1) < 0.1
    assert abs(float(emb.float().mean())) < 0.002
    f32 = tfront.make_patch_embeds(gen, 1, 8, 16, dtype=torch.float32)
    assert f32.dtype == torch.float32


def test_cast_params_casts_the_mla_projections():
    """MLA's down- and up-projections and wo to the compute dtype, as the
    reference casts them at use; the router and the norms stay f32."""
    cfg = tconfigs.reduced(tconfigs.get_config(DSV2))         # bf16 compute
    out = tm.cast_params(
        cfg, tm.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    for g in out["groups"]:
        mla = g["sub0"]["mixer"]
        assert set(mla) == {"w_dq", "w_uq", "w_dkv", "w_krope", "w_uk",
                            "w_uv", "wo"}
        assert all(w.dtype == torch.bfloat16 for w in mla.values())
        assert g["sub0"]["norm1"].dtype == torch.float32
    assert out["groups"][1]["sub0"]["ffn"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the port's own draws, the aux, and the decode step by device position
# ---------------------------------------------------------------------------
def _items(tree, path=""):
    """(path, leaf) of every array or tensor leaf, in a fixed order (a
    cache's host-int ``length`` is skipped)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _items(v, f"{path}/{i}")
    elif hasattr(tree, "shape"):
        yield path, tree


@pytest.mark.parametrize("arch", [ARCH, RG, LLAMA4, XLSTM, *DENSE, *LATE])
def test_init_scale_follows_the_reference(arch):
    """``init_params``' own draws have the reference's scale (1/sqrt of
    the per-layer ``shape[0]``: the expert or block count of a 3-d
    weight): every leaf of at least 1024 elements within 10% of the
    reference's std at PRNGKey(0), and constant leaves equal."""
    jcfg, tcfg = reduced(get_config(arch)), tconfigs.reduced(
        tconfigs.get_config(arch))
    want = {k: _np(v) for k, v in _items(
        init_params(jcfg, jax.random.PRNGKey(0)))}
    got = {k: _np(v) for k, v in _items(
        tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU))}
    assert got.keys() == want.keys()
    checked = 0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.std() == 0:
            np.testing.assert_array_equal(g, w, err_msg=path)
        elif w.size >= 1024:
            assert abs(g.std() / w.std() - 1) < 0.1, \
                (path, float(g.std()), float(w.std()))
            checked += 1
    assert checked >= 4


def test_forward_returns_the_reference_aux_when_asked():
    jcfg, tcfg = _cfgs(LLAMA4)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 9))
    jlog, _, jaux = forward(jcfg, jp, jnp.asarray(toks, jnp.int32))
    tlog, _, taux = tm.forward(tcfg, tp, torch.from_numpy(toks), aux=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert float(taux) > 0
    plain, _ = tm.forward(tcfg, tp, torch.from_numpy(toks))
    torch.testing.assert_close(plain, tlog, rtol=0, atol=0)


@pytest.mark.parametrize("arch,prompt_len,steps", [
    (ARCH, 11, 8),
    (RG, 20, 40),          # the ring of 32 rows wraps at step 12
    (LLAMA4, 11, 8),
    (XLSTM, 11, 8),
    (DSV2, 11, 8),         # the latent cache's row and mask from pos
    (QWEN2VL, 11, 8),      # M-RoPE's (3, B, 1) positions from pos
])
def test_decode_by_device_position_matches_host_path_and_reference(
        arch, prompt_len, steps):
    """A decode step driven by a device position (the captured step's
    input) on caches whose host length never moves gives the host-int
    step's logits bit for bit, and the reference's at TOL."""
    jcfg, tcfg = _cfgs(arch, **_stack(arch))
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    jdec = jax.jit(lambda p, t, c: decode_step(jcfg, p, t, c))
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                               prompt_len)
    jc = init_cache(jcfg, 1, 64, dtype=jnp.float32)
    jlog, jc = prefill(jcfg, jp, jnp.asarray(prompt[None], jnp.int32), jc)
    host, dev = (tm.init_cache(tcfg, 1, 64, dtype=torch.float32, device=CPU)
                 for _ in range(2))
    _, host = tm.prefill(tcfg, tp, torch.from_numpy(prompt[None]), host)
    _, dev = tm.prefill(tcfg, tp, torch.from_numpy(prompt[None]), dev)
    pos = torch.zeros((1,), dtype=torch.long)
    tok = int(jnp.argmax(jlog[0]))
    for n in range(steps):
        jlog, jc = jdec(jp, jnp.asarray([tok], jnp.int32), jc)
        hlog, host = tm.decode_step(tcfg, tp, torch.tensor([tok]), host)
        pos.fill_(prompt_len + n)
        dlog, _ = tm.decode_step(tcfg, tp, torch.tensor([tok]), dev, pos=pos)
        torch.testing.assert_close(dlog, hlog, rtol=0, atol=0)
        np.testing.assert_allclose(dlog.numpy(), np.asarray(jlog), **TOL)
        tok = int(jnp.argmax(jlog[0]))
    assert tt._cache_length(dev) == (0 if arch == XLSTM else prompt_len)
    for (_, d), (_, h) in zip(_items(dev), _items(host), strict=True):
        torch.testing.assert_close(d, h, rtol=0, atol=0)


@pytest.mark.parametrize("arch", [ARCH, RG, LLAMA4, XLSTM, DSV2])
def test_reset_cache_restores_init_cache_in_place(arch):
    _, tcfg = _cfgs(arch)
    caches = tm.init_cache(tcfg, 1, 48, dtype=torch.float32, device=CPU)
    ptrs = [t.data_ptr() for _, t in _items(caches)]
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    _, caches = tm.prefill(tcfg, params, torch.arange(1, 21)[None], caches)
    _, caches = tm.decode_step(tcfg, params, torch.tensor([5]), caches)
    out = tt.reset_cache(tcfg, caches)
    assert [t.data_ptr() for _, t in _items(out)] == ptrs
    fresh = tm.init_cache(tcfg, 1, 48, dtype=torch.float32, device=CPU)
    assert tt._cache_length(out) == 0
    _tree_close(out, fresh, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 37, 2048])
def test_mlstm_forward_matches_reference(S):
    """One mLSTM block: the step form (S = 1, from the state a 13-token
    prefill left), one chunk (37) and two chunks of 1024 (2048), with and
    without a state.  At 2048 the reference is its step form run token by
    token (the exact recurrence): its chunk form's second chunk reads the
    state the first left wrongly
    (test_mlstm_chunk_from_a_state_matches_the_reference_steps).  At 2048
    each output sums 1024 products that cancel (outputs in the hundreds):
    f32 sums in another order differ there by up to ~1e-4 of the output's
    largest value, so the absolute part of TOL scales with it."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = jx.init_mlstm_block(jcfg, jax.random.PRNGKey(5))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 13 if S == 1 else S,
                             jcfg.d_model)).astype(np.float32)
    js = jx.init_mlstm_state(jcfg, 2)
    ts = {k: v[0] for k, v in tx.init_mlstm_state(tcfg, 2, CPU).items()}
    if S > 1024:
        jout, js = _mlstm_steps(jcfg, jp, x)
    else:
        jout, js = jx.mlstm_forward(jcfg, jp, jnp.asarray(x), js)
    tout, ts = tx.mlstm_forward(tcfg, tp, torch.from_numpy(x), ts)
    if S == 1:
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, js = jx.mlstm_forward(jcfg, jp, jnp.asarray(x1), js)
        tout, ts = tx.mlstm_forward(tcfg, tp, torch.from_numpy(x1), ts)
    def scaled(ref):
        if S <= 1024:
            return TOL
        return dict(rtol=TOL["rtol"],
                    atol=TOL["atol"] * max(1.0, np.abs(ref).max()))

    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               **scaled(np.asarray(jout)))
    for k in ts:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   **scaled(np.asarray(js[k])))
    jno = jout if S > 1024 else jx.mlstm_forward(jcfg, jp, jnp.asarray(x))[0]
    tno, none = tx.mlstm_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(tno.numpy(), np.asarray(jno),
                               **scaled(np.asarray(jno)))


def _mlstm_steps(jcfg, jp, x):
    """The reference's mLSTM run token by token in its step form (the
    exact recurrence), from the initial state: outputs and final state."""
    def body(state, xt):
        out, state = jx.mlstm_forward(jcfg, jp, xt[:, None], state)
        return state, out[:, 0]

    state, outs = jax.jit(lambda xs: jax.lax.scan(
        body, jx.init_mlstm_state(jcfg, xs.shape[0]), xs.swapaxes(0, 1)))(
            jnp.asarray(x))
    return outs.swapaxes(0, 1), state


def test_mlstm_chunk_from_a_state_matches_the_reference_steps():
    """A 21-token input run as chunks of 5 and 16 from the state the
    first leaves (chunked prefill; a prompt past one chunk does the same)
    against the reference's exact recurrence, its step form token by
    token.  The reference's own chunk form contracts q with the carried
    C0's first axis, (q·v) k instead of C0 q = v (k·q), so its second
    chunk is far off (ROADMAP.md, Queue 3); its first chunk, from C0 = 0,
    is right."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = jx.init_mlstm_block(jcfg, jax.random.PRNGKey(5))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(5).standard_normal(
        (2, 21, jcfg.d_model)).astype(np.float32)
    js, steps = jx.init_mlstm_state(jcfg, 2), []
    for t in range(21):
        out, js = jx.mlstm_forward(jcfg, jp, jnp.asarray(x[:, t:t + 1]), js)
        steps.append(np.asarray(out))
    want = np.concatenate(steps, axis=1)
    ts = {k: v[0] for k, v in tx.init_mlstm_state(tcfg, 2, CPU).items()}
    jc = jx.init_mlstm_state(jcfg, 2)
    got, ref = [], []
    for sl in (slice(0, 5), slice(5, 21)):
        out, ts = tx.mlstm_forward(tcfg, tp, torch.from_numpy(x[:, sl]), ts)
        got.append(out.numpy())
        out, jc = jx.mlstm_forward(jcfg, jp, jnp.asarray(x[:, sl]), jc)
        ref.append(np.asarray(out))
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, **TOL)
    for k in ts:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), **TOL)
    np.testing.assert_allclose(ref[0], want[:, :5], **TOL)
    assert np.abs(ref[1] - want[:, 5:]).max() > 1.0


def test_mlstm_prompt_past_a_chunk_must_be_a_multiple_of_it():
    _, tcfg = _cfgs(XLSTM)
    jp = jx.init_mlstm_block(_cfgs(XLSTM)[0], jax.random.PRNGKey(5))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    with pytest.raises(ValueError, match="not a multiple"):
        tx.mlstm_forward(tcfg, tp, torch.zeros((1, 1100, tcfg.d_model)))


@pytest.mark.parametrize("S", [13, 1])
def test_slstm_forward_matches_reference(S):
    """One sLSTM block with its gated FFN tail: a 13-token prompt with a
    state, then (S = 1) one step from the state it left; and without a
    state."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = jx.init_slstm_block(jcfg, jax.random.PRNGKey(6))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    js = jx.init_slstm_state(jcfg, 2)
    ts = {k: v[0] for k, v in tx.init_slstm_state(tcfg, 2, CPU).items()}
    jout, js = jx.slstm_forward(jcfg, jp, jnp.asarray(x), js)
    tout, ts = tx.slstm_forward(tcfg, tp, torch.from_numpy(x), ts)
    if S == 1:
        x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jout, js = jx.slstm_forward(jcfg, jp, jnp.asarray(x1), js)
        tout, ts = tx.slstm_forward(tcfg, tp, torch.from_numpy(x1), ts)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    _tree_close(ts, js, **TOL)
    jno, _ = jx.slstm_forward(jcfg, jp, jnp.asarray(x))
    tno, none = tx.slstm_forward(tcfg, tp, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(tno.numpy(), np.asarray(jno), **TOL)


def test_reduced_xlstm_stack_amplifies_a_last_bit_change():
    """Why the value-parity tests run ``XLSTM_STACK``: in the reference
    alone, scaling the embedding by 1 + 1e-7 (about one f32 ulp) moves the
    reduced 16-block stack's logits by more than 0.1, a thousand times
    TOL, while the 4-block canary stack moves by less than TOL."""
    toks = jnp.asarray(np.random.default_rng(1).integers(0, 256, (2, 13)),
                       jnp.int32)
    moved = {}
    for name, kw in (("full", {}), ("canary", {"groups": XLSTM_STACK})):
        jcfg = _cfgs(XLSTM, **kw)[0]
        jp = init_params(jcfg, jax.random.PRNGKey(0))
        nudged = dict(jp, embed=jp["embed"] * (1 + 1e-7))
        a, b = (np.asarray(forward(jcfg, p, toks)[0]) for p in (jp, nudged))
        moved[name] = float(np.abs(a - b).max())
    assert moved["full"] > 0.1 and moved["canary"] < TOL["atol"], moved


def test_xlstm_prefill_then_decode_matches_the_full_forward():
    """The chunkwise prefill and the step-form decode against the
    teacher-forced forward, at the reference's own 2e-3 on its canary
    stack (``tests/test_attention.py``)."""
    jcfg, tcfg = _cfgs(XLSTM, groups=XLSTM_STACK)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab_size, (2, 12)))
    full, _ = tm.forward(tcfg, tp, toks)
    caches = tm.init_cache(tcfg, 2, 14, device=CPU)
    lp, caches = tm.prefill(tcfg, tp, toks[:, :-1], caches)
    torch.testing.assert_close(lp, full[:, -2], rtol=2e-3, atol=2e-3)
    ld, _ = tm.decode_step(tcfg, tp, toks[:, -1], caches)
    torch.testing.assert_close(ld, full[:, -1], rtol=2e-3, atol=2e-3)


def test_xlstm_cast_params_keeps_the_reference_f32_leaves():
    """At bf16 compute the projections are cast; the gates w_i/w_f, the
    recurrence r and the biases stay f32, as the reference reads them."""
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(XLSTM)),
                              compute_dtype="bfloat16")
    out = tm.cast_params(
        cfg, tm.init_params(cfg, torch.Generator().manual_seed(0), CPU))
    ml, sl = (out["groups"][0][k]["mixer"] for k in ("sub0", "sub7"))
    assert {k for k, v in ml.items() if v.dtype == torch.bfloat16} \
        == {"w_up", "w_q", "w_k", "w_v", "w_down"}
    assert {k for k, v in sl.items() if v.dtype == torch.bfloat16} \
        == {"w_in", "w_up", "w_down"}
