"""The ladder prefill (``repro_torch.serving.graphs``) on the CPU: its
plan, the flash kernel's plain version at a device q offset, and the
eager chunks at a device offset (``prefill(..., pos=)``, the twin of the
captured ones) against the JAX package's prefill of the same chunks and
of the whole prompt.  Reduced configs, f32 compute and f32 caches on both
sides, ``TOL`` as ``tests/test_torch_models.py`` uses it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, list_archs, reduced  # noqa: E402
from repro.configs.base import LayerGroup  # noqa: E402
from repro.models import decode_step, init_cache, init_params, prefill  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.kernels import flash_attention, flash_attention_plain  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import graphs as tg  # noqa: E402

XLSTM = "xlstm-1.3b"
#: the reference's canary stack, as tests/test_torch_models.py runs xLSTM
XLSTM_STACK = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)
#: the families the ladder serves, and those that prefill eagerly
LADDER = ("phi3-mini-3.8b", "qwen2-vl-7b", "musicgen-large", XLSTM,
          "minicpm-2b", "deepseek-coder-33b", "mistral-large-123b")
EAGER = ("recurrentgemma-2b", "llama4-maverick-400b-a17b",
         "deepseek-v2-236b")
CPU = torch.device("cpu")
#: f32 on both sides; the sums run in another order
TOL = dict(atol=1e-4, rtol=1e-4)
#: the caches' rows in the parity tests: the top rung is 32
MAX_LEN = 48
PROMPTS = (1, 2, 7, 21, 37)


def _cfgs(arch):
    """The same reduced config from each package, at f32 compute (xLSTM
    on its canary stack)."""
    kw = {"groups": XLSTM_STACK} if arch == XLSTM else {}
    return (dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype="float32", **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                                compute_dtype="float32", **kw))


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


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("R", [1, 2, 8, 32, 512])
def test_plan_covers_the_prompt_in_descending_powers_of_two(R):
    for L in range(1, 2 * R + 4):
        chunks = tg.plan(L, R)
        assert sum(chunks) == L
        assert all(c & (c - 1) == 0 and 1 <= c <= R for c in chunks)
        assert chunks == sorted(chunks, reverse=True)
        assert len(chunks) == L // R + bin(L % R).count("1")


@pytest.mark.parametrize("L,R", [(0, 8), (5, 0), (5, 6)])
def test_plan_refuses_an_empty_prompt_or_a_rung_not_a_power_of_two(L, R):
    with pytest.raises(ValueError):
        tg.plan(L, R)


@pytest.mark.parametrize("max_seq,top", [(1, 1), (2, 2), (48, 32), (64, 64),
                                         (1000, 512), (1024, 512),
                                         (4096, 512)])
def test_top_rung_is_the_largest_power_of_two_up_to_512(max_seq, top):
    assert tg.top_rung(max_seq) == top


# ---------------------------------------------------------------------------
# the flash kernel's plain version at a device offset
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("H,K,D,Sq,off", [
    (4, 4, 16, 2, 0),         # the smallest rung at the first row
    (4, 2, 16, 8, 13),        # GQA, a rung past an odd offset
    (8, 2, 32, 16, 32),       # a rung on a tile edge
    (4, 1, 64, 4, 44),        # MQA, the cache's last rows
])
def test_flash_plain_at_a_device_offset_over_the_whole_cache(H, K, D, Sq,
                                                             off):
    """At a (1,) tensor offset over the whole cache, zero past the chunk
    (as after a reset), the plain version gives what it gives at the int
    offset over the cache's first off + Sq rows, and the reference's
    chunked attention at that offset."""
    rng = np.random.default_rng(25)
    B, W = 2, MAX_LEN
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = np.zeros((B, W, K, D), np.float32)
    v = np.zeros((B, W, K, D), np.float32)
    k[:, :off + Sq] = rng.standard_normal((B, off + Sq, K, D))
    v[:, :off + Sq] = rng.standard_normal((B, off + Sq, K, D))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    at = torch.tensor([off])
    got = flash_attention(tq, tk, tv, q_offset=at)
    sliced = flash_attention(tq, tk[:, :off + Sq], tv[:, :off + Sq],
                             q_offset=off)
    np.testing.assert_allclose(got.numpy(), sliced.numpy(), rtol=2e-5,
                               atol=2e-5)
    ref = jl._chunk_scan_attn(jnp.asarray(q), jnp.asarray(k[:, :off + Sq]),
                              jnp.asarray(v[:, :off + Sq]), causal=True,
                              q_offset=off, window=None, q_block=8,
                              kv_block=16, scale=1.0 / np.sqrt(D))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    out, lse = flash_attention_plain(tq, tk, tv, q_offset=at, with_lse=True)
    want, want_lse = flash_attention_plain(tq, tk[:, :off + Sq],
                                           tv[:, :off + Sq], q_offset=off,
                                           with_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_flash_device_offset_is_one_int64_on_the_device_without_grad():
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 12, 2, 16))
    for bad in (torch.tensor([1, 2]), torch.tensor([1], dtype=torch.int32),
                torch.tensor(1)):
        with pytest.raises(ValueError, match="device q_offset"):
            flash_attention(q, kv, kv, q_offset=bad)
    with pytest.raises(NotImplementedError, match="q offset"):
        flash_attention(q.requires_grad_(), kv, kv,
                        q_offset=torch.tensor([0]))


@pytest.mark.parametrize("enabled", [True, False])
def test_a_capture_turns_the_cyclic_gc_off_and_back(enabled):
    """``GraphLaunches.capture()`` (around every capture of the port)
    keeps automatic collections out of the capture and restores the
    collector as it found it, also when the capture raises."""
    import gc

    from repro_torch.kernels import GraphLaunches
    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        with GraphLaunches().capture():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with GraphLaunches().capture():
                raise RuntimeError("a failed capture")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


# ---------------------------------------------------------------------------
# which families take the ladder
# ---------------------------------------------------------------------------
def test_the_ladder_takes_exactly_the_families_without_ring_mla_or_moe():
    assert set(LADDER) | set(EAGER) == set(list_archs())
    for arch in list_archs():
        for cfg in (tconfigs.get_config(arch),
                    tconfigs.reduced(tconfigs.get_config(arch))):
            assert tt.takes_ladder(cfg) == (arch in LADDER), arch


@pytest.mark.parametrize("arch", EAGER)
def test_a_prompt_at_a_device_offset_is_refused_where_the_ladder_is(arch):
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    caches = tm.init_cache(tcfg, 1, MAX_LEN, dtype=torch.float32, device=CPU)
    with pytest.raises(NotImplementedError, match="device offset"):
        tm.prefill(tcfg, params, torch.tensor([[3, 4, 5]]), caches,
                   pos=torch.tensor([0]))


def test_prefill_graphs_need_a_cuda_device():
    _, tcfg = _cfgs("phi3-mini-3.8b")
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    caches = [tm.init_cache(tcfg, 1, MAX_LEN, device=CPU)]
    with pytest.raises(ValueError, match="CUDA device"):
        tg.PrefillGraphs(tcfg, params, caches, None, MAX_LEN, CPU)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "recurrentgemma-2b"])
def test_the_cpu_engine_prefills_eagerly(arch):
    from repro_torch.launch.serve import graph_report
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    eng = ServingEngine(tcfg, params, max_slots=2, max_seq=32, device=CPU)
    assert eng.decode_graphs is None and eng.prefill_graphs is None
    eng.submit(np.arange(3, 10), max_new_tokens=2)
    assert all(len(r.generated) == 2 for r in eng.run())
    assert graph_report(eng).startswith("graphs: none")


# ---------------------------------------------------------------------------
# the eager chunks at a device offset against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["phi3-mini-3.8b", "qwen2-vl-7b",
                                        "musicgen-large", XLSTM])
def family(request):
    """(jcfg, tcfg, jax params, port params)."""
    jcfg, tcfg = _cfgs(request.param)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = tm.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("L", PROMPTS)
def test_ladder_prefill_matches_the_reference(family, L):
    """The eager ladder (``eager_ladder``: ``prefill(..., pos=)`` chunk
    by chunk in the plan's order, top rung 32 on 48-row caches) against
    the reference's ``prefill`` called on the same chunks in turn (last
    logits and every cache), and against its one-shot ``prefill`` of the
    whole prompt and 4 greedy decode steps.  xLSTM is held against the
    one-shot prefill only: the reference's mLSTM chunk from a carried
    state is wrong (ROADMAP.md, Queue 3)."""
    jcfg, tcfg, jp, tp = family
    R = tg.top_rung(MAX_LEN)
    prompt = np.random.default_rng(L).integers(
        0, jcfg.vocab_size, (1, L)).astype(np.int32)
    tlog, tc = tg.eager_ladder(
        tcfg, tp, torch.from_numpy(prompt).long(),
        tm.init_cache(tcfg, 1, MAX_LEN, dtype=torch.float32, device=CPU), R)
    assert tt._cache_length(tc) == (0 if jcfg.arch_id == XLSTM else L)
    if jcfg.arch_id != XLSTM:
        jc = init_cache(jcfg, 1, MAX_LEN, dtype=jnp.float32)
        start = 0
        for r in tg.plan(L, R):
            chunk = jnp.asarray(prompt[:, start:start + r])
            jlog, jc = prefill(jcfg, jp, chunk, jc)
            start += r
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert tt._cache_length(tc) == int(jtr._cache_length(jc))
        _tree_close(tc, jax.tree.map(np.asarray, jc), **TOL)
    jlog, jc = prefill(jcfg, jp, jnp.asarray(prompt),
                       init_cache(jcfg, 1, MAX_LEN, dtype=jnp.float32))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _tree_close(tc, jax.tree.map(np.asarray, jc), **TOL)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(4):
        jlog, jc = decode_step(jcfg, jp, jnp.asarray(tok), jc)
        tlog, tc = tm.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert int(tlog[0].argmax()) == int(tok[0])


class _NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises on what a CUDA-graph capture of a chunk refuses and the CPU
    can show: a read of a device value on the host, a data-dependent
    shape and a tensor made from host data."""

    REFUSED = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise AssertionError(f"a prompt chunk calls {func}, which a "
                                 f"CUDA-graph capture refuses")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", LADDER)
def test_ladder_chunks_can_be_captured(arch):
    """Every chunk of a 37-token prompt (32 + 4 + 1) of every ladder
    family reads no device value on the host and makes no host tensor,
    every cache tensor keeps its address (a captured chunk reads those
    addresses), and the chunks' logits are the one-shot prefill's at
    TOL."""
    _, tcfg = _cfgs(arch)
    params = tm.init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    tokens = torch.arange(3, 40)[None] % tcfg.vocab_size
    caches = tm.init_cache(tcfg, 1, MAX_LEN, dtype=torch.float32, device=CPU)
    ptrs = [t.data_ptr() for t in _tensors(caches)]
    with _NoHostSync():
        logits, out = tg.eager_ladder(tcfg, params, tokens, caches,
                                      tg.top_rung(MAX_LEN))
    assert [t.data_ptr() for t in _tensors(out)] == ptrs
    want, _ = tm.prefill(tcfg, params, tokens, tm.init_cache(
        tcfg, 1, MAX_LEN, dtype=torch.float32, device=CPU))
    torch.testing.assert_close(logits, want, **TOL)
