"""The port's decoder against the JAX package's: reduced phi3-mini at f32
compute, with the JAX parameters carried over through
``params_from_numpy``, gives the same logits and greedy tokens."""
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
from repro.models import decode_step, forward, init_cache, init_params, prefill  # noqa: E402
from repro.models import layers as jl  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ARCH = "phi3-mini-3.8b"
CPU = torch.device("cpu")
#: f32 on both sides; the sums run in another order
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs():
    """The same reduced config from each package, at f32 compute."""
    return (dataclasses.replace(reduced(get_config(ARCH)),
                                compute_dtype="float32"),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ARCH)),
                                compute_dtype="float32"))


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


def test_chunked_prefill_is_not_ported_yet(rig):
    _, tcfg, _, tp = rig
    tc = tm.init_cache(tcfg, 1, 32, device=CPU)
    _, tc = tm.prefill(tcfg, tp, torch.tensor([[1, 2, 3]]), tc)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tm.prefill(tcfg, tp, torch.tensor([[4, 5]]), tc)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "recurrentgemma-2b",
                                  "xlstm-1.3b", "llama4-maverick-400b-a17b",
                                  "qwen2-vl-7b", "musicgen-large"])
def test_later_families_raise_not_implemented(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    with pytest.raises(NotImplementedError):
        tm.init_params(cfg, torch.Generator().manual_seed(0), CPU)


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(cfg, 1, 8)
