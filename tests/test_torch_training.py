"""The port's training path against the JAX package's: schedules, AdamW
leaf by leaf, the flash-attention and RG-LRU-scan backwards (plain
versions) against ``jax.vjp`` of the reference's functions, ``loss_fn``
and its gradients for reduced minicpm-2b (dense), recurrentgemma (hybrid),
llama4 (MoE, the router's gradient and the aux), deepseek-v2 (MLA),
xLSTM (mLSTM and sLSTM) and qwen2-vl (M-RoPE, patch embeddings in the
batch) under every remat policy, three train steps with and without
accumulation, checkpoints
(round trip, atomicity, gc, and a checkpoint of either package restored
by the other), the data pipeline, and the train launcher on the CPU.
Inputs are made from seeds with numpy or by the reference and carried
over as numpy arrays."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.configs.base import LayerGroup  # noqa: E402
from repro.data import SyntheticSource as JSource  # noqa: E402
from repro.models import frontends as jfront  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import Executor, Heteroflow  # noqa: E402
from repro_torch.data import (MemmapSource, Pipeline, PipelineConfig,  # noqa: E402
                              SyntheticSource)
from repro_torch.kernels import (flash_attention, flash_attention_bwd,  # noqa: E402
                                 flash_attention_bwd_plain,
                                 flash_attention_plain, rglru_scan,
                                 rglru_scan_bwd_plain)
from repro_torch.models import (loss_fn, params_from_numpy,  # noqa: E402
                                train_state_from_numpy)
from repro_torch.training import (AdamWConfig, adamw_update, checkpoint,  # noqa: E402
                                  cosine_schedule, init_opt_state,
                                  init_train_state, make_train_step,
                                  wsd_schedule)
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.checkpoint import _flatten  # noqa: E402

CPU = torch.device("cpu")
MINICPM, RG = "minicpm-2b", "recurrentgemma-2b"
LLAMA4 = "llama4-maverick-400b-a17b"
DSV2, XLSTM, QWEN2VL = "deepseek-v2-236b", "xlstm-1.3b", "qwen2-vl-7b"
FAMILIES = (MINICPM, RG, LLAMA4, DSV2, XLSTM, QWEN2VL)
#: xLSTM trains the reference's canary stack (one mLSTM and one sLSTM
#: block, twice): the reduced 16-block stack turns a last-bit difference
#: into a logit difference past 0.1 in the reference itself
#: (tests/test_torch_models.py::XLSTM_STACK)
XLSTM_STACK = (LayerGroup(pattern=("mlstm", "slstm"), count=2, ffn="none"),)
#: schedules: f32 on both sides, pow/cos may differ in the last bit
SCHED_TOL = dict(rtol=1e-6, atol=1e-6)
#: AdamW: the same f32 operations, some fused differently
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)
#: the reference's own tolerance for its flash backward
#: (tests/test_attention.py::test_flash_vjp_matches_reference)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)
#: losses and gradients of a reduced model at f32 compute: sums taken in
#: another order through a few layers (the forward's logits hold 1e-4 in
#: tests/test_torch_models.py); a gradient leaf's atol is GRAD_ATOL of its
#: largest element, since its small elements are sums that cancel (the
#: router's: 2e-5 of its largest)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_ATOL = 1e-4
#: parameters after three AdamW steps at lr 1e-3: the update is
#: m/(sqrt(v) + eps), which turns a relative difference r of a gradient
#: element near eps into a step difference of up to lr·r; the smallest
#: gradient elements differ by a few 1e-2 relative (sums that cancel: the
#: router's by 2e-2, see GRAD_ATOL), so 3 steps move a weight by up to
#: 3·1e-3·3e-2 ≈ 1e-4
STEP_TOL = dict(rtol=1e-5, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    return np.asarray(x)


def _tree_np(tree):
    """A nested tree of tensors as the same tree of numpy copies: JAX on
    the CPU may alias a numpy array's memory, which the port's step then
    updates in place while JAX's asynchronous step still reads it."""
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return np.array(_np(tree), copy=True)


def _flat_np(tree) -> dict:
    return {k: _np(v) for k, v in _flatten(tree).items()}


def _assert_trees_close(got, want, **tol):
    g, w = _flat_np(got), _flat_np(want)
    assert g.keys() == w.keys()
    for key in sorted(w):
        np.testing.assert_allclose(g[key], w[key], err_msg=repr(key), **tol)


def _cfgs(arch, **kw):
    """The same reduced config from each package, at f32 compute (xLSTM:
    its canary stack)."""
    if arch == XLSTM:
        kw.setdefault("groups", XLSTM_STACK)
    return (dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype="float32", **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                                compute_dtype="float32", **kw))


def _batch(vocab, B=4, S=16, seed=0, cfg=None):
    """A SyntheticSource batch with masked labels; for the vision stub
    (``cfg``) also the reference's ``make_patch_embeds`` from ``seed``, as
    f32 numpy (bf16 widens exactly)."""
    b = JSource(vocab, seed=seed).batch(0, B, S)
    b["labels"] = b["labels"].copy()
    b["labels"][0, :3] = -100                     # masked labels
    if cfg is not None and cfg.frontend == "vision_stub":
        b["extra_embeds"] = np.asarray(jfront.make_patch_embeds(
            jax.random.PRNGKey(100 + seed), B, cfg.n_visual_tokens,
            cfg.d_model).astype(jnp.float32))
    return b


# ---------------------------------------------------------------------------
# schedules and AdamW
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["cosine", "wsd"])
def test_schedules_match_reference(which):
    if which == "cosine":
        jf = jopt.cosine_schedule(3e-4, 5, 50, floor=0.1)
        tf = cosine_schedule(3e-4, 5, 50, floor=0.1)
    else:
        jf = jopt.wsd_schedule(3e-4, 10, 20, 10, floor=0.01)
        tf = wsd_schedule(3e-4, 10, 20, 10, floor=0.01)
    steps = np.arange(60, dtype=np.int32)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(steps)))
    got = tf(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, **SCHED_TOL)


def _opt_tree(rng):
    """A params-shaped tree with a matrix, a stacked (count, d) norm (2-d:
    decayed), a vector (not decayed) and a 3-d expert weight."""
    shapes = {"embed": (16, 8), "final_norm": (8,),
              "groups": [{"sub0": {"norm1": (2, 8),
                                   "ffn": {"w_up": (2, 3, 8, 4)}}}]}

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        return rng.standard_normal(tree).astype(np.float32)
    return draw(shapes)


def test_adamw_update_matches_reference_leaf_by_leaf():
    rng = np.random.default_rng(0)
    params, grads = _opt_tree(rng), _opt_tree(rng)
    m = jax.tree.map(lambda x: 0.1 * x, _opt_tree(rng))
    v = jax.tree.map(lambda x: np.abs(x), _opt_tree(rng))
    jcfg = jopt.AdamWConfig(schedule=jopt.cosine_schedule(1e-2, 2, 20),
                            grad_clip=0.5)
    tcfg = AdamWConfig(schedule=cosine_schedule(1e-2, 2, 20), grad_clip=0.5)
    jstate = {"m": m, "v": v, "step": jnp.int32(3)}
    jp, jo, jm = jopt.adamw_update(jcfg, grads, params, jstate)
    tp = params_from_numpy(params, CPU)
    tstate = {"m": params_from_numpy(m, CPU), "v": params_from_numpy(v, CPU),
              "step": torch.tensor(3, dtype=torch.int32)}
    _, to, tm = adamw_update(tcfg, params_from_numpy(grads, CPU), tp, tstate)
    _assert_trees_close(tp, jp, **ADAM_TOL)
    _assert_trees_close(to["m"], jo["m"], **ADAM_TOL)
    _assert_trees_close(to["v"], jo["v"], **ADAM_TOL)
    assert int(to["step"]) == int(jo["step"]) == 4
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    # the stacked norm decays (ndim 2), the vector does not: with a zero
    # gradient only the decay moves a weight
    zero = jax.tree.map(np.zeros_like, grads)
    tp2 = params_from_numpy(params, CPU)
    st = init_opt_state(tp2)
    adamw_update(tcfg, params_from_numpy(zero, CPU), tp2, st)
    assert not torch.equal(tp2["groups"][0]["sub0"]["norm1"],
                           torch.from_numpy(params["groups"][0]["sub0"]["norm1"]))
    assert torch.equal(tp2["final_norm"], torch.from_numpy(params["final_norm"]))


# ---------------------------------------------------------------------------
# the kernels' backwards (plain versions)
# ---------------------------------------------------------------------------
ATTN_CASES = [
    # B, S, H, K, D, Dv, window
    (2, 40, 4, 2, 16, 16, None),       # GQA
    (1, 70, 6, 1, 8, 8, 24),           # MQA + sliding window
    (2, 33, 2, 2, 24, 16, None),       # Dv != D (MLA-like)
    (1, 50, 4, 4, 16, 16, 7),          # MHA + short window
]


def _attn_inputs(B, S, H, K, D, Dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, Dv)).astype(np.float32),
            rng.standard_normal((B, S, H, Dv)).astype(np.float32))


@pytest.mark.parametrize("B,S,H,K,D,Dv,win", ATTN_CASES)
def test_flash_bwd_plain_matches_jax_vjp(B, S, H, K, D, Dv, win):
    q, k, v, do = _attn_inputs(B, S, H, K, D, Dv)
    out_j, vjp = jax.vjp(lambda *a: jl.attention(
        *a, causal=True, window=win, q_block=16, kv_block=32),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention_plain(tq, tk, tv, window=win, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **BWD_TOL)
    got = flash_attention_bwd_plain(tq, tk, tv, out, torch.from_numpy(do),
                                    lse, window=win)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    # the wrapper on CPU tensors is the plain version
    for g, w in zip(flash_attention_bwd(tq, tk, tv, out,
                                        torch.from_numpy(do), lse,
                                        window=win), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,S,H,K,D,Dv,win", ATTN_CASES[:2])
def test_flash_lse_matches_reference(B, S, H, K, D, Dv, win):
    q, k, v, _ = _attn_inputs(B, S, H, K, D, Dv, seed=1)
    _, lse_j = jl._chunk_scan_attn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, q_offset=0,
                                   window=win, q_block=S, kv_block=16,
                                   scale=D ** -0.5, with_lse=True)
    _, lse = flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                   window=win, with_lse=True)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_j)[..., :S].reshape(B, H, S),
                               **BWD_TOL)


@pytest.mark.parametrize("B,S,H,K,D,Dv,win", ATTN_CASES[:2])
def test_flash_autograd_matches_torch_autograd_of_plain(B, S, H, K, D, Dv,
                                                        win):
    q, k, v, do = (torch.from_numpy(x)
                   for x in _attn_inputs(B, S, H, K, D, Dv, seed=2))
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*ins, window=win).backward(do)
        grads.append([t.grad for t in ins])
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL)


@pytest.mark.parametrize("B,S,dr", [(2, 16, 8), (1, 5, 3)])
def test_rglru_scan_bwd_plain_matches_jax_vjp(B, S, dr):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, dr)).astype(np.float32)
    a = rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32)
    h0 = rng.standard_normal((B, dr)).astype(np.float32)
    dy = rng.standard_normal((B, S, dr)).astype(np.float32)
    out_j, want = jax.jit(lambda *t: (lambda o, f: (o, f(t[3])))(
        *jax.vjp(jrec.rglru_scan, *t[:3])))(
            *(jnp.asarray(t) for t in (x, a, h0, dy)))
    h = torch.from_numpy(np.array(out_j))
    got = rglru_scan_bwd_plain(torch.from_numpy(dy), torch.from_numpy(a), h,
                               torch.from_numpy(h0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    # and through the autograd Function on CPU tensors
    ins = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, h0)]
    rglru_scan(*ins).backward(torch.from_numpy(dy))
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **BWD_TOL)


# ---------------------------------------------------------------------------
# loss, gradients and steps of reduced models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(jcfg, tcfg, the reference's train state, its loss/grads on one
    batch, the batch)."""
    jcfg, tcfg = _cfgs(request.param)
    jstate = jtrainer.init_train_state(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg.vocab_size, cfg=jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(jcfg, p, jb, remat_policy="none"),
        has_aux=True))(jstate["params"])
    return jcfg, tcfg, jstate, (loss, aux, grads), batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_grads_match_reference(family, remat):
    jcfg, tcfg, jstate, (loss, aux, grads), batch = family
    params = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                               CPU)
    for t in _flatten(params).values():
        t.requires_grad_(True)
    tloss, taux = loss_fn(tcfg, params, _torch_batch(batch),
                          remat_policy=remat)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(loss), **MODEL_TOL)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(taux[k]), float(aux[k]),
                                   **MODEL_TOL)
    got = {k: t.grad for k, t in _flatten(params).items()}
    want = _flat_np(grads)
    assert got.keys() == want.keys()
    for key in sorted(want):
        scale = float(np.abs(want[key]).max()) or 1.0
        np.testing.assert_allclose(got[key].numpy(), want[key],
                                   rtol=MODEL_TOL["rtol"],
                                   atol=GRAD_ATOL * scale,
                                   err_msg=repr(key))
    if jcfg.moe.n_experts:
        router = [k for k in want if k.endswith("router")]
        assert router and all(np.abs(want[k]).max() > 0 for k in router)
        assert float(aux["aux_loss"]) > 0


def test_a_gradient_at_a_q_offset_still_raises():
    """A prompt at a cache offset is not differentiated: the reference's
    custom VJP covers q_offset 0 only, so the Function refuses a gradient
    there, through the layer as through the wrapper; without a gradient
    the same call runs."""
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    kv = torch.zeros((1, 9, 2, 16))
    with pytest.raises(NotImplementedError, match="q offset"):
        flash_attention(q, kv, kv, q_offset=5)
    from repro_torch.models.layers import attention
    with pytest.raises(NotImplementedError, match="q offset"):
        attention(q, kv, kv, q_offset=5)
    with torch.no_grad():
        assert attention(q, kv, kv, q_offset=5).shape == (1, 4, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention(q.detach(), kv, kv, q_offset=-1)


@pytest.mark.parametrize("arch,accum,remat", [
    (MINICPM, 1, "none"), (MINICPM, 2, "full"), (RG, 1, "dots"),
    (LLAMA4, 2, "full"), (DSV2, 2, "full"), (XLSTM, 1, "dots"),
    (QWEN2VL, 1, "full")])
def test_three_train_steps_match_reference(arch, accum, remat):
    """Three AdamW steps of each package from one state: per-step losses,
    gradient norm and lr at MODEL_TOL, params at STEP_TOL.  xLSTM's steps
    start each from the port's state carried into the reference: Adam's
    first step moves its weights apart by up to lr·r (STEP_TOL's note),
    and its exponential gates turn that into more than MODEL_TOL of the
    next step's gradient norm, in either package; its gradients at one
    state agree at MODEL_TOL."""
    jcfg, tcfg = _cfgs(arch)
    jstate = jtrainer.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    jopt_cfg = jopt.AdamWConfig(schedule=jopt.wsd_schedule(1e-3, 1, 10, 5))
    topt_cfg = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    jstep = jax.jit(jtrainer.make_train_step(jcfg, jopt_cfg,
                                             remat_policy="none",
                                             accum=accum))
    tstep = make_train_step(tcfg, topt_cfg, remat_policy=remat, accum=accum)
    for i in range(3):
        batch = _batch(jcfg.vocab_size, seed=i, cfg=jcfg)
        if arch == XLSTM:
            jstate = jax.tree.map(jnp.asarray, _tree_np(tstate))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, _torch_batch(batch))
        for k in ("total_loss", "loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **MODEL_TOL, err_msg=f"step {i} {k}")
    _assert_trees_close(tstate["params"], jstate["params"], **STEP_TOL)
    assert int(tstate["opt"]["step"]) == 3


def test_accumulation_splits_the_patch_embeddings_with_the_batch():
    """accum 2 on a qwen2-vl batch that carries patch embeddings: each
    microbatch takes its own rows of them, as the reference's step splits
    every entry of the batch along B.  One step from one state: loss,
    total loss and gradient norm against the reference's accum-2 step at
    MODEL_TOL.  (Its params are not compared at STEP_TOL: an element of
    layer 0's wk whose gradient is a sum that cancels below Adam's eps
    moves past STEP_TOL there, by up to lr·r.)"""
    jcfg, tcfg = _cfgs(QWEN2VL)
    jstate = jtrainer.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    batch = _batch(jcfg.vocab_size, seed=3, cfg=jcfg)
    assert batch["extra_embeds"].shape[:2] == (4, jcfg.n_visual_tokens)
    jopt_cfg = jopt.AdamWConfig(schedule=jopt.wsd_schedule(1e-3, 1, 10, 5))
    topt_cfg = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    _, jm = jax.jit(jtrainer.make_train_step(jcfg, jopt_cfg, accum=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm = make_train_step(tcfg, topt_cfg, accum=2)(tstate,
                                                      _torch_batch(batch))
    for k in ("total_loss", "loss", "grad_norm", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **MODEL_TOL,
                                   err_msg=k)


def _accum_grads(monkeypatch, jcfg, tcfg, jstate, tstate, batch, accum):
    """The gradients each package's train step hands AdamW (accumulated
    over ``accum`` microbatches and averaged) from one state, as two
    dicts of numpy arrays keyed by leaf path."""
    jorig, torig = jopt.adamw_update, topt.adamw_update
    seen = {}

    def jcapture(cfg, grads, params, opt_state):
        new_params, new_opt, m = jorig(cfg, grads, params, opt_state)
        return new_params, new_opt, dict(m, grads=grads)

    def tcapture(cfg, grads, params, opt_state):
        seen["grads"] = [g.clone() for g in grads]
        return torig(cfg, grads, params, opt_state)

    monkeypatch.setattr(jopt, "adamw_update", jcapture)
    monkeypatch.setattr(topt, "adamw_update", tcapture)
    jopt_cfg = jopt.AdamWConfig(schedule=jopt.wsd_schedule(1e-3, 1, 10, 5))
    topt_cfg = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    _, jm = jax.jit(jtrainer.make_train_step(jcfg, jopt_cfg, accum=accum))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    names = {id(t): k for k, t in _flatten(tstate["params"]).items()}
    make_train_step(tcfg, topt_cfg, accum=accum)(tstate, _torch_batch(batch))
    got = {names[id(t)]: g.numpy() for t, g in
           zip(topt.leaves(tstate["params"]), seen["grads"])}
    return got, _flat_np(jm["grads"])


def test_accumulation_gradients_match_reference_for_the_vision_stub(
        monkeypatch):
    """qwen2-vl at accum 2 on a batch that carries patch embeddings, from
    one shared state: every leaf of the accumulated gradient against the
    reference's at GRAD_ATOL of the leaf's largest element — each
    microbatch takes its own rows of the embeddings.  (After Adam's first
    step one element of layer 0's wk ends 1.06e-4 from the reference's:
    its gradient is a sum that cancels to ~eps, ROADMAP.md Queue 3.)"""
    jcfg, tcfg = _cfgs(QWEN2VL)
    jstate = jtrainer.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    batch = _batch(jcfg.vocab_size, seed=0, cfg=jcfg)
    assert batch["extra_embeds"].shape[:2] == (4, jcfg.n_visual_tokens)
    got, want = _accum_grads(monkeypatch, jcfg, tcfg, jstate, tstate, batch,
                             accum=2)
    assert got.keys() == want.keys()
    for key in sorted(want):
        scale = float(np.abs(want[key]).max()) or 1.0
        np.testing.assert_allclose(got[key], want[key],
                                   rtol=MODEL_TOL["rtol"],
                                   atol=GRAD_ATOL * scale, err_msg=repr(key))


def test_bf16_compute_trains_the_router():
    """bf16 compute casts the whole float tree, the router too; the
    logits stay an f32 product (the reference's promoted
    ``(xg @ router_w).astype(f32)``) and the router gets a gradient."""
    cfg = tconfigs.reduced(tconfigs.get_config(LLAMA4))
    assert cfg.compute_dtype == "bfloat16"
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    step = make_train_step(cfg, AdamWConfig(
        schedule=cosine_schedule(1e-3, 1, 10)), remat_policy="none")
    router = state["params"]["groups"][0]["sub0"]["ffn"]["router"]
    before = router.detach().clone()
    _, m = step(state, _torch_batch(_batch(cfg.vocab_size)))
    assert np.isfinite(float(m["total_loss"])) and float(m["aux_loss"]) > 0
    assert not torch.equal(router.detach(), before)


# ---------------------------------------------------------------------------
# a step that can be captured in a CUDA graph (training/graphs.py)
# ---------------------------------------------------------------------------
class _NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    """Raises on what a CUDA-graph capture of the step refuses and the CPU
    can show: a read of a device value on the host (``.item()``,
    ``float()``, a check of indices), a data-dependent shape (``nonzero``,
    boolean masks) and a tensor made from host data (``torch.tensor``: a
    copy from pageable memory on the card)."""

    REFUSED = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise AssertionError(f"the train step calls {func}, which a "
                                 f"CUDA-graph capture refuses")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_can_be_captured(arch, accum, remat):
    """Three eager steps of every trained family (the vision stub with
    patch embeddings in the batch) read no device value on the host and
    make no host tensor, and every state tensor keeps its address: a
    CUDA graph captured over the step reads those addresses.  (On the
    card, tests/test_torch_cuda.py holds the replayed step to the eager
    one bit for bit.)"""
    jcfg, tcfg = _cfgs(arch)
    state = init_train_state(tcfg, torch.Generator().manual_seed(0), CPU)
    ptrs = {k: t.data_ptr() for k, t in _flatten(state).items()}
    step = make_train_step(tcfg, AdamWConfig(
        schedule=wsd_schedule(1e-3, 1, 10, 5)), remat_policy=remat,
        accum=accum)
    for i in range(3):
        batch = _torch_batch(_batch(jcfg.vocab_size, seed=i, cfg=jcfg))
        with _NoHostSync():
            got, m = step(state, batch)
        assert got is state
        assert all(np.isfinite(float(v)) for v in m.values())
    assert {k: t.data_ptr() for k, t in _flatten(state).items()} == ptrs
    assert all(p.grad is None for p in topt.leaves(state["params"]))
    assert int(state["opt"]["step"]) == 3


def test_graph_launches_take_back_a_capture_and_add_each_replay():
    """``kernels.GraphLaunches``: what the wrappers count while a graph is
    captured (a capture launches nothing) is taken back from the six
    counters and becomes the graph's launches per replay; each replay of
    the graph (here a stand-in with ``replay()``) adds them."""
    from repro_torch import kernels

    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    assert set(kernels.COUNTED) == {
        "flash_attention", "flash_attention_bwd", "decode_attention",
        "rglru_scan", "rglru_scan_bwd", "moe_gating"}
    start = kernels.launch_counts()
    counts = kernels.GraphLaunches()
    with counts.capture():
        kernels.flash_attention.launches += 4
        kernels.flash_attention_bwd.launches += 2
        kernels.rglru_scan_bwd.launches += 1
    assert kernels.launch_counts() == start
    assert counts.per_replay == dict.fromkeys(kernels.COUNTED, 0) | {
        "flash_attention": 4, "flash_attention_bwd": 2, "rglru_scan_bwd": 1}
    graph = FakeGraph()
    for n in (1, 2, 3):
        counts.replay(graph)
        assert graph.replays == n
        assert kernels.launch_counts() == {
            k: start[k] + n * counts.per_replay[k] for k in start}
    decode = kernels.GraphLaunches(["decode_attention", "moe_gating"])
    with decode.capture():
        kernels.decode_attention.launches += 3
        kernels.flash_attention.launches += 1       # not watched: kept
    assert decode.per_replay == {"decode_attention": 3, "moe_gating": 0}
    kernels.flash_attention.launches -= 1
    for name, n in start.items():                   # leave them as found
        getattr(kernels, name).launches = n


@pytest.mark.slow
@pytest.mark.parametrize("accum", [1, 2])
def test_memorization_drives_loss_down(accum):
    cfg = tconfigs.reduced(tconfigs.get_config("phi3-mini-3.8b"))
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    opt = AdamWConfig(schedule=wsd_schedule(3e-4, 5, 50, 10),
                      weight_decay=0.0)
    step = make_train_step(cfg, opt, remat_policy="none", accum=accum)
    batch = _torch_batch(SyntheticSource(cfg.vocab_size).batch(0, 4, 16))
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["total_loss"]))
    assert losses[-1] < losses[0] - 0.5
    assert float(m["grad_norm"]) > 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_state():
    cfg = tconfigs.reduced(tconfigs.get_config(MINICPM))
    return init_train_state(cfg, torch.Generator().manual_seed(0), CPU)


def _assert_same(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_checkpoint_roundtrip_and_gc(small_state, tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(d, s, small_state, keep=3)
    assert checkpoint.latest_step(d) == 5
    assert len([k for k in os.listdir(d) if k.startswith("step_")]) == 3
    restored, s = checkpoint.restore(d, small_state)
    assert s == 5
    _assert_same(restored, small_state)


def test_checkpoint_atomicity_no_partial_dirs(small_state, tmp_path):
    checkpoint.save(str(tmp_path), 7, small_state)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), small_state)


def test_checkpoints_restore_across_packages(tmp_path):
    jcfg = reduced(get_config(MINICPM))
    jstate = jtrainer.init_train_state(jcfg, jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    # the reference's checkpoint into the port
    jckpt.save(str(tmp_path / "j"), 3, jstate)
    got, s = checkpoint.restore(str(tmp_path / "j"), tstate)
    assert s == 3
    _assert_same(got, tstate)
    # the port's checkpoint into the reference: the same files
    checkpoint.save(str(tmp_path / "t"), 4, tstate)
    back, s = jckpt.restore(str(tmp_path / "t"), jax.eval_shape(
        lambda: jstate))
    assert s == 4
    for key, arr in _flat_np(back).items():
        np.testing.assert_array_equal(arr, _flat_np(jstate)[key])
    assert sorted(os.listdir(tmp_path / "t" / "step_00000004")) == sorted(
        os.listdir(tmp_path / "j" / "step_00000003"))


def test_async_save_snapshots_before_the_next_step(small_state, tmp_path):
    state = {k: v for k, v in small_state.items()}
    want = {k: t.clone() for k, t in _flatten(state).items()}
    with Executor(num_workers=2, devices=[CPU]) as ex:
        fut = checkpoint.async_save(ex, str(tmp_path), 3, state)
        with torch.no_grad():           # the next step changes the state
            for t in _flatten(state["params"]).values():
                t.add_(1.0)
        fut.result(timeout=120)
        for t in _flatten(state["params"]).values():
            with torch.no_grad():
                t.sub_(1.0)
    restored, _ = checkpoint.restore(str(tmp_path), small_state)
    for k, t in _flatten(restored).items():
        assert torch.equal(t, want[k]), k


# ---------------------------------------------------------------------------
# data and the launcher
# ---------------------------------------------------------------------------
def test_synthetic_source_is_the_reference_bit_for_bit():
    for seed, step, B, S, V in [(0, 0, 4, 16, 256), (7, 3, 2, 9, 122753)]:
        got = SyntheticSource(V, seed=seed).batch(step, B, S)
        want = JSource(V, seed=seed).batch(step, B, S)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_memmap_source_and_pipeline_graph(tmp_path):
    path = tmp_path / "toks.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    b = MemmapSource(str(path), vocab_size=10_000).batch(0, 2, 16)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    pipe = Pipeline(SyntheticSource(100), PipelineConfig(batch=2, seq=8))
    buffer, got = {}, []
    hf = Heteroflow("data")
    _, pt, pl = pipe.host_task_graph(hf, buffer, sharding=CPU)
    sink = hf.host(lambda: got.append(pt.device_data().clone()))
    sink.succeed(pt, pl)
    with Executor(num_workers=2, devices=[CPU]) as ex:
        assert ex.run_n(hf, 3).result(timeout=60) == 3
    assert pipe._step == 3 and len(got) == 3
    assert isinstance(got[0], torch.Tensor) and got[0].shape == (2, 8)
    np.testing.assert_array_equal(
        got[2].numpy(), SyntheticSource(100).batch(2, 2, 8)["tokens"])


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::tc::dkdv_tc_kernel<1, 1>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::Params)",
     "port"),
    ("void (anonymous namespace)::tc::dq_tc_kernel<4, 4>(CUtensorMap, "
     "CUtensorMap, CUtensorMap, CUtensorMap, (anonymous namespace)::Params)",
     "port"),
    ("void (anonymous namespace)::dkdv_kernel<float, 64, 64, 4>("
     "(anonymous namespace)::Params)", "port"),
    ("(anonymous namespace)::tc::delta_tc_kernel((anonymous namespace)::"
     "Params)", "port"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
     "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas", "matmul"),
    ("void at::native::(anonymous namespace)::reduce_kernel<512, 1, "
     "at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
     "at::native::sum_functor<float, float, float>::operator()"
     "(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, "
     "float, 4, 4> >(at::native::ReduceOp<float, float, unsigned int, "
     "float, 4, 4>)", "other"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >("
     "int, at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3>)",
     "other"),
])
def test_profile_groups_kernel_names(name, group):
    """The profile's groups: the port's kernels (anonymous namespaces, the
    tensor-core backward's too), cuBLAS products, and PyTorch's own
    kernels, whose names carry ``at::`` even where a port kernel's name is
    part of theirs."""
    from repro_torch.launch.profile_train import group_of

    assert group_of(name) == group


def test_train_launcher_on_cpu(capsys, tmp_path):
    from repro_torch.launch import train

    ck = str(tmp_path / "ck")
    assert train.main(["--arch", MINICPM, "--reduced", "--device", "cpu",
                       "--steps", "4", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", ck, "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert "step 4: loss=" in out and "tok/s" in out
    assert checkpoint.latest_step(ck) == 4
    assert train.main(["--arch", MINICPM, "--reduced", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "16",
                       "--remat", "full", "--ckpt-dir", ck, "--resume"]) == 0
    assert "resumed from step 4" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [DSV2, XLSTM, QWEN2VL])
def test_train_launcher_trains_mla_xlstm_and_the_vision_backbone(capsys,
                                                                 arch):
    """The launcher trains the families ``make_train_step`` refused
    before, on text tokens as the reference's launcher feeds them."""
    from repro_torch.launch import train

    assert train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "nan" not in out
