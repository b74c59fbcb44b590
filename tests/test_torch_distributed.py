"""The port's distributed layer against the JAX package's: the sharding
rules (params, train state, batch and caches of all ten archs on the
reference's shape-only stand-in meshes, exact), the meta-device shape
skeletons, the activation-sharding context (dispatch conditions and
constraint specs, exact), the pipeline as a scheduled task graph (graph
dumps, stage groups, placements, simulated makespans and the schedule
bound exact; executor outputs on CPU stage bins, a one-rank gloo
``MeshBin`` among them, at the reference's rtol 1e-5, atol 1e-5), the
executor's tree and mesh pulls, and the collectives — flash-decode and
the expert-parallel MoE — at world size 1 in process and at world size 2
over spawned gloo ranks, against the single-device paths at f32 (rtol
2e-5, atol 2e-5).  Inputs are made from seeds with numpy."""
import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_dist_ranks import (COLL_TOL, decode_inputs, decode_want,  # noqa: E402
                               moe_case, moe_want)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.core import Executor as JExecutor  # noqa: E402
from repro.core import Heteroflow as JHeteroflow  # noqa: E402
from repro.distributed import context as jctx  # noqa: E402
from repro.distributed import pipeline as jpipe  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.distributed.flash_decode import \
    flash_decode_update as jflash_decode  # noqa: E402
from repro.launch.mesh import make_smoke_mesh as jsmoke_mesh  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro import sched as jsched  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch import sched as tsched  # noqa: E402
from repro_torch.core import Executor, Heteroflow  # noqa: E402
from repro_torch.core.graph import TaskType  # noqa: E402
from repro_torch.distributed import context as tctx  # noqa: E402
from repro_torch.distributed import pipeline as tpipe  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.flash_decode import flash_decode_update  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402

CPU = torch.device("cpu")
ARCHS = tuple(list_archs())
#: the stand-in meshes: (data, model, pod)
MESHES = [(16, 16, None), (8, 8, None), (4, 2, None),
          (16, 16, 2), (8, 8, 2), (4, 2, 2)]
#: the reference's own tolerance for its pipeline outputs
#: (tests/test_pipeline.py)
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The one-rank gloo group the tests bring up (``make_smoke_mesh``)
    goes down after the module, and the module's garbage is collected,
    so a later test file in the same worker starts as it would alone."""
    yield
    import gc

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def fake_mesh(data=16, model=16, pod=None):
    """The reference's shape-only stand-in (tests/test_sharding.py)."""
    shape = (data, model) if pod is None else (pod, data, model)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {jsh._path_names(p): v for p, v in flat}


def _port_flat(tree) -> dict:
    return dict(tsh.tree_paths(tree))


def _assert_specs_equal(got, want):
    g = {k: tuple(v) for k, v in _port_flat(got).items()}
    w = {k: tuple(v) for k, v in _ref_flat(want).items()}
    assert g.keys() == w.keys()
    bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
    assert not bad, bad


def _shapes(tree, port: bool) -> dict:
    flat = _port_flat(tree) if port else _ref_flat(tree)
    return {k: (tuple(v.shape),
                str(v.dtype).removeprefix("torch.")) for k, v in flat.items()}


def _ref_skeletons(arch):
    cfg = jget_config(arch)
    return (cfg, jtr.param_specs(cfg), jtrainer.train_state_specs(cfg),
            jtr.cache_specs(cfg, batch=128, max_len=4096))


def _port_skeletons(arch):
    cfg = tconfigs.get_config(arch)
    return (cfg, ttr.param_specs(cfg), ttrainer.train_state_specs(cfg),
            ttr.cache_specs(cfg, 128, 4096))


@pytest.fixture(scope="module")
def likes():
    """``likes(arch, port)``: the package's (config, params, train state,
    caches) skeletons, built once for the module and dropped after it —
    they are large, and a later test file in the same worker should not
    pay their garbage collection (the JAX package's steal-timing test
    is sensitive to it)."""
    cache = {}

    def get(arch, port):
        if (arch, port) not in cache:
            cache[arch, port] = (_port_skeletons if port
                                 else _ref_skeletons)(arch)
        return cache[arch, port]

    yield get
    cache.clear()


def _check_divisible(spec_tree, like_tree, mesh):
    sizes = tsh.axis_sizes(mesh)
    specs, likes = _port_flat(spec_tree), _port_flat(like_tree)
    assert specs.keys() == likes.keys()
    for path, spec in specs.items():
        shape = tuple(getattr(likes[path], "shape", ()))
        for i, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            total = int(np.prod([sizes[n] for n in names]))
            assert shape[i] % total == 0, (path, spec, shape)


# ---------------------------------------------------------------------------
# meta-device skeletons
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_specs_match_reference_shapes(arch, likes):
    """param_specs, cache_specs and train_state_specs: the reference's
    leaves, shapes and dtypes, on the meta device, nothing drawn."""
    _, jp, js, jc = likes(arch, False)
    rng = torch.random.get_rng_state()
    _, tp, ts, tc = _port_skeletons(arch)
    assert torch.equal(torch.random.get_rng_state(), rng)
    for got, want in ((tp, jp), (ts, js), (tc, jc)):
        assert _shapes(got, True) == _shapes(want, False)
        assert all(t.device.type == "meta"
                   for t in _port_flat(got).values())


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data,model,pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, data, model, pod, likes):
    """Params, train state, caches and batches of every arch, leaf by
    leaf, on every stand-in mesh."""
    mesh = fake_mesh(data, model, pod)
    jcfg, jp, js, jc = likes(arch, False)
    tcfg, tp, ts, tc = likes(arch, True)
    _assert_specs_equal(tsh.param_pspecs(tcfg, tp, mesh),
                        jsh.param_pspecs(jcfg, jp, mesh))
    _assert_specs_equal(tsh.state_pspecs(tcfg, ts, mesh),
                        jsh.state_pspecs(jcfg, js, mesh))
    _assert_specs_equal(tsh.cache_pspecs(tcfg, tc, mesh),
                        jsh.cache_pspecs(jcfg, jc, mesh))
    for B in (1, 8, 256):
        jb = {"tokens": jax.ShapeDtypeStruct((B, 64), np.int32),
              "labels": jax.ShapeDtypeStruct((B, 64), np.int32),
              "extra": jax.ShapeDtypeStruct((B, 4, 16), np.float32)}
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        _assert_specs_equal(
            tsh.batch_pspecs(tcfg, tconfigs.SHAPES["long_500k"], mesh, tb),
            jsh.batch_pspecs(jcfg, JSHAPES["long_500k"], mesh, jb))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-v2-236b",
                                  "recurrentgemma-2b", "xlstm-1.3b",
                                  "minicpm-2b"])
def test_param_specs_always_divisible(arch, likes):
    cfg, like, _, _ = likes(arch, True)
    mesh = fake_mesh()
    _check_divisible(tsh.param_pspecs(cfg, like, mesh), like, mesh)


def test_kv_replication_when_few_heads(likes):
    """mistral kv=8 < model=16 → wk/wv replicate their head dim."""
    cfg, like, _, _ = likes("mistral-large-123b", True)
    specs = tsh.param_pspecs(cfg, like, fake_mesh())
    assert specs["groups"][0]["sub0"]["mixer"]["wk"][-1] is None
    assert specs["groups"][0]["sub0"]["mixer"]["wq"][-1] == "model"


def test_vocab_padding_guard(likes):
    """minicpm vocab 122753 is indivisible by 16 → the embedding's vocab
    dim is not sharded."""
    cfg, like, _, _ = likes("minicpm-2b", True)
    assert tsh.param_pspecs(cfg, like, fake_mesh())["embed"][0] is None


def test_batch_specs_replicate_batch_one():
    cfg = tconfigs.get_config("recurrentgemma-2b")
    like = {"token": torch.empty((1,), dtype=torch.int32, device="meta")}
    specs = tsh.batch_pspecs(cfg, tconfigs.SHAPES["long_500k"],
                             fake_mesh(pod=2), like)
    assert specs["token"] == tsh.P(None)


def test_state_specs_mirror_params(likes):
    cfg, _, like, _ = likes("phi3-mini-3.8b", True)
    specs = tsh.state_pspecs(cfg, like, fake_mesh())
    assert specs["opt"]["step"] == tsh.P()
    assert list(_port_flat(specs["params"]).values()) == \
        list(_port_flat(specs["opt"]["m"]).values())


@settings(max_examples=25, deadline=None)
@given(st.sampled_from(["mistral-large-123b", "deepseek-v2-236b",
                        "xlstm-1.3b", "qwen2-vl-7b"]),
       st.sampled_from([(8, 8), (16, 16), (4, 2)]),
       st.booleans())
def test_cache_specs_divisible_fuzz(arch, mesh_shape, multi_pod):
    mesh = fake_mesh(*mesh_shape, pod=2 if multi_pod else None)
    tcfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    like = ttr.cache_specs(tcfg, batch=128, max_len=4096)
    specs = tsh.cache_pspecs(tcfg, like, mesh)
    _check_divisible(specs, like, mesh)
    _assert_specs_equal(specs, jsh.cache_pspecs(
        jcfg, jtr.cache_specs(jcfg, batch=128, max_len=4096), mesh))


def test_named_maps_specs_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_smoke_mesh("cpu")
    tree = {"w": tsh.P("model", "data"), "b": [tsh.P(("data", "model")),
                                              tsh.P()]}
    got = tsh.named(mesh, tree)
    assert got["w"] == (Shard(1), Shard(0))
    assert got["b"][0] == (Shard(0), Shard(0))
    assert got["b"][1] == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="twice"):
        tsh.placements(mesh, tsh.P("data", "data"))
    with pytest.raises(ValueError, match="pod"):
        tsh.placements(mesh, tsh.P("pod"))


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------
CONTEXT_MESHES = [(1, 1, None), (2, 1, None), (1, 2, None), (4, 2, None),
                  (16, 16, None), (2, 8, 2), (16, 16, 2), (1, 1, 2)]


def _info(info, mesh):
    if info is None:
        return None
    got_mesh, baxes, maxis = info
    assert got_mesh is mesh
    return baxes, maxis


@pytest.mark.parametrize("data,model,pod", CONTEXT_MESHES)
def test_dispatch_conditions_match_reference(data, model, pod, monkeypatch):
    """moe_shard_info, decode_shard_info, dispatch_groups and
    decode_tp_active over a grid of token, batch and cache counts, with
    and without a mesh, in and out of manual mode."""
    mesh = fake_mesh(data, model, pod)
    for kw in ({"mesh": mesh}, {"mesh": mesh, "decode_tp": True},
               {"mesh": mesh, "batch_axes": ("data",)}, {}):
        with jctx.use_sharding_rules(**kw), tctx.use_sharding_rules(**kw):
            for n in (1, 2, 3, 8, 12, 64, 256, 4096):
                assert _info(tctx.moe_shard_info(n), mesh) == \
                    _info(jctx.moe_shard_info(n), mesh)
                assert tctx.dispatch_groups(n) == jctx.dispatch_groups(n)
            for B in (1, 2, 3, 8, 16):
                for S in (1, 2, 64, 1000, 4096):
                    assert _info(tctx.decode_shard_info(B, S), mesh) == \
                        _info(jctx.decode_shard_info(B, S), mesh)
            assert tctx.decode_tp_active() == jctx.decode_tp_active()
            with jctx.manual_mode(), tctx.manual_mode():
                assert tctx.decode_shard_info(8, 4096) is None \
                    and jctx.decode_shard_info(8, 4096) is None
                assert tctx.decode_tp_active() == jctx.decode_tp_active()
    with jctx.use_sharding_rules(mesh=mesh), \
            tctx.use_sharding_rules(mesh=mesh):
        monkeypatch.setenv("REPRO_NO_FLASH_DECODE", "1")
        assert tctx.decode_shard_info(16, 4096) is None
        assert jctx.decode_shard_info(16, 4096) is None
    for fn, args in ((tctx.moe_shard_info, (8,)),
                     (tctx.decode_shard_info, (8, 64))):
        assert fn(*args) is None                    # outside rules
    assert tctx.dispatch_groups(8) == 1 and not tctx.decode_tp_active()


KINDS = ("residual", "heads", "ffn_hidden", "moe_buffers", "moe_groups",
         "group_tokens", "logits", "dtp_features", "dtp_hidden",
         "batch_only", "replicated", "scan_xs_batch", "flash_blocks",
         "unknown")
SHAPES = [(1, 1, 48), (8, 16, 64), (32, 32, 96), (3, 5, 7), (16, 1, 2048),
          (8, 16, 32, 96), (1, 512, 8, 128), (160, 64, 16, 5120),
          (16, 4, 128, 8, 4, 96), (2, 2, 64, 1, 8, 128)]


@pytest.mark.parametrize("data,model,pod", CONTEXT_MESHES)
def test_constraint_specs_match_reference(data, model, pod, monkeypatch):
    """The spec each constraint kind gives each shape under each rule
    set: the reference's ``with_sharding_constraint`` argument (None
    where it constrains nothing)."""
    mesh = fake_mesh(data, model, pod)
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    for kw in ({"mesh": mesh}, {"mesh": mesh, "seq_shard": False},
               {"mesh": mesh, "batch_axes": ("data",)}, {}):
        with jctx.use_sharding_rules(**kw), tctx.use_sharding_rules(**kw):
            for kind in KINDS:
                for shape in SHAPES:
                    seen.clear()
                    jctx.constrain(jax.ShapeDtypeStruct(shape, np.float32),
                                   kind)
                    want = tuple(seen[0]) if seen else None
                    got = tctx.constraint_spec(shape, kind)
                    assert (None if got is None else tuple(got)) == want, \
                        (kw, kind, shape)


def test_constrain_is_the_identity_outside_rules_and_on_plain_tensors():
    x = torch.zeros(4, 8, 16)
    assert tctx.constraint_spec((4, 8, 16), "residual") is None
    assert tctx.constrain(x, "residual") is x
    with tctx.use_sharding_rules(mesh=fake_mesh(2, 2)):
        assert tctx.constraint_spec((4, 8, 16), "residual") == \
            tsh.P("data", "model", None)
        assert tctx.constrain(x, "residual") is x
        with tctx.manual_mode():
            assert tctx.constraint_spec((4, 8, 16), "residual") is None


def test_constrain_redistributes_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_smoke_mesh("cpu")
    x = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(4, 8, 16)
    dx = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                            run_check=False)
    with tctx.use_sharding_rules(mesh=mesh):
        y = tctx.constrain(dx, "residual")
    assert y.placements == (Shard(0), Shard(1))
    assert torch.equal(y.full_tensor(), x)
    assert tctx.constrain(dx, "residual") is dx     # outside rules


# ---------------------------------------------------------------------------
# meshes and mesh bins
# ---------------------------------------------------------------------------
def test_smoke_mesh_is_one_by_one_and_reuses_the_group():
    a, b = make_smoke_mesh("cpu"), make_smoke_mesh("cpu")
    assert tsh.axis_sizes(a) == tsh.axis_sizes(b) == {"data": 1, "model": 1}
    assert a.device_type == "cpu"
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_mesh_bins_from_a_live_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_smoke_mesh("cpu")
    (mb,) = tsched.MeshBin.from_mesh(mesh)
    (jmb,) = jsched.MeshBin.from_mesh(jsmoke_mesh())
    assert mb.label == jmb.label == "mesh:1x1[0]"
    assert mb.axis_shape == jmb.axis_shape
    assert mb.capabilities == {"mesh", "cpu"}
    assert mb.put_target() == (mesh, (Replicate(), Replicate()))
    (sharded,) = tsched.MeshBin.from_mesh(mesh, {"model": 1},
                                          spec=tsh.P(None, "model"))
    assert sharded.put_target()[1] == (Replicate(), Shard(1))
    for tile, msg in (({"pod": 1}, "no axis 'pod'"),
                      ({"data": 2}, "does not divide")):
        with pytest.raises(ValueError, match=msg):
            tsched.MeshBin.from_mesh(mesh, tile)
        with pytest.raises(ValueError, match=msg):
            jsched.MeshBin.from_mesh(jsmoke_mesh(), tile)
    with pytest.raises(RuntimeError, match="synthetic"):
        tsched.MeshBin("m", {"data": 2}).put_target()


def test_tree_pull_carries_every_leaf_to_its_bin():
    """A pull of a dict (a stage's weights): every leaf — numpy and bf16
    CPU tensors, lists nested — lands on the bin; on a mesh bin each as
    a replicated DTensor, and a kernel there reads them as one."""
    from torch.distributed.tensor import DTensor
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "groups": [{"b": torch.randn(5, generator=torch.Generator()
                                         .manual_seed(0)).bfloat16()}]}
    (mb,) = tsched.MeshBin.from_mesh(make_smoke_mesh("cpu"))
    for bin_ in (tsched.DeviceBin(CPU), mb):
        G = Heteroflow()
        p = G.pull(tree, name="weights")
        seen = {}

        def read(t, seen=seen):
            seen.update(w=t["w"], b=t["groups"][0]["b"])
            return t["w"].sum()

        k = G.kernel(read, p, name="read")
        k.succeed(p)
        with Executor(num_workers=1, devices=[bin_]) as ex:
            ex.run(G).result(timeout=60)
        on_mesh = bin_ is mb
        assert isinstance(seen["w"], DTensor) == on_mesh
        w = seen["w"].full_tensor() if on_mesh else seen["w"]
        b = seen["b"].full_tensor() if on_mesh else seen["b"]
        assert torch.equal(w, torch.from_numpy(tree["w"]))
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, tree["groups"][0]["b"])
        np.testing.assert_array_equal(k.host_result(), w.sum().numpy())
    with pytest.raises(ValueError, match="no size"):
        from repro_torch.core.graph import _span_view
        _span_view(tree, 3)


def test_kernels_unwrap_a_whole_dtensor():
    """On a one-rank mesh a DTensor holds the whole value: the wrappers
    read its local tensor and give the plain result."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_smoke_mesh("cpu")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 4, 16, generator=g) for _ in range(3))
    want = flash_attention(q, k, v)
    dq, dk = (DTensor.from_local(t, mesh, [Replicate(), Shard(2)],
                                 run_check=False) for t in (q, k))
    got = flash_attention(dq, dk, v)
    assert not isinstance(got, DTensor)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# pipeline: graphs, groups, placements, makespans (exact)
# ---------------------------------------------------------------------------
def _weights(n, d=8):
    return [(np.random.default_rng(100 + i).normal(size=(d, d)) * 0.3)
            .astype(np.float32) for i in range(n)]


def _torch_stage_fn(w, x):
    return torch.tanh(torch.as_tensor(x) @ torch.as_tensor(w))


_jax_stage_fn = jax.jit(lambda w, x: jnp.tanh(x @ w))


def _pair_stages(n, costs=None):
    ws = _weights(n)
    cost = [(costs[i] if costs else 1.0) for i in range(n)]
    return ([tpipe.Stage(_torch_stage_fn, w, c) for w, c in zip(ws, cost)],
            [jpipe.Stage(_jax_stage_fn, w, c) for w, c in zip(ws, cost)])


def _expected(ws, mbs):
    outs = []
    for mb in mbs:
        want = mb
        for w in ws:
            want = np.tanh(want @ w)
        outs.append(want)
    return outs


def _mbs(n):
    return [np.random.default_rng(i).normal(size=(4, 8)).astype(np.float32)
            for i in range(n)]


def _sim_pipelines(n_stages=4, n_mb=6, costs=None):
    """The same simulator-only pipeline from each package."""
    out = []
    for pipe in (tpipe, jpipe):
        sts = [pipe.Stage(fn=lambda w, x: x,
                          params=np.zeros((4, 4), np.float32),
                          cost=(costs[s] if costs else 100.0))
               for s in range(n_stages)]
        mbs = [np.zeros((2, 4), np.float32) for _ in range(n_mb)]
        out.append(pipe.build_pipeline_graph(sts, mbs))
    return out


def _dump(G) -> str:
    """The DOT dump with node ids renumbered in creation order."""
    index = {n.id: i for i, n in enumerate(G.nodes)}
    return re.sub(r"\bn(\d+)\b", lambda m: f"n{index[int(m.group(1))]}",
                  G.dump())


def _by_name(G, placement) -> dict:
    names = {n.id: n.name for n in G.nodes}
    return {names[i]: getattr(b, "label", b) for i, b in placement.items()}


@pytest.mark.parametrize("n_stages,n_mb,costs", [
    (3, 4, None), (4, 8, None), (4, 6, [100.0, 300.0, 200.0, 100.0]),
    (2, 1, [5.0, 1.0])])
def test_pipeline_graphs_match_reference(n_stages, n_mb, costs):
    tg, jg = _sim_pipelines(n_stages, n_mb, costs)
    assert _dump(tg) == _dump(jg)
    for G, pkg in ((tg, tsched), (jg, jsched)):
        groups = pkg.build_groups(G)
        assert {g.stage_id for g in groups if g.stage_id is not None} == \
            set(range(n_stages))
    tgroups = sorted(sorted(n.name for n in g.nodes)
                     for g in tsched.build_groups(tg))
    jgroups = sorted(sorted(n.name for n in g.nodes)
                     for g in jsched.build_groups(jg))
    assert tgroups == jgroups
    assert [n.state.get("stage") for n in tg.nodes] == \
        [n.state.get("stage") for n in jg.nodes]
    assert [n.state.get("requires") for n in tg.nodes] == \
        [n.state.get("requires") for n in jg.nodes]


@pytest.mark.parametrize("n_bins", [1, 2, 4])
@pytest.mark.parametrize("policy", ["balanced", "heft", "round_robin"])
def test_pipeline_placements_and_makespans_match_reference(policy, n_bins):
    """Each policy places each stage group on the same stage bin in both
    packages, and the simulator gives the same makespan, which never
    beats the schedule-length bound; the hand-pinned baseline too."""
    costs = [100.0, 300.0, 200.0, 100.0]
    res = []
    for pkg, G in zip((tsched, jsched), _sim_pipelines(4, 6, costs)):
        model = pkg.CostModel()
        pool = pkg.stage_bins([f"d{i}" for i in range(n_bins)])
        kw = {"cost_model": model} if policy == "heft" else {}
        pl = pkg.get_scheduler(policy, **kw).schedule(G, pool)
        ms = pkg.simulate(G, pl, pool, cost_model=model,
                          host_workers=8).makespan
        pipe = tpipe if pkg is tsched else jpipe
        pinned = pipe.pinned_placement(G, pool)
        pin_ms = pkg.simulate(G, pinned, pool, cost_model=model,
                              host_workers=8).makespan
        res.append((_by_name(G, pl), ms, _by_name(G, pinned), pin_ms))
    assert res[0] == res[1]
    bound = tpipe.pipeline_schedule_length(4, 6, costs) / \
        tsched.CostModel().compute_rate
    assert res[0][1] >= bound * (1 - 1e-9)


@pytest.mark.parametrize("policy", ["balanced", "heft"])
def test_scheduled_placement_not_worse_than_hand_pinned(policy):
    """The reference's acceptance case: free stage groups on 4 stage bins
    never lose to the stage-s-to-bin-s pinning, with the same makespans
    as the reference's."""
    res = []
    for pkg, G in zip((tsched, jsched), _sim_pipelines(4, 8)):
        model = pkg.CostModel()
        pool = pkg.stage_bins([f"d{i}" for i in range(4)])
        kw = {"cost_model": model} if policy == "heft" else {}
        pl = pkg.get_scheduler(policy, **kw).schedule(G, pool)
        pipe = tpipe if pkg is tsched else jpipe
        res.append((pkg.simulate(G, pl, pool, cost_model=model).makespan,
                    pkg.simulate(G, pipe.pinned_placement(G, pool), pool,
                                 cost_model=model).makespan))
    assert res[0] == res[1]
    assert res[0][0] <= res[0][1] * (1 + 1e-9)


def test_stage_groups_are_atomic_and_tagged():
    G, _ = _sim_pipelines(n_stages=3, n_mb=4)
    groups = tsched.build_groups(G)
    staged = {g.stage_id: g for g in groups if g.stage_id is not None}
    assert set(staged) == {0, 1, 2} and len(groups) == 3
    for s, g in staged.items():
        assert "stage" in g.requires
        names = {n.name for n in g.nodes}
        assert f"weights[{s}]" in names
        assert all(f"f[{s},{m}]" in names for m in range(4))
    assert {"mb[0]", "mb[3]"} <= {n.name for n in staged[0].nodes}


def test_conflicting_stage_tags_in_one_group_raise():
    G = Heteroflow()
    p = G.pull(np.zeros(8), name="shared")
    G.kernel(lambda a: a, p, stage=0, name="k0")
    G.kernel(lambda a: a, p, stage=1, name="k1")
    with pytest.raises(ValueError, match="stage atomicity"):
        tsched.build_groups(G)


def test_stage_tagged_graph_requires_stage_bins():
    G, _ = _sim_pipelines(n_stages=2, n_mb=2)
    with pytest.raises(ValueError, match="requires capabilities"):
        tsched.get_scheduler("balanced").schedule(G, ["d0", "d1"])


def test_pinned_placement_covers_all_device_tasks():
    G, J = _sim_pipelines(n_stages=3, n_mb=2)
    pool, jpool = (pkg.stage_bins(["a", "b"]) for pkg in (tsched, jsched))
    pl = tpipe.pinned_placement(G, pool)
    device_tasks = [n for n in G.nodes
                    if n.type in (TaskType.KERNEL, TaskType.PULL)]
    assert set(pl) == {n.id for n in device_tasks}
    names = {n.id: n.name for n in G.nodes}
    assert {pl[i].stage_id for i in pl if names[i] == "weights[2]"} == {0}
    assert _by_name(G, pl) == _by_name(J, jpipe.pinned_placement(J, jpool))
    with pytest.raises(ValueError, match="no bins"):
        tpipe.pinned_placement(G, [])


@pytest.mark.parametrize("bw", [1e4, 1e12])
def test_simulator_charges_stage_links_as_the_reference(bw):
    res = []
    for pkg, G in zip((tsched, jsched), _sim_pipelines(2, 4)):
        pool = pkg.stage_bins(["a", "b"], link_bandwidth=bw)
        pipe = tpipe if pkg is tsched else jpipe
        res.append(pkg.simulate(G, pipe.pinned_placement(G, pool), pool,
                                cost_model=pkg.CostModel()).makespan)
    assert res[0] == res[1]


def test_schedule_length_formula():
    for args in ((4, 8), (3, 4, [1.0, 5.0, 2.0]), (2, 3, {1: 4.0}),
                 (0, 5), (1, 1, [7.5])):
        assert tpipe.pipeline_schedule_length(*args) == \
            jpipe.pipeline_schedule_length(*args)
    assert tpipe.pipeline_schedule_length(4, 8) == 11
    with pytest.raises(ValueError, match="stage costs"):
        tpipe.pipeline_schedule_length(3, 2, [1.0])


def test_transfer_time_uses_destination_stage_link():
    for pkg in (tsched, jsched):
        m = pkg.CostModel(d2d_bandwidth=1e9, latency_s=1e-6,
                          stage_link_bandwidth=2e9)
        fat = pkg.StageBin(1, "d1", link_bandwidth=1e10,
                           link_latency_s=1e-7)
        bare = pkg.StageBin(2, "d2")
        assert m.transfer_time(1000, "d0", fat) == pytest.approx(
            1e-7 + 1000 / 1e10)
        assert m.transfer_time(1000, fat, bare) == pytest.approx(
            1e-6 + 1000 / 2e9)
        assert m.transfer_time(1000, "d0", "d1") == m.transfer_time(1000)
        with pytest.raises(ValueError, match="link_bandwidth"):
            pkg.StageBin(0, "d0", link_bandwidth=0.0)
        with pytest.raises(ValueError, match="link_latency_s"):
            pkg.StageBin(0, "d0", link_latency_s=-1e-6)


def _eft_graph(pkg, fanout: bool):
    """The reference's HEFT pipelined-EFT cases: four chained stage-0
    cells, then one reduction (``fanout=False``) or four stage-1 cells
    all fed by the last stage-0 cell."""
    G = (Heteroflow if pkg is tsched else JHeteroflow)()
    prev = None
    for m in range(4):
        p = G.pull(np.zeros(4000), name=f"p0_{m}", stage=0)
        k = G.kernel(lambda a: a, p, cost=100.0, stage=0,
                     requires=("stage",), name=f"s0_{m}")
        k.succeed(p)
        if prev is not None:
            prev.precede(k)
        prev = k
    heads = []
    for m in range(4 if fanout else 1):
        p = G.pull(np.zeros(4000), name=f"p1_{m}", stage=1)
        k = G.kernel(lambda a, b: a, p, prev, cost=100.0, stage=1,
                     requires=("stage",), name=f"s1_{m}")
        k.succeed(p, prev)
        heads.append(k)
    return G, prev, heads


@pytest.mark.parametrize("fanout", [False, True])
def test_heft_pipelined_eft_needs_cellwise_coupling(fanout):
    """One edge, or a fan-out from the upstream LAST cell, is no cell-wise
    coupling: HEFT co-locates the consumer with the upstream stage, as
    the reference's."""
    res = []
    for pkg in (tsched, jsched):
        G, prev, heads = _eft_graph(pkg, fanout)
        pool = pkg.stage_bins(["a", "b"])
        pl = pkg.get_scheduler("heft", cost_model=pkg.CostModel()).schedule(
            G, pool)
        assert pl[heads[0]._node.id] is pl[prev._node.id]
        res.append(_by_name(G, pl))
    assert res[0] == res[1]


def test_collective_overhead_formula_matches_reference():
    for kw in ({}, {"collective_alpha": 1e-5, "collective_beta": 1e9},
               {"collective_alpha": 2e-5}):
        t, j = tsched.CostModel(**kw), jsched.CostModel(**kw)
        for n, b in ((1, 1 << 20), (4, 1 << 20), (8, 0), (16, 12345)):
            assert t.collective_overhead(n, b) == j.collective_overhead(n, b)
    with pytest.raises(ValueError, match="collective_alpha"):
        tsched.CostModel(collective_alpha=-1e-5)


def test_trace_records_stages_and_link_descriptors(tmp_path):
    """A pipeline run on two CPU stage bins under the profiler: stage ids
    on the cells, stage descriptors with their links, and a pool rebuilt
    from the saved trace."""
    pool = tsched.stage_bins([CPU, CPU], link_bandwidth=4e9)
    tst, _ = _pair_stages(2)
    G = tpipe.build_pipeline_graph(tst, _mbs(3))
    prof = tsched.TaskProfiler()
    with Executor(num_workers=1, devices=pool, profiler=prof) as ex:
        ex.run(G).result(timeout=120)
    trace = prof.trace()
    descs = trace["meta"]["bin_descriptors"]
    assert [d["kind"] for d in descs] == ["stage", "stage"]
    for s, d in enumerate(descs):
        assert d["stage_id"] == s and d["link_bandwidth"] == 4e9
        assert d["member"]["kind"] == "device"
    cells = [r for r in trace["records"] if r["name"].startswith("f[")]
    assert cells and {r["stage"] for r in cells} == {0, 1}
    assert all("stage" not in r for r in trace["records"]
               if r["name"].startswith("mb["))
    path = tmp_path / "pipe.json"
    prof.save(str(path))
    rebuilt = tsched.bins_from_trace(tsched.load_trace(str(path)))
    assert [b.stage_id for b in rebuilt] == [0, 1]
    assert [b.label for b in rebuilt] == ex.device_labels
    tsched.CostModel.fit(prof)


def test_fit_calibrates_stage_link_bandwidth_as_the_reference():
    recs = [
        {"node": 0, "name": "p0", "type": "pull", "bin": "s0", "worker": 0,
         "iteration": 0, "start": 0.0, "end": 0.001, "cost": 8000.0,
         "bytes": 8000},
        {"node": 1, "name": "k0", "type": "kernel", "bin": "s0",
         "worker": 0, "iteration": 0, "start": 0.001, "end": 0.002,
         "cost": 1000.0, "bytes": 0, "stage": 0},
        {"node": 2, "name": "k1", "type": "kernel", "bin": "s1",
         "worker": 0, "iteration": 0, "start": 0.002, "end": 0.007,
         "cost": 1000.0, "bytes": 0, "xfer_bytes": 4000, "stage": 1}]
    meta = {"bins": ["s0", "s1"], "workers": 1, "bin_descriptors": [
        {"kind": "stage", "label": f"s{i}", "stage_id": i,
         "device_count": 1, "capabilities": ["device", "stage"],
         "member": {"kind": "device", "label": f"d{i}", "device_count": 1}}
        for i in range(2)]}
    trace = {"version": 4, "meta": meta, "records": recs, "lanes": {}}
    t, j = tsched.CostModel.fit(trace), jsched.CostModel.fit(trace)
    assert t.compute_rate == j.compute_rate == pytest.approx(1e6)
    assert t.stage_link_bandwidth == j.stage_link_bandwidth
    assert t.d2d_bandwidth == j.d2d_bandwidth


@pytest.mark.parametrize("top_k", [1, 2])
def test_reschedule_migration_is_stage_atomic(top_k):
    """A measured-load rebalance through the event loop (the migration
    recipe that replaced ``reschedule()``) moves whole stages, onto stage
    bins only, and the same ones as the reference's."""
    res = []
    for pkg, G in zip((tsched, jsched), _sim_pipelines(3, 4)):
        pool = pkg.stage_bins([f"d{i}" for i in range(3)])
        sched = pkg.get_scheduler("balanced")
        sched.schedule(G, pool)
        groups = pkg.build_groups(G)
        state = pkg.SchedulerState(pool, migrate_top_k=top_k)
        for g in groups:
            state.add_group(g)
        state.measured_load = {0: 100.0, 1: 1.0, 2: 1.0}
        sched.update(state, pkg.SchedulerUpdate(), graph=G)
        pl = pkg.apply_assignment(G, groups, pool, state.assignment)
        by_stage = {}
        for n in G.nodes:
            if n.state.get("stage") is not None:
                by_stage.setdefault(n.state["stage"], set()).add(
                    id(pl[n.id]))
        assert len(by_stage) == 3
        assert all(len(v) == 1 for v in by_stage.values())
        assert all(getattr(b, "kind", None) == "stage" for b in pl.values())
        res.append(_by_name(G, pl))
    assert res[0] == res[1]


# ---------------------------------------------------------------------------
# pipeline: executor outputs on CPU stage bins
# ---------------------------------------------------------------------------
def _run_both(n, n_mb, tpool, jpool, **kw):
    tst, jst = _pair_stages(n)
    mbs = _mbs(n_mb)
    tout, jout = [], []
    tG = tpipe.build_pipeline_graph(tst, mbs, collect=tout, **kw)
    jG = jpipe.build_pipeline_graph(jst, mbs, collect=jout, **kw)
    with Executor(num_workers=3, devices=tpool) as ex:
        ex.run(tG).result(timeout=120)
    with JExecutor(num_workers=3, devices=jpool) as ex:
        ex.run(jG).result(timeout=120)
    assert len(tout) == len(jout) == n_mb
    for got, ref, want in zip(tout, jout, _expected(
            [s.params for s in tst], mbs)):
        np.testing.assert_allclose(got, np.asarray(ref), **PIPE_TOL)
        np.testing.assert_allclose(got, want, **PIPE_TOL)
    return tG


def test_pipeline_output_matches_sequential_on_stage_bins():
    G = _run_both(3, 5, tsched.stage_bins([CPU] * 3),
                  jsched.stage_bins([jax.devices()[0]] * 3))
    by_stage = {}
    for n in G.nodes:
        if n.state.get("stage") is not None:
            by_stage.setdefault(n.state["stage"], set()).add(id(n.device))
    assert len(by_stage) == 3
    assert all(len(v) == 1 for v in by_stage.values())


def test_pipeline_untagged_runs_on_plain_device_bins():
    _run_both(2, 1, [CPU], jax.devices(), require_stage_bins=False)


def test_pipeline_over_mixed_member_stage_pool():
    """Stage slots backed by a HostBin, a DeviceBin and a live one-rank
    gloo MeshBin; activations cross between the mesh slice (DTensors)
    and the other bins (plain tensors)."""
    (mesh_bin,) = tsched.MeshBin.from_mesh(make_smoke_mesh("cpu"))
    (jmesh_bin,) = jsched.MeshBin.from_mesh(jsmoke_mesh())
    _run_both(3, 4, tsched.stage_bins([tsched.HostBin(),
                                       tsched.DeviceBin(CPU), mesh_bin]),
              jsched.stage_bins([jsched.HostBin(),
                                 jsched.DeviceBin(jax.devices()[0]),
                                 jmesh_bin]))


def test_model_stages_give_the_forward_logits():
    """A reduced phi3 (4 layers, f32) cut into 3 stages on a mixed pool
    with a mesh slice gives ``forward``'s logits per microbatch; each
    stage's cost is its layers (plus embedding and head)."""
    cfg = tconfigs.reduced(tconfigs.get_config("phi3-mini-3.8b"))
    cfg = dataclasses.replace(cfg, compute_dtype="float32", groups=(
        dataclasses.replace(cfg.groups[0], count=4),))
    params = ttr.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    stages = ttr.pipeline_stages(cfg, params, 3)
    assert [s.cost for s in stages] == [2.0, 1.0, 3.0]
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, cfg.vocab_size, size=(1, 16)) for _ in range(4)]
    (mesh_bin,) = tsched.MeshBin.from_mesh(make_smoke_mesh("cpu"))
    pool = tsched.stage_bins([tsched.HostBin(), tsched.DeviceBin(CPU),
                              mesh_bin])
    out = []
    G = tpipe.build_pipeline_graph(stages, mbs, collect=out)
    with Executor(num_workers=3, devices=pool) as ex:
        ex.run(G).result(timeout=120)
    for got, tokens in zip(out, mbs):
        want, _ = ttr.forward(cfg, params, torch.from_numpy(tokens))
        np.testing.assert_allclose(got, want.numpy(), **PIPE_TOL)
    with pytest.raises(ValueError, match="stages for 4 layers"):
        ttr.pipeline_stages(cfg, params, 5)


# ---------------------------------------------------------------------------
# collectives at world size 1 (in process) and 2 (spawned gloo ranks)
# ---------------------------------------------------------------------------
def test_flash_decode_at_world_size_one():
    """One rank holds the whole cache: flash_decode_update equals decode
    attention over it with the new row written, and the reference's
    flash_decode_update on its 1x1 mesh; the cache is updated in place;
    a global DTensor in gives a DTensor out."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = make_smoke_mesh("cpu")
    for length in (37, 0, 63):
        ins = decode_inputs(length=length)
        want, kc_want, vc_want = decode_want(*ins)
        q, kn, vn, kc, vc = (torch.from_numpy(a.copy()) for a in ins[:5])
        out, kc2, vc2 = flash_decode_update(q, kn, vn, kc, vc, length,
                                            mesh=mesh, baxes=("data",),
                                            maxis="model")
        assert kc2 is kc and vc2 is vc
        np.testing.assert_allclose(out.numpy(), want, **COLL_TOL)
        np.testing.assert_array_equal(kc.numpy(), kc_want)
        np.testing.assert_array_equal(vc.numpy(), vc_want)
        if length == 37:
            jout, jkc, _ = jflash_decode(*(jnp.asarray(a) for a in ins[:5]),
                                         length, mesh=jsmoke_mesh(),
                                         baxes=("data",), maxis="model")
            np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                       **COLL_TOL)
            np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    ins = decode_inputs(length=5)
    want, _, _ = decode_want(*ins)
    dts = [DTensor.from_local(torch.from_numpy(a.copy()), mesh,
                              [Replicate(), Replicate()], run_check=False)
           for a in ins[:5]]
    out, _, _ = flash_decode_update(*dts, torch.tensor([5]), mesh=mesh,
                                    baxes=(), maxis="model")
    assert isinstance(out, DTensor)
    np.testing.assert_allclose(out.full_tensor().numpy(), want, **COLL_TOL)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_shard_map_at_world_size_one(capacity_factor):
    """One rank routes all tokens as one group: _moe_shard_map equals
    _moe_local plus the shared experts (drops too, at capacity factor
    0.5), aux included."""
    mesh = make_smoke_mesh("cpu")
    cfg, p, x = moe_case(capacity_factor)
    want, want_aux = moe_want(cfg, p, x)
    got, aux = tmoe._moe_shard_map(cfg, p, x, torch.float32, mesh,
                                   ("data",), "model", aux=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **COLL_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **COLL_TOL)
    # on one rank the rules never take it: moe_forward is _moe_local's
    with tctx.use_sharding_rules(mesh=mesh):
        assert tctx.moe_shard_info(16) is None
        out, _ = tmoe.moe_forward(cfg, p, x)
    np.testing.assert_array_equal(out.numpy(), want.numpy())


def test_collectives_at_world_size_two(tmp_path):
    """Two spawned gloo ranks (a file store under tmp_path), each running
    ``_torch_dist_ranks.rank_main``: flash-decode, its hook in
    ``attn_forward`` and the expert-parallel MoE against their
    single-device paths, a sharded DTensor refused by a kernel, mesh
    bins of a tiled mesh.  The ranks run at a lower priority than the
    suite's workers (``nice``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).parent), str(Path(__file__).parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    code = ("import sys, _torch_dist_ranks as r; "
            "r.rank_main(int(sys.argv[1]), 2, sys.argv[2])")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(["nice", "-n", "10", sys.executable, "-c", code,
                               str(r), store],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
