"""The port's dry-run family (``repro_torch.launch.{dryrun, op_cost,
roofline, summarize}``) and the kernels' custom ops against the JAX
package's ``repro.launch.{dryrun, hlo_cost, roofline, summarize}``.

Exact: MODEL_FLOPS for every arch × shape, the ring model's bytes for
every collective kind, the roofline terms against their peaks (to the
last bit of a division), the summary tables' text, and each leaf's bytes
per device (params, train state, caches, batch) on the reference's
16×16 and 2×16×16 stand-in meshes.  Within 1%: the per-device FLOPs of a
reduced phi3-mini and minicpm train step, prefill and decode step traced
on a 1×1 fake mesh against ``hlo_cost.analyze`` of the reference's
jitted step, once the one named difference is taken out: the reference's
blockwise attention computes every (query, key) block (a dense product),
the port's kernels count the pairs they compute (the causal half), so
the attention FLOPs of both are computed apart and the rest compared.
The kernels' fake implementations give the plain versions' shapes and
dtypes; a head-sharded call (GQA with kv heads replicated) gives the
unsharded plain result over two spawned gloo ranks (rtol 2e-5, atol
2e-5: the same products, summed in another order).  Inputs are made from
seeds with numpy or are shape-only."""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

jax.devices()      # the backend is up before the reference's dryrun module
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import summarize as jsum  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.training import AdamWConfig as JAdamW  # noqa: E402
from repro.training import cosine_schedule as jcosine  # noqa: E402
from repro.training import trainer as jtrainer  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.launch import dryrun, op_cost, roofline, summarize  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.training import trainer as ttrainer  # noqa: E402

ARCHS = tuple(list_archs())
COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")
#: op_cost's FLOPs against the reference's HLO count, attention aside
FLOP_RTOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    """A dry-run takes down a process group it finds and its own fake one
    on exit; the module leaves none up and its garbage collected."""
    yield
    import gc

    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


# ---------------------------------------------------------------------------
# roofline and summaries (framework-free: exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops(tconfigs.get_config(arch),
                                tconfigs.SHAPES[shape]) == \
        jroof.model_flops(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("n", [1, 2, 16])
@pytest.mark.parametrize("op", COLL_KINDS)
def test_collective_ring_bytes_match_reference(op, n):
    got, want = roofline.CollectiveStats(), jroof.CollectiveStats()
    for nbytes in (1 << 20, 3 * 4096, 7):
        got.add(op, nbytes, n)
        want.add(op, nbytes, n)
    assert (got.counts, got.raw_bytes, got.ring_bytes) == \
        (want.counts, want.raw_bytes, want.ring_bytes)
    # on NVLink (one node) the collective time is the ring bytes over it
    assert got.ring_s == pytest.approx(got.ring_bytes / roofline.NVLINK_BW,
                                       rel=1e-12)


def test_roofline_terms_give_back_their_inputs():
    """Each term times its peak is its count; the H100's data-sheet peaks
    and the link of a group by the nodes it spans."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert (roofline.NVLINK_BW, roofline.IB_BW) == (450e9, 50e9)
    r = roofline.Roofline(flops=3.1e15, hbm_bytes=7.7e11, coll_bytes=2.5e9,
                          chips=256, model_flops_per_chip=2.2e15)
    assert r.t_compute * roofline.PEAK_FLOPS == pytest.approx(3.1e15,
                                                              rel=1e-15)
    assert r.t_memory * roofline.HBM_BW == pytest.approx(7.7e11, rel=1e-15)
    assert r.t_collective * roofline.NVLINK_BW == pytest.approx(2.5e9,
                                                                rel=1e-15)
    assert r.bottleneck == "compute" and r.t_bound == r.t_compute
    assert r.mfu_bound == pytest.approx(2.2e15 / 3.1e15, rel=1e-12)
    slow = roofline.Roofline(1.0, 1.0, 2.5e9, 256, coll_s=2.5e9 / 50e9)
    assert slow.bottleneck == "collective" and slow.t_collective == 0.05
    assert roofline.link_bw(range(8)) == roofline.NVLINK_BW
    assert roofline.link_bw(range(0, 256, 16)) == roofline.IB_BW
    assert roofline.link_bw(range(16)) == roofline.IB_BW   # two nodes


def _records():
    rng = np.random.default_rng(0)
    recs = []
    for arch in ARCHS[:4]:
        for shape in ("train_4k", "decode_32k"):
            t = rng.uniform(1e-6, 3.0, size=3)
            recs.append({
                "arch": arch, "shape": shape,
                "roofline": {"t_compute_s": float(t[0]),
                             "t_memory_s": float(t[1]),
                             "t_collective_s": float(t[2]),
                             "bottleneck": "memory",
                             "useful_flop_fraction": float(rng.uniform()),
                             "mfu_bound": float(rng.uniform())},
                "memory": {"per_device_total": int(rng.integers(1 << 34))},
                "collectives": {"counts": {"all-gather": 3,
                                           "all-reduce": 5}},
                "trace_s": round(float(rng.uniform(0, 40)), 2)})
    return recs


def test_summaries_match_reference_text():
    recs = _records()
    ref = [dict(r, compile_s=r["trace_s"]) for r in recs]
    assert summarize.table(recs) == jsum.table(ref)
    assert summarize.dryrun_table(recs, recs[:3]) == \
        jsum.dryrun_table(ref, ref[:3])
    assert [summarize.fmt_s(x) for x in (0, 5e-7, 0.25, 7.0)] == \
        [jsum.fmt_s(x) for x in (0, 5e-7, 0.25, 7.0)]


# ---------------------------------------------------------------------------
# per-device argument bytes (exact, by arithmetic on the stand-in meshes)
# ---------------------------------------------------------------------------
def _stand_in(pod):
    shape = (16, 16) if pod is None else (pod, 16, 16)
    names = ("data", "model") if pod is None else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.zeros(shape))


def _ref_bytes(tree, specs, mesh) -> dict:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_of = {jsh._path_names(p): s for p, s in
               jax.tree_util.tree_flatten_with_path(
                   specs, is_leaf=lambda x: isinstance(x, JP))[0]}
    out = {}
    for path, leaf in leaves:
        name = jsh._path_names(path)
        n = 1
        for i, size in enumerate(leaf.shape):
            entry = spec_of[name][i] if i < len(spec_of[name]) else None
            axes = () if entry is None else \
                entry if isinstance(entry, tuple) else (entry,)
            n *= size // math.prod(sizes[a] for a in axes)
        out[name] = n * jnp.dtype(leaf.dtype).itemsize
    return out


def _port_bytes(tree, specs, mesh) -> dict:
    sizes = tsh.axis_sizes(mesh)
    spec_of = dict(tsh.tree_paths(specs))
    return {path: math.prod(dryrun.block_shape(leaf.shape, spec_of[path],
                                               sizes)) * leaf.element_size()
            for path, leaf in tsh.tree_paths(tree)
            if isinstance(leaf, torch.Tensor)}


@pytest.mark.parametrize("pod", [None, 2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_per_device_match_reference(arch, pod):
    """Params (bf16, as served), the train state (with the cell's
    overrides), the caches and every kind's batch: each leaf's bytes on
    one device.  The dry-run's caches are ``cache_specs``' leaves but for
    the length, a host int in the port (the reference's int32 counter)."""
    mesh = _stand_in(pod)
    assert dryrun.TRAIN_OVERRIDES == jdry.TRAIN_OVERRIDES
    tcfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    got = _port_bytes(dryrun._serve_param_specs(tcfg), tsh.param_pspecs(
        tcfg, dryrun._serve_param_specs(tcfg), mesh), mesh)
    jp = jdry._serve_param_specs(jcfg)
    assert got == _ref_bytes(jp, jsh.param_pspecs(jcfg, jp, mesh), mesh)

    tcfg_t, ov = dryrun._apply_overrides(tcfg, "train")
    jcfg_t, _ = jdry._apply_overrides(jcfg, "train")
    opt = ov.get("opt_dtype", "float32")
    tstate = dryrun._train_state(tcfg_t, getattr(torch, opt))
    jstate = jax.eval_shape(lambda: jdry._train_state(jcfg_t,
                                                      jnp.dtype(opt)))
    assert _port_bytes(tstate, tsh.state_pspecs(tcfg_t, tstate, mesh),
                       mesh) == _ref_bytes(
        jstate, jsh.state_pspecs(jcfg_t, jstate, mesh), mesh)

    tc = ttr.cache_specs(tcfg, 128, 32768)
    jc = jtr.cache_specs(jcfg, 128, 32768)
    assert _port_bytes(tc, tsh.cache_pspecs(tcfg, tc, mesh), mesh) == \
        _ref_bytes(jc, jsh.cache_pspecs(jcfg, jc, mesh), mesh)
    live = dryrun.serve_caches(tcfg, tconfigs.SHAPES["decode_32k"])
    assert {p: tuple(t.shape) for p, t in tsh.tree_paths(live)
            if isinstance(t, torch.Tensor)} == \
        {p: tuple(t.shape) for p, t in tsh.tree_paths(tc)
         if p[-1] != "length"}

    for shape in JSHAPES:
        tb = dryrun.input_specs(tcfg, tconfigs.SHAPES[shape])
        jb = jdry.input_specs(jcfg, JSHAPES[shape])
        assert _port_bytes(tb, tsh.batch_pspecs(
            tcfg, tconfigs.SHAPES[shape], mesh, tb), mesh) == _ref_bytes(
            jb, jsh.batch_pspecs(jcfg, JSHAPES[shape], mesh, jb), mesh)


# ---------------------------------------------------------------------------
# FLOPs of a traced step against the reference's HLO
# ---------------------------------------------------------------------------
#: (kind, batch, sequence or cache length) of the reduced cells
KINDS = {"train": (2, 32), "prefill": (2, 32), "decode": (2, 32)}


def _ref_step_flops(cfg, shape) -> float:
    """hlo_cost.analyze of the reference's jitted step, as its
    ``lower_cell`` builds it (accum 1, remat full) on one device."""
    batch = jdry.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = JAdamW(schedule=jcosine(3e-4, 2000, 100_000))
        step = jtrainer.make_train_step(cfg, opt, remat_policy="full",
                                        accum=1)
        state = jax.eval_shape(lambda: jtrainer.init_train_state(
            cfg, jax.random.PRNGKey(0)))
        lowered = jax.jit(step).lower(state, batch)
    else:
        params = jdry._serve_param_specs(cfg)
        caches = jtr.cache_specs(cfg, shape.global_batch, shape.seq_len)

        def serve(params, batch, caches):
            if shape.kind == "prefill":     # as the reference's lower_cell
                return jtr.prefill(cfg, params, batch["tokens"], caches,
                                   extra_embeds=batch.get("extra_embeds"))
            return jtr.decode_step(cfg, params, batch["token"], caches)
        lowered = jax.jit(serve).lower(params, batch, caches)
    return hlo_cost.analyze(lowered.compile().as_text()).flops


def _ref_attention_flops(cfg, shape) -> float:
    """The reference's attention FLOPs in the step: hlo_cost of its
    ``attention`` alone at one layer's shapes (a prefill's forward; a
    train step's forward and, remat full, its forward again with its
    backward; a decode step's dense product over the cache), times the
    layers."""
    B, S = shape.global_batch, shape.seq_len
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = jnp.dtype(cfg.compute_dtype)
    layers = sum(g.count * len(g.pattern) for g in cfg.groups)
    kv = [jax.ShapeDtypeStruct((B, S, K, D), dt)] * 2
    if shape.kind == "decode":
        q = jax.ShapeDtypeStruct((B, 1, H, D), dt)
        fn = jax.jit(lambda q, k, v: jlayers.attention(q, k, v,
                                                       q_offset=S - 1))
        return layers * hlo_cost.analyze(
            fn.lower(q, *kv).compile().as_text()).flops
    q = jax.ShapeDtypeStruct((B, S, H, D), dt)
    fwd = hlo_cost.analyze(jax.jit(jlayers.attention).lower(
        q, *kv).compile().as_text()).flops
    if shape.kind == "prefill":
        return layers * fwd

    def vjp(q, k, v, dout):
        return jax.vjp(jlayers.attention, q, k, v)[1](dout)
    both = hlo_cost.analyze(jax.jit(vjp).lower(
        q, *kv, q).compile().as_text()).flops
    return layers * (fwd + both)


def _trace(cfg, shape, mesh_shape=(1, 1)):
    with dryrun.fake_world(math.prod(mesh_shape)):
        mesh = dryrun.fake_mesh(mesh_shape, ("data", "model"))
        lowered, _ = dryrun.lower_cell(cfg, shape, mesh,
                                       extra_overrides={"accum": 1})
        return lowered.trace()


#: the carries among each xLSTM loop op's operands: the recurrence's start
CARRIES = {"slstm_scan": (3, 4, 5, 6), "mlstm_scan": (5, 6, 7)}


def _carry_gradient_flops(monkeypatch) -> list:
    """Records, for every backward loop op a trace counts, the FLOPs the
    gradients of its start carries would add: the reference's scan body
    is the same for every step, so its backward takes the first step's
    carries' gradients too (the port's loop takes none for a start that
    takes none)."""
    from torch.utils.flop_counter import flop_registry

    from repro_torch.models import xlstm

    extra = []
    for loop_op in (xlstm.slstm_scan, xlstm.mlstm_scan):
        def spy(*args, loop_op=loop_op, count=flop_registry[loop_op.bwd],
                **kwargs):
            grads, tensors, statics, _, needs = loop_op._split(args)
            strides = tuple(None if g is None else g.stride() for g in grads)
            carries = sum(1 << i for i in CARRIES[loop_op.name])
            extra.append(loop_op.counts(tensors, statics, needs | carries,
                                        strides).bwd_flops
                         - loop_op.counts(tensors, statics, needs,
                                          strides).bwd_flops)
            return count(*args, **kwargs)
        monkeypatch.setitem(flop_registry, loop_op.bwd, spy)
    return extra


#: the reduced cells held against the reference's HLO: phi3's and
#: minicpm's train, prefill and decode steps; xLSTM's and qwen2-vl's
#: (M-RoPE, the visual positions) train and prefill steps
HLO_CELLS = [(arch, kind) for arch in ("phi3-mini-3.8b", "minicpm-2b")
             for kind in KINDS] + [(arch, kind)
                                   for arch in ("xlstm-1.3b", "qwen2-vl-7b")
                                   for kind in ("train", "prefill")]


@pytest.mark.parametrize("arch,kind", HLO_CELLS)
def test_op_cost_flops_match_reference_hlo_cost(arch, kind, monkeypatch):
    """The named differences: attention (dense in the reference, the pairs
    computed in the port) and, for xLSTM, the start carries' gradients
    (:func:`_carry_gradient_flops`); the rest within FLOP_RTOL."""
    B, S = KINDS[kind]
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jcfg = jreduced(jget_config(arch))
    carries = _carry_gradient_flops(monkeypatch)
    cost, memory, _ = _trace(tcfg, ShapeConfig("cell", S, B, kind))
    want = _ref_step_flops(jcfg, JShape("cell", S, B, kind))
    ref_attn = _ref_attention_flops(jcfg, JShape("cell", S, B, kind)) \
        if jcfg.n_heads and tcfg.family != "ssm" else 0
    port_attn = sum(v for k, v in cost.flops_by_op.items()
                    if k.startswith("repro_torch.flash")
                    or k.startswith("repro_torch.decode"))
    gap = ref_attn - port_attn
    assert gap >= 0 if kind != "decode" else gap == 0, (ref_attn, port_attn)
    gap += sum(carries)
    assert abs((cost.flops + gap) - want) <= FLOP_RTOL * want, \
        (cost.flops, want, gap)
    assert memory["per_device_total"] >= memory["argument_bytes"] > 0


def test_flop_counter_on_a_plain_fake_step_equals_op_cost():
    """The same step on plain fake tensors (no mesh) under
    ``FlopCounterMode`` counts what op_cost counts on the 1×1 mesh: the
    check phase 8 of ``chip_smoke.py`` makes against the real step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cfg = tconfigs.reduced(tconfigs.get_config("minicpm-2b"))
    shape = ShapeConfig("cell", 32, 2, "train")
    cost, _, _ = _trace(cfg, shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        state = ttrainer.train_state_specs(cfg)
        tokens = torch.zeros((2, 32), dtype=torch.int32, device="meta")
        with FlopCounterMode(display=False) as counter:
            dryrun.step_fn(cfg, shape)(state, {"tokens": tokens,
                                               "labels": tokens})
    assert counter.get_total_flops() == cost.flops


def test_a_column_parallel_matmul_counts_its_block():
    """On a 2×2 fake mesh, x (batch over data) @ w (columns over model)
    counts one rank's product, a quarter of the global one
    (``FlopCounterMode`` around DTensor code would count the global)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with dryrun.fake_world(4):
        mesh = dryrun.fake_mesh((2, 2), ("data", "model"))
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = dryrun._distribute(mesh, torch.empty(
                64, 96, device="meta"), tsh.P("data", None))
            w = dryrun._distribute(mesh, torch.empty(
                96, 128, device="meta"), tsh.P(None, "model"))
            with op_cost.OpCost() as counter:
                y = x @ w
    assert tuple(y.to_local().shape) == (32, 64)
    assert counter.cost.flops == 2 * 64 * 96 * 128 / 4
    assert counter.cost.coll_counts == {}


# ---------------------------------------------------------------------------
# the kernels' custom ops
# ---------------------------------------------------------------------------
def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=torch.float32):
        return torch.randn(*s, generator=g).to(dtype)

    q, k, v = r(2, 16, 4, 8), r(2, 16, 2, 8), r(2, 16, 2, 8)
    out, lse = tk.flash_attention_plain(q, k, v, with_lse=True)
    dy, a, h0 = r(2, 9, 16), torch.rand(2, 9, 16, generator=g), r(2, 16)
    return {
        "flash_attention": (
            lambda *t: tk.flash_attention(*t, with_lse=True),
            lambda *t: tk.flash_attention_plain(*t, with_lse=True),
            (q, k, v)),
        "flash_attention_bwd": (tk.flash_attention_bwd,
                                tk.flash_attention_bwd_plain,
                                (q, k, v, out, r(2, 16, 4, 8), lse)),
        "decode_attention": (tk.decode_attention, tk.decode_attention_plain,
                             (q[:, 0], k, v,
                              torch.tensor([3, 16], dtype=torch.int32))),
        "rglru_scan": (tk.rglru_scan, tk.rglru_scan_plain, (dy, a, h0)),
        "rglru_scan_bwd": (tk.rglru_scan_bwd, tk.rglru_scan_bwd_plain,
                           (dy, a, r(2, 9, 16), h0)),
        "moe_gating": (lambda t: tk.moe_gating(t, top_k=2, capacity=4),
                       lambda t: tk.moe_gating_plain(t, top_k=2, capacity=4),
                       (r(24, 8),)),
    }


@pytest.mark.parametrize("kernel", list(_kernel_cases()))
def test_custom_op_fakes_match_plain_versions(kernel):
    """A fake CUDA tensor goes to the kernel's custom op and gets the
    plain version's outputs' shapes and dtypes (nothing runs); the op's
    cost formula counts it under ``FlopCounterMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    wrapper, plain, args = _kernel_cases()[kernel]
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [torch.empty(t.shape, dtype=t.dtype, device="meta")
                for t in args]
        with FlopCounterMode(display=False) as counter:
            got = wrapper(*fake)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert counter.get_total_flops() > 0
    packet = getattr(torch.ops.repro_torch, kernel)
    assert packet in tk._cost.BYTES


def test_sharded_kernel_routes_at_world_size_two(tmp_path):
    """Two spawned gloo ranks running
    ``_torch_dist_ranks.kernel_routes_main``: GQA with a replicated kv
    head and q heads sharded (flash forward and gradients, decode), the
    scan over sharded channels and its backward, gating on token-sharded
    logits — each the whole call's result."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).parent), str(Path(__file__).parents[1] / "src"),
         os.environ.get("PYTHONPATH", "")]), JAX_PLATFORMS="cpu")
    code = ("import sys, _torch_dist_ranks as r; "
            "r.kernel_routes_main(int(sys.argv[1]), 2, sys.argv[2])")
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


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_dryrun_main_writes_a_full_record(tmp_path):
    """phi3-mini-3.8b × decode_32k on the fake 16×16 mesh: the record has
    every key of the reference's (``compile_s`` as ``trace_s``, its raw
    XLA cost as the eager count) and fits one card."""
    assert dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "phi3-mini-3.8b__decode_32k__pod1.json")
                     .read_text())
    want = {"arch", "shape", "kind", "overrides", "mesh", "chips",
            "seq_shard", "multi_pod", "remat_policy", "lower_s", "trace_s",
            "memory", "collectives", "eager_op_cost", "roofline", "fits"}
    assert set(rec) == want
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "per_device_total"}
    assert set(rec["roofline"]) == set(jroof.Roofline(
        1, 1, 1, 1).to_dict())
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["chips"] == 256
    assert rec["fits"] and rec["memory"]["alias_bytes"] > 0
    assert rec["roofline"]["flops_per_chip"] > 0
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0
