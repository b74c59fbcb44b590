"""The dry-run's last three cells (xlstm-1.3b × prefill_32k and × train_4k,
qwen2-vl-7b × train_4k) and what lets them trace: xLSTM's batch-only
layouts, its two recurrences (the sLSTM's steps, the mLSTM's chunks) as
custom ops that count the plain loop's steps (``models/loop_op.py``, the
counterpart of the reference's ``lax.scan``), and a loss that masks the
visual positions instead of slicing the logits.

Exact: a counted trace's FLOPs and bytes against ``OpCost`` over the real
CPU step (which runs the loops step by step), the number of operations a
trace dispatches at S 64 and at S 512, the collectives of a 2×2 trace at
S 64 and at S 128, a loop op's forward against its loop (bit for bit) and
its counts over three steps against the loop's.  Within ``MEMORY_BAND``
(``chip_smoke.py``'s phase 8 band): the trace's peak over the real step's
tracked peak.  Within rtol 2e-4, atol 2e-5 (the training tests' gradient
tolerance): a loop op's backward against autograd through its loop.
Inputs are made from seeds with numpy, or are shape-only.  The JAX
package is not needed: the loops themselves are held against the
reference by ``test_torch_models.py`` and ``test_torch_training.py``."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import MEMORY_BAND  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.kernels import _cost  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.models.loop_op import (_ENTRIES, _MOST,  # noqa: E402
                                        _LoopFunction, _mask)
from repro_torch.training import init_train_state  # noqa: E402

XLSTM, QWEN = "xlstm-1.3b", "qwen2-vl-7b"
#: the training tests' gradient tolerance (test_torch_training.py)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
#: the cells the port's dry-run did not trace before, and the most a
#: trace of one may take on one CPU core
FULL_CELLS = [(XLSTM, "prefill_32k"), (XLSTM, "train_4k"),
              (QWEN, "train_4k")]
MAX_TRACE_S = 300


@pytest.fixture(scope="module", autouse=True)
def _no_group_left():
    """A dry-run takes down a process group it finds and its own fake one
    on exit; the module leaves none up."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfg(arch):
    return tconfigs.reduced(tconfigs.get_config(arch))


@pytest.fixture(scope="module")
def traced():
    """``traced(arch, kind, S, mesh)``: the record of the reduced cell at
    batch 2 (accum 1), traced once for the module."""
    recs = {}

    def get(arch, kind, S, mesh):
        key = (arch, kind, S, mesh)
        if key not in recs:
            recs[key] = dryrun.run_cell(
                _cfg(arch), ShapeConfig("cell", S, 2, kind), mesh_shape=mesh,
                extra_overrides={"accum": 1})
        return recs[key]
    return get


@pytest.mark.parametrize("arch,kind", [(XLSTM, "prefill"), (XLSTM, "train"),
                                       (QWEN, "train")])
def test_reduced_cells_trace_on_a_2x2_mesh(traced, arch, kind):
    """The mLSTM (q, k, v, the gates, the carries and h batch-local), the
    sLSTM op (batch rows, r and b whole) and qwen2-vl's loss over the
    masked visual positions trace on a mesh with a model axis."""
    rec = traced(arch, kind, 64, (2, 2))
    assert rec["mesh"] == {"data": 2, "model": 2} and rec["chips"] == 4
    assert rec["eager_op_cost"]["flops"] > 0
    assert rec["memory"]["per_device_total"] > \
        rec["memory"]["argument_bytes"] > 0
    assert rec["collectives"]["counts"].get("all-gather", 0) > 0


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_xlstm_collectives_do_not_grow_with_the_sequence(traced, kind):
    """The sLSTM op gathers r once a call and reduces its gradient once a
    call: a trace twice as long issues the same collectives."""
    short, long_ = (traced(XLSTM, kind, S, (2, 2)) for S in (64, 128))
    assert short["collectives"]["counts"] == long_["collectives"]["counts"]
    assert long_["eager_op_cost"]["flops"] > short["eager_op_cost"]["flops"]


def test_carry_rules_brings_the_rules_into_another_thread():
    """A checkpointed block recomputed in the backward runs on the
    autograd engine's thread for its device (on the card, CUDA's): the
    rules and DTensor's implicit replication in force where the block
    first ran hold there too, and the thread's own come back after."""
    import threading
    import types

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import context

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros((2, 2)))
    seen = []

    def probe():
        seen.append((context.constraint_spec((4, 8, 16), "batch_only"),
                     context._implicit_replication()))
    with context.use_sharding_rules(mesh=mesh), implicit_replication():
        carried = context.carry_rules(probe)
    worker = threading.Thread(target=lambda: (carried(), probe()))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive()
    assert seen == [(tsh.P("data", None, None), True), (None, False)]


def _trace(cfg, shape):
    """(cost, memory) of ``shape`` traced on a 1×1 fake mesh, accum 1."""
    with dryrun.fake_world(1):
        mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
        lowered, _ = dryrun.lower_cell(cfg, shape, mesh,
                                       extra_overrides={"accum": 1})
        cost, memory, _ = lowered.trace()
    return cost, memory


def _real_step(cfg, shape):
    """The cell's step function and real CPU inputs of the dtypes the
    dry-run gives them (serving: every floating leaf bf16), from seed 0."""
    gen = torch.Generator().manual_seed(0)
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    fn = dryrun.step_fn(cfg, shape, accum=1)
    if shape.kind == "train":
        return fn, (init_train_state(cfg, gen, "cpu"),
                    {"tokens": tokens, "labels": tokens})
    params = dryrun._map(lambda t: t.to(dryrun.SERVE_DTYPE)
                         if t.is_floating_point() else t,
                         init_params(cfg, gen, "cpu"))
    return fn, (params, {"tokens": tokens},
                dryrun.serve_caches(cfg, shape, device="cpu"))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_counted_trace_matches_a_real_cpu_step(kind):
    """Reduced xLSTM at B 2 × S 64 on a 1×1 fake mesh: the trace counts
    the two loop ops by their formulas, the real step runs the loops step
    by step under ``OpCost``; FLOPs and bytes agree exactly and the
    trace's peak (the ops' residuals and workspaces standing for what the
    loops hold) lies in ``MEMORY_BAND`` of the real step's."""
    cfg, shape = _cfg(XLSTM), ShapeConfig("cell", 64, 2, kind)
    cost, memory = _trace(cfg, shape)
    ops = {"repro_torch.slstm_scan", "repro_torch.mlstm_scan"}
    assert ops <= set(cost.flops_by_op)
    fn, args = _real_step(cfg, shape)
    mem = op_cost.RankMemTracker()
    mem.track_external(*dryrun._leaves(args))
    with mem, op_cost.OpCost() as counter:
        fn(*args)
    peak = max(snap["Total"]
               for snap in mem.get_tracker_snapshot("peak").values())
    assert not ops & set(counter.cost.flops_by_op)
    assert (cost.flops, cost.bytes) == (counter.cost.flops,
                                        counter.cost.bytes)
    ratio = memory["per_device_total"] / peak
    assert MEMORY_BAND[0] <= ratio <= MEMORY_BAND[1], ratio


class _Counting(op_cost.OpCost):
    """``OpCost`` that counts the operations it is shown."""
    calls = 0

    def _count(self, *args):
        type(self).calls += 1
        super()._count(*args)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_a_trace_dispatches_as_many_operations_at_any_length(monkeypatch,
                                                             kind):
    """The sLSTM loop runs S steps of some 20 operations each; traced, it
    is one op, so a trace at S 512 dispatches what one at S 64 does (and
    the mLSTM's chunk loop is one op at any number of chunks)."""
    monkeypatch.setattr(dryrun, "OpCost", _Counting)
    calls = []
    for S in (64, 512):
        _Counting.calls = 0
        _trace(_cfg(XLSTM), ShapeConfig("cell", S, 2, kind))
        calls.append(_Counting.calls)
    assert calls[0] == calls[1] > 0


def _loop_case(name, rng, state=True, steps=3):
    """(the LoopOp, its operands, its statics) for an sLSTM call of
    ``steps`` steps (B 2, d 16, H 4) or an mLSTM call of ``steps`` chunks
    of 4 (B 2, H 4, dh 8), f32, from ``rng``; without ``state`` the
    carries are the recurrences' start."""
    def f(*shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape) * scale,
                            dtype=torch.float32)
    B, H = 2, 4
    if name == "slstm":
        d = 16
        carries = (f(B, d), f(B, d), f(B, d).abs() + 1, f(B, d)) if state \
            else (torch.zeros(B, d), torch.zeros(B, d), torch.ones(B, d),
                  torch.zeros(B, d))
        return X.slstm_scan, (f(B, steps, 4 * d), f(H, d // H, 4 * d // H,
                                                   scale=0.5), f(4 * d),
                              *carries), ()
    dh, S = 8, 4 * steps
    # q, k, v and the gates as the model makes them: transposed views
    q, k, v = (f(B, S, H, dh).transpose(1, 2) for _ in range(3))
    log_i = f(B, S, H).transpose(1, 2)
    log_f = -f(B, S, H).abs().transpose(1, 2)
    carries = (f(B, H, dh, dh, scale=0.1), f(B, H, dh), f(B, H)) if state \
        else X._zero_state(q)
    return X.mlstm_scan, (q, k, v, log_i, log_f, *carries), (4,)


LOOPS = ["slstm", "mlstm"]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("name", LOOPS)
def test_loop_ops_equal_their_loops_bit_for_bit(name, state):
    """The forward op on real tensors is the loop itself, plus a residual
    and a workspace of the bytes a batch row asked for."""
    loop_op, args, statics = _loop_case(name, np.random.default_rng(0),
                                        state)
    want = loop_op.loop(*args, *statics)
    *got, res, ws = loop_op.op(*args, *statics, 5, 3)
    assert len(got) == len(want) == loop_op.n_out
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (tuple(res.shape), tuple(ws.shape)) == ((2, 5), (2, 3))


#: (the operands that take a gradient, the outputs given one), by loop: a
#: train step's, and every operand and output (a prompt after a state)
_BWD_CASES = {"slstm": {"train": ((0, 1, 2), (0,)),
                        "all": (tuple(range(7)), tuple(range(5)))},
              "mlstm": {"train": (tuple(range(5)), (0,)),
                        "all": (tuple(range(8)), tuple(range(4)))}}


@pytest.mark.parametrize("case", ["train", "all"])
@pytest.mark.parametrize("name", LOOPS)
def test_loop_op_backward_matches_autograd_through_the_loop(name, case):
    """The backward op on real tensors, and :class:`_LoopFunction`
    (forward op, then backward op) on real tensors, against autograd
    through the loop: outputs equal, gradients within the training tests'
    tolerance, an operand not asked for gets none."""
    rng = np.random.default_rng(1)
    loop_op, args, statics = _loop_case(name, rng, case == "all")
    wrt, given = _BWD_CASES[name][case]
    needs = _mask(i in wrt for i in range(len(args)))
    ins = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    outs = loop_op.loop(*ins, *statics)
    grads = [torch.tensor(rng.standard_normal(o.shape), dtype=torch.float32)
             for o in outs]
    want = torch.autograd.grad([outs[i] for i in given],
                               [a for a in ins if a.requires_grad],
                               [grads[i] for i in given])
    absent = torch.empty(0)
    *got, _ = loop_op.bwd(
        *(g if i in given else absent for i, g in enumerate(grads)), *args,
        torch.empty((2, 0), dtype=torch.uint8), *statics, 0, needs)
    assert [tuple(g.shape) for i, g in enumerate(got) if i not in wrt] == \
        [(0,)] * (len(args) - len(wrt))
    for w, g in zip(want, [g for i, g in enumerate(got) if i in wrt]):
        torch.testing.assert_close(g, w, **GRAD_TOL)

    ins2 = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    outs2 = _LoopFunction.apply(loop_op, statics, *ins2)
    for o, o2 in zip(outs, outs2):
        assert torch.equal(o.detach(), o2.detach())
    got2 = torch.autograd.grad([outs2[i] for i in given],
                               [a for a in ins2 if a.requires_grad],
                               [grads[i] for i in given])
    for w, g in zip(want, got2):
        torch.testing.assert_close(g, w, **GRAD_TOL)


@pytest.mark.parametrize("name", LOOPS)
def test_loop_ops_fakes_and_formulas_count_the_loop(name):
    """On fake tensors the LoopOp is its ops: outputs of the loop's
    shapes, dtypes and layouts, and ``FlopCounterMode`` over its forward
    and backward counts what it counts over the real loop's steps; both
    ops have a byte formula."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    loop_op, args, statics = _loop_case(name, np.random.default_rng(2),
                                        state=False)
    wrt = (0, 1, 2)
    with FlopCounterMode(display=False) as real:
        ins = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
        want = loop_op(*ins, *statics)
        want[0].sum().backward()
    with FakeTensorMode():
        fake = [torch.empty_strided(a.shape, a.stride(), device="meta")
                .requires_grad_(i in wrt) for i, a in enumerate(args)]
        with FlopCounterMode(display=False) as counter:
            got = loop_op(*fake, *statics)
            got[0].sum().backward()
        layouts = [(tuple(t.shape), t.stride(), t.dtype) for t in got]
    assert layouts == [(tuple(t.shape), t.stride(), t.dtype) for t in want]
    assert counter.get_total_flops() == real.get_total_flops() > 0
    assert set(counter.get_flop_counts()["Global"]) == {loop_op.op,
                                                        loop_op.bwd}
    assert loop_op.op in _cost.BYTES and loop_op.bwd in _cost.BYTES


@pytest.mark.parametrize("needs", ["none", "train", "all"])
@pytest.mark.parametrize("name", LOOPS)
def test_loop_counts_grow_by_one_step_at_a_time(name, needs):
    """The ops' counts take n steps as two and n - 2 times what a third
    adds: four steps of the loop, counted, are what they give."""
    loop_op, args, statics = _loop_case(name, np.random.default_rng(3),
                                        state=needs == "all", steps=4)
    wrt = () if needs == "none" else _BWD_CASES[name][needs][0]
    mask = _mask(i in wrt for i in range(len(args)))
    assert loop_op.trips(*args, *statics) == 4
    sig = ("meta", tuple((tuple(a.shape), a.stride(), a.dtype)
                         for a in args), statics)
    four = loop_op._counted(sig, 4, mask, None)[0]
    got = loop_op.counts(args, statics, mask)
    grown = [i for i, how in enumerate(_ENTRIES) if how != _MOST]
    assert [got[i] for i in grown] == [four[i] for i in grown]


@pytest.mark.slow
def test_dryrun_writes_the_three_full_cells(tmp_path):
    """``dryrun.main`` over the cells that did not trace before: a record
    each on the fake 16×16 mesh, each traced within MAX_TRACE_S.  Slow:
    about two to five minutes a cell on one core."""
    for arch, shape in FULL_CELLS:
        assert dryrun.main(["--arch", arch, "--shape", shape,
                            "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / f"{arch}__{shape}__pod1.json")
                         .read_text())
        assert rec["mesh"] == {"data": 16, "model": 16}
        assert 0 < rec["trace_s"] <= MAX_TRACE_S, rec["trace_s"]
        assert rec["roofline"]["flops_per_chip"] > 0
