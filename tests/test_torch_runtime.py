"""The port's task-graph runtime against the JAX package's: the same graphs
dump, place, schedule and simulate identically, and the paper's saxpy,
``writes=`` and spill scenarios push the same host arrays when the port's
executor runs them on a CPU device."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of one thread per core would crowd the timing-
# sensitive runtime tests running beside these
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.sched as jsched  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.sched as tsched  # noqa: E402

BINS = ["d0", "d1", "d2"]
POLICIES = ["balanced", "heft", "round_robin", "random"]


def _model(sched):
    """Unit-rate, zero-latency model with kernel-declared costs (the
    JAX package's scheduler goldens use the same)."""
    return sched.CostModel(
        compute_rate=1.0, h2d_bandwidth=float("inf"),
        d2d_bandwidth=float("inf"), latency_s=0.0, host_time_s=0.0,
        cost_fn=lambda n: float(n.state.get("cost", 0.0)))


def _kern(G, name, cost, *deps):
    p = G.pull(np.zeros(4), name=f"p_{name}")
    k = G.kernel(lambda own, *d: None, p, *deps, cost=cost, name=name)
    k.succeed(p)
    for d in deps:
        k.succeed(d)
    return k


def _chain(core):
    G = core.Heteroflow("chain")
    a = _kern(G, "a", 1.0)
    b = _kern(G, "b", 2.0, a)
    _kern(G, "c", 3.0, b)
    return G


def _fanout(core):
    G = core.Heteroflow("fanout")
    root = _kern(G, "root", 1.0)
    for i, c in enumerate((5.0, 3.0, 2.0, 2.0)):
        _kern(G, f"br{i}", c, root)
    return G


def _diamond(core):
    G = core.Heteroflow("diamond")
    root = _kern(G, "root", 2.0)
    mids = [_kern(G, f"m{i}", c, root) for i, c in enumerate((4.0, 3.0, 1.0))]
    _kern(G, "join", 2.0, *mids)
    return G


def _random_dag(core, n=24, seed=7):
    """Kernels with their own pulls, random costs and random earlier deps,
    plus shared pulls read by several kernels (multi-kernel groups)."""
    rng = np.random.default_rng(seed)
    G = core.Heteroflow("random")
    shared = [G.pull(np.zeros(8 * (i + 1)), name=f"shared{i}")
              for i in range(3)]
    ks = []
    for i in range(n):
        deps = [ks[j] for j in sorted(set(rng.integers(0, i, 2)))] if i else []
        args = [shared[i % 3]] if rng.random() < 0.3 else []
        k = _kern(G, f"k{i}", float(rng.integers(1, 9)), *deps)
        ks.append(k)
        if args:
            k2 = G.kernel(lambda *a: None, *args, cost=1.0, name=f"s{i}")
            k2.succeed(args[0], k)
    return G


def _saxpy_graph(core):
    G = core.Heteroflow("saxpy")
    x = np.zeros(8, np.float32)
    y = np.zeros(8, np.float32)
    hx = G.host(lambda: x.__setitem__(slice(None), 1.0), name="host_x")
    hy = G.host(lambda: y.__setitem__(slice(None), 2.0), name="host_y")
    px = G.pull(x, name="pull_x")
    py = G.pull(y, name="pull_y")
    k = G.kernel(lambda a, xs, ys: a * xs + ys, 2.0, px, py, writes=(py,),
                 name="saxpy")
    push = G.push(py, y, name="push_y")
    hx.precede(px)
    hy.precede(py)
    k.succeed(px, py).precede(push)
    return G, y


SHAPES = {"chain": _chain, "fanout": _fanout, "diamond": _diamond,
          "random": _random_dag, "saxpy": lambda c: _saxpy_graph(c)[0]}


def _canon_dump(G):
    """DOT dump with node ids renumbered by position (ids are drawn from
    one process-wide counter per package)."""
    pos = {n.id: i for i, n in enumerate(G.nodes)}
    return re.sub(r"\bn(\d+)\b", lambda m: f"n{pos[int(m.group(1))]}",
                  G.dump())


def _by_position(G, placement):
    pos = {n.id: i for i, n in enumerate(G.nodes)}
    return {pos[nid]: b for nid, b in placement.items()}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dump_identical(shape):
    assert (_canon_dump(SHAPES[shape](tcore))
            == _canon_dump(SHAPES[shape](jcore)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_place_identical(shape):
    jg, tg = SHAPES[shape](jcore), SHAPES[shape](tcore)
    assert (_by_position(tg, tcore.place(tg, BINS))
            == _by_position(jg, jcore.place(jg, BINS)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_placement_and_makespan_identical(shape, policy):
    out = []
    for core, sched in ((jcore, jsched), (tcore, tsched)):
        G = SHAPES[shape](core)
        model = _model(sched)
        kwargs = {"cost_model": model} if policy == "heft" else {}
        pl = sched.get_scheduler(policy, **kwargs).schedule(
            G, BINS, model.cost_fn)
        rep = sched.simulate(G, pl, BINS, cost_model=model)
        out.append((_by_position(G, pl), rep.makespan, rep.utilization))
    assert out[0] == out[1]


def test_quickstart_saxpy_pushes_equal_arrays():
    G, y = _saxpy_graph(jcore)
    with jcore.Executor(num_workers=4) as ex:
        ex.run(G).result(timeout=60)
    tG, ty = _saxpy_graph(tcore)
    with tcore.Executor(num_workers=4, devices=[torch.device("cpu")]) as ex:
        ex.run(tG).result(timeout=60)
        assert ex.stats()["lane_depths"] == {"cpu:0": 3}
    np.testing.assert_array_equal(ty, y)
    np.testing.assert_allclose(ty, 4.0)


def _accumulate(core):
    """``writes=`` across repeats: y += x every iteration, pushed each
    time, plus a kernel consuming another kernel's device output."""
    x = np.arange(16, dtype=np.float32)
    y = np.zeros(16, np.float32)
    out = np.zeros(16, np.float32)
    G = core.Heteroflow("accumulate")
    px = G.pull(x, name="px")
    py = G.pull(lambda: y, name="py")
    k = G.kernel(lambda a, b: a + b, px, py, writes=(py,), name="acc")
    k2 = G.kernel(lambda s: s * 2, k, name="double")
    push = G.push(py, y, name="push_y")
    pull_o = G.pull(out, name="po")
    k3 = G.kernel(lambda o, d: d + 0 * o, pull_o, k2, writes=(pull_o,),
                  name="store")
    push_o = G.push(pull_o, out, name="push_o")
    k.succeed(px, py).precede(push, k2)
    k3.succeed(pull_o, k2).precede(push_o)
    return G, y, out


@pytest.mark.parametrize("fuse_batch", [0, 4])
@pytest.mark.parametrize("n_iter", [1, 3])
def test_writes_rebind_and_repeat_push_equal_arrays(n_iter, fuse_batch):
    """Also under fused dispatch: the three source pulls run as one batch
    inside one (re-entrant) device scope."""
    results = []
    for core, kw in ((jcore, {}), (tcore, {"devices": [torch.device("cpu")]})):
        G, y, out = _accumulate(core)
        with core.Executor(num_workers=2, fuse_batch=fuse_batch, **kw) as ex:
            assert ex.run_n(G, n_iter).result(timeout=60) == n_iter
        results.append((y.copy(), out.copy()))
    (jy, jo), (ty, to) = results
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ty, np.arange(16) * n_iter)


def _spill_run(core, sched, device):
    dev = sched.DeviceBin(device, memory_bytes=16384)   # 2 of 4 pulls fit
    G = core.Heteroflow("spill")
    ks = []
    for i in range(4):
        p = G.pull(np.full(8192, i, np.uint8), name=f"p{i}")
        k = G.kernel(lambda a: np.asarray(a).sum(dtype=np.int64), p,
                     name=f"k{i}")
        k.succeed(p)
        ks.append(k)
    with core.Executor(num_workers=1, devices=[dev]) as ex:
        ex.run(G).result(timeout=120)
        stats = ex.stats()
    return [int(k._node.state["result"]) for k in ks], stats


def test_spill_to_host_under_budget_equal_results():
    jres, jstats = _spill_run(jcore, jsched, jax.devices()[0])
    tres, tstats = _spill_run(tcore, tsched, torch.device("cpu"))
    assert tres == jres == [i * 8192 for i in range(4)]
    for key in ("spills", "spilled_bytes", "refills", "refilled_bytes"):
        assert tstats[key] == jstats[key], key
    assert tstats["spills"] >= 2
    assert all(p <= 16384 for p in tstats["arena_peak_bytes"].values())


def test_executor_needs_explicit_bins_without_cuda(monkeypatch):
    """No silent CPU fallback: with no CUDA device and no bins, raise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        tcore.Executor(num_workers=1)


def test_device_bins_and_keys_follow_torch_devices():
    cpu = torch.device("cpu")
    b = tsched.DeviceBin(cpu)
    assert b.label == "cpu:0" and b.capabilities == {"device", "cpu"}
    assert b.put_target() == cpu
    assert tsched.bin_capabilities(cpu) == {"device", "cpu"}
    assert tcore.streams.device_key(torch.device("cuda", 1)) == "cuda:1"
    assert tcore.streams.bin_labels([cpu, cpu]) == ["cpu:0#0", "cpu:0#1"]
    mesh = tsched.MeshBin("m", {"x": 2})
    with pytest.raises(RuntimeError, match="synthetic"):
        mesh.put_target()


def test_scoped_context_is_reentrant_and_a_noop_on_cpu():
    from repro_torch.core.streams import ScopedDeviceContext, _scope_stack
    cpu = torch.device("cpu")
    with ScopedDeviceContext(cpu):
        with ScopedDeviceContext(tsched.DeviceBin(cpu)):
            assert len(_scope_stack.keys) == 2
    assert _scope_stack.keys == []
