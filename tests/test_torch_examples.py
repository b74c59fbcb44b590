"""The port's example twins (``examples_torch/``) against the JAX
package's examples and benchmark builders: the three application graphs
(view pipelines, detailed placement, the propagation DAG) dump, cost,
place and simulate identically; run under each package's executor they
give the same arrivals (bit for bit, and equal to the plain longest
path), models and placement objectives; and each twin's ``main()`` runs
on a CPU bin and prints the reference's report fields.  Every comparison
feeds both packages the same numpy inputs (the builders' seeded draws).
"""
import importlib.util
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))   # as tests/test_bench.py does
sys.path.insert(0, str(ROOT))

import workloads as jw  # noqa: E402  (benchmarks/workloads.py)
import repro.core as jcore  # noqa: E402
import repro.sched as jsched  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.sched as tsched  # noqa: E402
from chip_smoke import longest_path  # noqa: E402
from examples_torch import workloads as tw  # noqa: E402
from examples_torch import (detailed_placement, quickstart,  # noqa: E402
                            serve_lm, timing_analysis, train_lm)
from test_torch_runtime import _by_position, _canon_dump, _model  # noqa: E402

CPU = torch.device("cpu")
BINS = ["d0", "d1", "d2"]

#: builder calls at small sizes: (reference module or twin) -> graph
GRAPHS = {
    "views4": lambda w: w.build_timing_analysis(4)[0],
    "placement3x64": lambda w: w.build_detailed_placement(3, 64)[0],
    "dag300": lambda w: w.build_timing_graph(300, fanout=4),
    "dag300_window8": lambda w: w.build_timing_graph(300, fanout=4,
                                                      window=8),
    "dag50_fanout0": lambda w: w.build_timing_graph(50, fanout=0, seed=3),
}


def _ref_example(name):
    """The JAX package's example ``examples/<name>.py`` as a module (its
    ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(G):
    return [n for n in G.nodes if n.type.value == "kernel"]


# -- the graphs --------------------------------------------------------------
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_dump_identical(graph):
    assert (_canon_dump(GRAPHS[graph](tw))
            == _canon_dump(GRAPHS[graph](jw)))


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_names_costs_and_writes_identical(graph):
    def table(G):
        pos = {n.id: i for i, n in enumerate(G.nodes)}
        return [(n.name, n.type.value, n.state.get("cost"),
                 [pos[w._node.id] for w in n.state.get("writes", ())])
                for n in G.nodes]
    assert table(GRAPHS[graph](tw)) == table(GRAPHS[graph](jw))


@pytest.mark.parametrize("model", ["declared", "default"])
@pytest.mark.parametrize("policy", tsched.available_policies())
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_policy_placement_and_makespan_identical(graph, policy, model):
    """Under every policy of the registry: the same placement and the
    same simulated makespan, with the kernels' declared costs and with
    the examples' default ``CostModel``."""
    assert tsched.available_policies() == jsched.available_policies()
    out = []
    for w, sched in ((jw, jsched), (tw, tsched)):
        G = GRAPHS[graph](w)
        cm = _model(sched) if model == "declared" else sched.CostModel()
        kwargs = {"cost_model": cm} if policy == "heft" else {}
        pl = sched.get_scheduler(policy, **kwargs).schedule(
            G, BINS, cm.cost_fn)
        rep = sched.simulate(G, pl, BINS, cost_model=cm, host_workers=4)
        out.append((_by_position(G, pl), rep.makespan, rep.utilization))
    assert out[0] == out[1]


# -- execution under each package's executor ---------------------------------
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("n,fanout,window", [(300, 4, None), (300, 4, 8),
                                             (200, 2, 3), (40, 0, None)])
def test_timing_graph_arrivals_exact(n, fanout, window, workers):
    jG = jw.build_timing_graph(n, fanout=fanout, window=window)
    with jcore.Executor(num_workers=2) as ex:
        ex.run(jG).result(timeout=120)
    ref = np.array([k.state["result"] for k in _kernels(jG)], np.float64)
    tG = tw.build_timing_graph(n, fanout=fanout, window=window)
    with tcore.Executor(num_workers=workers, devices=[CPU]) as ex:
        ex.run(tG).result(timeout=120)
    got = timing_analysis.arrivals_of(tG)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, longest_path(tG))
    np.testing.assert_array_equal(ref, longest_path(jG))


@pytest.mark.parametrize("repeat", [1, 3])
def test_view_models_allclose(repeat):
    """The fitted models, once and under ``run_n`` (each repeat re-pulls
    the zero weights its kernel's ``writes=`` rebound)."""
    jG, jout = jw.build_timing_analysis(4)
    with jcore.Executor(num_workers=2) as ex:
        ex.run(jG).result(timeout=120)
    tG, tout = tw.build_timing_analysis(4)
    with tcore.Executor(num_workers=2, devices=[CPU]) as ex:
        assert ex.run_n(tG, repeat).result(timeout=120) == repeat
    assert all((o != 0).any() for o in tout)
    np.testing.assert_allclose(np.stack(tout), np.stack(jout), rtol=1e-5,
                               atol=1e-6)


def test_placement_objectives_and_mis_masks():
    jG, jobj = jw.build_detailed_placement(3, 64)
    with jcore.Executor(num_workers=2) as ex:
        ex.run(jG).result(timeout=120)
    tG, tobj = tw.build_detailed_placement(3, 64)
    with tcore.Executor(num_workers=2, devices=[CPU]) as ex:
        ex.run(tG).result(timeout=120)
    assert len(tobj) == len(jobj) == 3
    np.testing.assert_allclose(tobj, jobj, rtol=1e-6, atol=0)
    jm = [np.asarray(n.state["result"]) for n in _kernels(jG)
          if n.name.startswith("mis[")]
    tm = [tcore.KernelTask(n).host_result() for n in _kernels(tG)
          if n.name.startswith("mis[")]
    assert len(tm) == len(jm) == 3
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a, b)


# -- the twins' main() -------------------------------------------------------
def _run_ref_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    return mod.main()


#: the fields of a report line that depend on the host's clock
_CLOCK = re.compile(r"in \d+\.\d+s( \(\d+(\.\d+)? (views|cells)/s\))?")


def _unclocked(text):
    return [_CLOCK.sub("in <t>", line) for line in text.splitlines()]


def test_quickstart_twin_dumps_the_reference_graph(capsys):
    g = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    ref_out = capsys.readouterr().out
    G, y = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert _canon_dump(G) == _canon_dump(g["G"])
    np.testing.assert_array_equal(y, g["y"])
    assert out.splitlines()[-1] == ref_out.splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--views", "3", "--workers", "2"],
    ["--views", "2", "--sweep", "--policy", "heft"],
    ["--views", "4", "--cells-per-view", "25", "--workers", "2"],
    ["--views", "2", "--repeat", "2", "--replace-every", "1",
     "--no-steal-locality"],
], ids=["views", "sweep_heft", "dag", "repeat_replace"])
def test_timing_analysis_twin_prints_the_reference_report(argv, capsys,
                                                          monkeypatch):
    _run_ref_main(_ref_example("timing_analysis"), argv, monkeypatch)
    ref = capsys.readouterr().out
    runs = timing_analysis.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _unclocked(out) == _unclocked(ref)
    assert len(runs) == len(ref.splitlines())


def test_timing_analysis_twin_profile_then_calibrate(tmp_path, capsys):
    trace = str(tmp_path / "t.json")
    argv = ["--views", "2", "--cells-per-view", "20", "--device", "cpu"]
    timing_analysis.main(argv + ["--profile", trace])
    assert re.search(r"trace: 80 records -> .*t\.json \(measured makespan "
                     r"\d+\.\dms\)", capsys.readouterr().out)
    runs = timing_analysis.main(argv + ["--calibrate", trace])
    assert "[calibrated]" in capsys.readouterr().out
    assert runs[0]["sim"].makespan > 0


@pytest.mark.parametrize("argv", [
    ["--iters", "3", "--cells", "64"],
    ["--iters", "2", "--cells", "32", "--policy", "round_robin",
     "--repeat", "2", "--replace-every", "1"],
], ids=["defaults", "round_robin_repeat"])
def test_detailed_placement_twin_prints_the_reference_report(argv, capsys,
                                                             monkeypatch):
    _run_ref_main(_ref_example("detailed_placement"), argv, monkeypatch)
    ref = capsys.readouterr().out
    run = detailed_placement.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert _unclocked(out) == _unclocked(ref)
    assert len(run["objective"]) == int(argv[1]) * (
        int(argv[argv.index("--repeat") + 1]) if "--repeat" in argv else 1)


@pytest.mark.parametrize("argv", [[], ["--bins", "2", "--scheduler",
                                       "balanced"]],
                         ids=["defaults", "two_bins_balanced"])
def test_serve_lm_twin_prints_the_reference_fields(argv, capsys):
    eng, done, _ = serve_lm.main(argv + ["--requests", "3", "--max-new", "3",
                                         "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(done) == 3 and all(r.done and len(r.generated) == 3
                                  for r in done)
    assert re.fullmatch(r"3 requests, 9 tokens in \d+\.\d\ds \(\d+\.\d "
                        r"tok/s\) over \d+ engine ticks", out[0])
    assert re.fullmatch(r"latency: ttft p50=\d+\.\dms p99=\d+\.\dms \| "
                        r"inter-token p50=\d+\.\dms p99=\d+\.\dms", out[1])
    bins = 2 if argv else 1
    assert re.fullmatch(rf"kv: bins={bins} utilization=\d\.\d\d "
                        r"fragmentation=\d\.\d\d grows=\d+ moves=\d+ "
                        r"preemptions=0", out[2])
    assert [line.split(":")[0] for line in out[3:]] == [
        f"  req {i}" for i in range(3)]
    assert eng.decode_graphs is None            # eager on the CPU


def test_small_lm_param_count_matches_the_reference():
    ref = _ref_example("train_lm")
    for d, n in ((320, 6), (768, 12)):
        assert train_lm.small_lm(d, n).param_count() \
            == ref.small_lm(d, n).param_count()
    assert 90e6 < train_lm.small_lm(768, 12).param_count() < 130e6


def test_train_lm_twin_trains_and_checkpoints(tmp_path, capsys, monkeypatch):
    """A few steps on one repeated batch (the schedule's warm-up moves
    the weights too little for the loss of fresh random batches to fall
    within a few steps), a checkpoint every 2 steps."""
    class OneBatch(train_lm.SyntheticSource):
        def batch(self, step, batch, seq):
            return super().batch(0, batch, seq)

    monkeypatch.setattr(train_lm, "SyntheticSource", OneBatch)
    out = train_lm.main(["--steps", "4", "--batch", "2", "--seq", "16",
                         "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                         "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.startswith("model lm-320x6: 15.1M params, 4 steps, batch 2×16")
    assert re.search(r"done: 4 steps in \d+\.\ds; loss \d+\.\d{3} → "
                     r"\d+\.\d{3}; checkpoints at .* \(latest step 4\)", text)
    assert len(out["losses"]) == 4 and out["losses"][-1] < out["losses"][0]
    assert out["latest_step"] == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002",
                                                          "step_00000004"]


@pytest.mark.parametrize("twin", [quickstart, timing_analysis,
                                  detailed_placement, serve_lm, train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_twin_defaults_to_cuda_and_raises_without_a_card(twin, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        twin.main([])
