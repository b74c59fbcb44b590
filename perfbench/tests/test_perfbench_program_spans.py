"""The readers of the program's own spans (``perfbench/program_spans.py``)
on hand-made span lists: each reading's value, the settled untraced part
of a closed and of an open loop, None on a ring that dropped entries; a
program span nesting inside a harness span on the same clock; the
benchmark building its engine and executor with no recorder; the span
probe on tiny cells on the CPU; and one card test, a short traced decode
run whose device intervals lie inside their host spans on the device
trace's clock."""
import time

import numpy as np
import pytest
import torch

from perfbench import harness, program, program_spans as ps
from perfbench.probe_spans import Probe
from perfbench.tests.test_perfbench_run import tiny
from perfbench.trace import Spans, Trace

MS = 1_000_000      # ns
#: the harness's own span names (``perfbench/trace.py``), which no
#: program span may take: the existing readers select spans by them
HARNESS_NAMES = {"tick", "prefill", "decode", "client", "wait_arrival",
                 "train_step"}


def span(sid, name, a, b, parent=None, **attrs):
    s = {"ph": "X" if name.startswith("device.") else "B", "span": sid,
         "name": name, "ts": a, "end_ts": b, **attrs}
    if parent is not None:
        s["parent"] = parent
    return s


def ticks_with_syncs():
    """Two executor tasks of 10 ms, 2 ms apart, each an engine tick of 9
    ms holding a decode step (its sync 4 ms) and a device interval of 5
    ms; a predicate of 0.5 ms between them."""
    out = []
    for k, t0 in enumerate((0, 12 * MS)):
        b = 10 * k
        out += [span(b + 1, "engine_tick", t0, t0 + 10 * MS, node=0,
                     worker=0),
                span(b + 2, "engine.tick", t0 + MS // 2, t0 + 9_500_000,
                     parent=b + 1),
                span(b + 3, "engine.decode", t0 + MS, t0 + 8 * MS,
                     parent=b + 2, request=k),
                span(b + 4, "engine.sync", t0 + 4 * MS, t0 + 8 * MS,
                     parent=b + 3, request=k),
                span(b + 5, "device.decode", t0 + 2 * MS, t0 + 7 * MS,
                     parent=b + 3, request=k)]
    out.append(span(30, "executor.predicate", 10_500_000, 11 * MS))
    return out


def rec(spans, start=0, end=22 * MS, dropped=0):
    return ps.Recorded(spans, dropped, start, end)


def test_pair_matches_begins_ends_and_keeps_intervals():
    entries = [{"ph": "B", "span": 1, "name": "a", "ts": 5},
               {"ph": "B", "span": 2, "name": "b", "ts": 6, "parent": 1},
               {"ph": "i", "name": "preempt", "ts": 7},
               {"ph": "E", "span": 2, "ts": 8},
               {"ph": "X", "span": 3, "name": "device.decode", "ts": 6,
                "end_ts": 7, "parent": 1},
               {"ph": "B", "span": 4, "name": "request.queue", "ts": 9,
                "request": 2}]
    got = {s["name"]: s for s in ps.pair(entries)}
    assert set(got) == {"a", "b", "device.decode", "request.queue"}
    assert got["a"]["end_ts"] is None and got["b"]["end_ts"] == 8
    assert got["b"]["parent"] == 1 and got["device.decode"]["end_ts"] == 7
    assert got["request.queue"]["end_ts"] is None


def test_the_readers_on_known_spans():
    r = rec(ticks_with_syncs())
    # union 10 ms of device time in a 22 ms part
    assert ps.device_idle_pct(r) == pytest.approx(100 * 12 / 22)
    # a 9 ms tick less its 4 ms sync
    assert ps.host_self_ms_per_tick(r) == pytest.approx(5.0)
    # 2 ms between the tasks less the 0.5 ms predicate
    assert ps.executor_gap_ms_per_tick(r) == pytest.approx(1.5)
    gaps = dict(ps.idle_gaps(r))
    # each gap goes whole to the innermost span open at its middle: 0-2
    # ms (middle 1: the decode step from 1), 7-14 (10.5: the predicate),
    # 19-22 (20.5: the second tick)
    assert gaps == {"engine.decode": pytest.approx(2e-3),
                    "executor.predicate": pytest.approx(7e-3),
                    "engine.tick": pytest.approx(3e-3)}
    assert ps.outside_parent_ms(r.spans) == 0
    # a part that holds only the second tick
    late = rec(ticks_with_syncs(), start=11 * MS)
    assert ps.host_self_ms_per_tick(late) == pytest.approx(5.0)
    assert ps.executor_gap_ms_per_tick(late) is None
    assert ps.device_idle_pct(late) == pytest.approx(100 * 6 / 11)


def test_queue_wait_takes_the_waits_that_end_in_the_part():
    waits = [span(i, "request.queue", 0, (i + 1) * MS, request=i)
             for i in range(20)]
    waits.append(span(99, "request.queue", 0, None, request=99))
    r = rec(waits, start=0, end=20 * MS)
    assert ps.queue_wait_p90_s(r) == pytest.approx(18e-3)
    assert ps.queue_wait_p90_s(rec(waits, start=10 * MS, end=20 * MS)) \
        == pytest.approx(19e-3)      # the 10 waits ending in (10, 20] ms
    assert ps.queue_wait_p90_s(rec(waits, start=30 * MS, end=40 * MS)) \
        is None


@pytest.mark.parametrize("reader", [ps.device_idle_pct,
                                    ps.host_self_ms_per_tick,
                                    ps.queue_wait_p90_s,
                                    ps.executor_gap_ms_per_tick,
                                    ps.idle_gaps])
def test_a_reader_reads_nothing_from_a_ring_that_dropped(reader):
    spans = ticks_with_syncs() + [span(50, "request.queue", 0, 5 * MS)]
    assert reader(rec(spans)) is not None
    assert reader(rec(spans, dropped=1)) is None
    assert reader(rec(spans, start=5 * MS, end=5 * MS)) is None
    assert reader(None) is None


def test_the_device_readers_read_nothing_without_intervals():
    host = [s for s in ticks_with_syncs()
            if not s["name"].startswith("device.")]
    assert ps.device_idle_pct(rec(host)) is None
    assert ps.idle_gaps(rec(host)) is None
    assert ps.outside_parent_ms(host) is None
    assert ps.host_self_ms_per_tick(rec(host)) == pytest.approx(5.0)


def test_the_settled_part_of_a_closed_and_of_an_open_loop():
    # ticks ending at 10, 20, ..., 60 ms, each followed by a predicate
    ticks = [span(i, "engine.tick", t - MS, t) for i, t in
             enumerate(range(10 * MS, 70 * MS, 10 * MS))]
    preds = [span(20 + i, "executor.predicate", t, t + MS) for i, t in
             enumerate(range(10 * MS, 70 * MS, 10 * MS))]
    # the predicate at 20 sends the backlog; the engine seats it by 40
    queue = [span(10, "request.queue", 21 * MS, 25 * MS),
             span(11, "request.queue", 21 * MS, 35 * MS),
             span(12, "request.queue", 51 * MS, 55 * MS)]
    spans = ticks + preds + queue
    assert ps.settled_part(spans, 12 * MS, 70 * MS, True) == (12 * MS,
                                                              70 * MS)
    # after a stop at 12: the first tick end (20) comes before the
    # backlog is sent; 30 holds one request waiting; 40 is settled
    assert ps.settled_part(spans, 12 * MS, 70 * MS, False) == (40 * MS,
                                                               70 * MS)
    # after a stop at 42: the predicate at 50 sends, 60 is settled
    assert ps.settled_part(spans, 42 * MS, 70 * MS, False)[0] == 60 * MS
    # a request never seated keeps the queue busy: an empty part
    stuck = spans + [span(13, "request.queue", 21 * MS, None)]
    start, end = ps.settled_part(stuck, 12 * MS, 70 * MS, False)
    assert start > end
    assert ps.host_self_ms_per_tick(rec(ticks, start, end)) is None
    # with no predicate spans (an engine run inline) the stop stands in:
    # the tick end at 20 comes before the requests begun at 21
    assert ps.settled_part(ticks + queue, 12 * MS, 70 * MS, False)[0] \
        == 20 * MS


def test_program_spans_lie_in_the_device_trace_beside_the_harness_spans():
    base = 1_000_000_000_000
    # a decode step: the harness's span inside the program's, which also
    # holds the argmax kernel; the program's device interval 1.0-1.12 ms
    prog = [span(1, "engine.decode", base + 900_000, base + 1_200_000,
                 request=4, pos=9),
            span(2, "device.decode", base + 1_000_000, base + 1_120_000,
                 parent=1, request=4)]
    harness_spans = [("decode", base + 950_000, base + 1_050_000,
                      {"pos": 9})]
    doc = {"baseTimeNanoseconds": base, "traceEvents": [
        {"cat": "kernel", "name": "gemv", "ts": 1010, "dur": 90,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "argmax", "ts": 1105, "dur": 10,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1130, "dur": 5,
         "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 1000,
         "dur": 1, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1100,
         "dur": 1, "args": {"correlation": 2}}]}
    t = Trace(doc, base + 800_000, base + 1_400_000,
              harness_spans + [(n, a, b, m) for n, a, b, m in
                               ps.as_trace_spans(prog)])
    (h,) = t.span_kernels("decode")
    (p,) = t.span_kernels("engine.decode")
    assert h.names == ["gemv"] and p.names == ["gemv", "argmax"]
    assert p.meta == {"request": 4, "pos": 9}
    got = ps.device_vs_trace(t, prog, base)
    assert got["intervals_s"] == pytest.approx(120e-6)
    assert got["busy_s"] == pytest.approx(105e-6)
    assert got["missed"] == [["Memcpy DtoH", pytest.approx(5e-6)]]


def test_a_recorder_span_nests_inside_a_harness_span():
    from repro_torch.obs import SpanRecorder
    r, spans = SpanRecorder(), Spans(True)
    for _ in range(20):
        with spans.span("tick"):
            with r.span("engine.tick"):
                pass
    prog = [s for s in r.spans()]
    for (_, a, b, _), s in zip(spans.items, prog):
        assert a <= s["ts"] <= s["end_ts"] <= b


def _engines(monkeypatch):
    made = []
    real = program.ServingEngine

    def engine(*a, **kw):
        made.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(program, "ServingEngine", engine)
    return made


def _run(workload, seconds=2.0):
    ctx = harness.Ctx(tiny(workload), 2**31 + 9, seconds, False,
                      torch.device("cpu"), time.monotonic(),
                      log=lambda *a: None)
    return harness.run_cell(ctx)


def test_the_benchmark_builds_its_engine_with_no_recorder(monkeypatch):
    made = _engines(monkeypatch)
    Probe(False).install(monkeypatch.setattr)
    assert _run("phi3.serve.decode", 1.0)["correct"] is True
    assert made and all(kw.get("obs") is None for kw in made)


@pytest.mark.parametrize("workload", ["phi3.serve.decode",
                                      "phi3.serve.prompt"])
def test_the_probe_reads_the_programs_spans_on_the_cpu(workload,
                                                       monkeypatch):
    made = _engines(monkeypatch)
    probe = Probe(True)
    probe.install(monkeypatch.setattr)
    assert _run(workload)["correct"] is True
    assert [kw["obs"] for kw in made] == [probe.rec]
    got = probe.readings(lambda *a: None)
    assert got["dropped"] == 0 and got["part_s"] > 0
    assert got["ticks_in_part"] > 0
    assert got["host_self_ms_per_tick"] > 0
    assert got["queue_wait_p90_s"] >= 0
    assert got["executor_gap_ms_per_tick"] > 0
    # no device number off the card
    assert got["device_idle_events"] is None and got["idle_gaps"] is None
    assert got["counters"] == {} and got["device_intervals"] == 0
    names = {s["name"] for s in ps.pair(probe.rec.entries())}
    assert not names & HARNESS_NAMES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine records device "
                    "intervals only there")


@pytest.mark.cuda
def test_device_intervals_lie_in_their_spans_on_the_trace_clock(
        card, monkeypatch):
    probe = Probe(True)
    probe.install(monkeypatch.setattr)
    cell = tiny("phi3.serve.decode", trace_seconds=1.0)
    ctx = harness.Ctx(cell, 2**31 + 9, 2.0, True, torch.device("cuda", 0),
                      time.monotonic(), log=lambda *a: None)
    assert harness.run_cell(ctx)["correct"] is True
    got = probe.readings(lambda *a: None)
    assert got["dropped"] == 0 and got["device_intervals"] > 0
    # every device interval inside the engine.decode / engine.prefill
    # span that launched it, on the recorder's clock
    assert got["outside_parent_ms"] <= 0.2
    assert 0 <= got["device_idle_events"] < 100
    assert got["counters"]["device_busy_s"] == pytest.approx(
        got["device_intervals_s"])
    assert got["counters"]["host_sync_s"] > 0
    # each harness decode span's kernels are found in one engine.decode
    # span, which adds only the greedy token's argmax
    k = got["kernels"]["decode"]
    assert k["matched"] > 0 and k["missing"] == 0
    assert all("argmax" in n.lower() for n in k["extra"]), k["extra"]
    traced = got["traced"]
    assert traced["intervals_s"] >= 0.9 * traced["busy_s"]
    spans = ps.pair(probe.rec.entries())
    by_id = {s["span"]: s for s in spans}
    for s in spans:
        if s["name"] == "device.decode":
            p = by_id[s["parent"]]
            assert p["name"] == "engine.decode"
            assert p["request"] == s["request"]
            assert np.int64(s["ts"]) >= p["ts"] - 200_000
            assert s["end_ts"] <= p["end_ts"] + 200_000
