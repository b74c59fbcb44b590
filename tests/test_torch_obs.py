"""The port's span recorder and the spans the serving engine and the
executor record with it, on the CPU: the recorder's clock (the clock of
``time.time_ns()``), parent links on one thread and none across threads,
intervals known after the fact, the count of entries the ring dropped,
the timeline export; a tiny served run's spans, one request id per
request, a preempted request queued again, and no device interval or
device counter off the card.  Imports neither JAX nor the JAX
package."""
import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import Executor  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    Histogram,
    MetricsRegistry,
    SpanRecorder,
    timeline_from_recorder,
    validate_timeline,
)
from repro_torch.serving import ServingEngine  # noqa: E402

CPU = torch.device("cpu")
PROMPTS = [np.arange(3 + 2 * i) * 7 % 256 for i in range(3)]
#: the benchmark harness's span names, which no program span may take
HARNESS_NAMES = {"tick", "prefill", "decode", "client", "wait_arrival",
                 "train_step"}


def test_stamps_lie_on_the_time_ns_clock():
    rec = SpanRecorder()
    for _ in range(50):
        a = time.time_ns()
        with rec.span("inner"):
            pass
        b = time.time_ns()
        s = rec.spans()[-1]
        assert a <= s["ts"] <= s["end_ts"] <= b
    assert isinstance(s["ts"], int)
    assert abs(rec.clock() - time.time_ns()) < 1_000_000


def test_parents_follow_one_threads_open_spans():
    rec = SpanRecorder()
    with rec.span("outer") as o:
        with rec.span("mid") as m:
            leaf = rec.begin("leaf", request=3)
            rec.end(leaf)
        rec.complete("interval", 10, 20, request=3)
    after = rec.begin("after")
    rec.end(after)
    by = {s["name"]: s for s in rec.spans()}
    assert "parent" not in by["outer"] and "parent" not in by["after"]
    assert by["mid"]["parent"] == o and by["leaf"]["parent"] == m
    assert by["interval"]["parent"] == o
    assert (by["interval"]["ts"], by["interval"]["end_ts"]) == (10, 20)
    assert by["leaf"]["request"] == 3


def test_no_parent_across_threads_and_a_detached_span_is_not_pushed():
    rec = SpanRecorder()
    with rec.span("main") as main:
        wait = rec.begin("request.queue", detached=True, request=7)
        with rec.span("child") as child:
            pass

        def other():
            with rec.span("elsewhere"):
                pass
            rec.end(wait)
        t = threading.Thread(target=other)
        t.start()
        t.join()
    by = {s["name"]: s for s in rec.spans()}
    assert by["child"]["parent"] == main and child != wait
    assert "parent" not in by["elsewhere"]
    assert "parent" not in by["request.queue"]
    assert by["request.queue"]["request"] == 7
    assert by["request.queue"]["end_ts"] >= by["elsewhere"]["end_ts"]


def test_an_end_pops_the_spans_a_raise_left_open_above_it():
    rec = SpanRecorder()
    outer = rec.begin("outer")
    rec.begin("left_open")
    rec.end(outer)
    s = rec.begin("next")
    rec.end(s)
    by = {x["name"]: x for x in rec.spans()}
    assert "left_open" not in by and "parent" not in by["next"]


def test_dropped_counts_what_fell_off_the_ring():
    rec = SpanRecorder(capacity=4)
    assert rec.dropped == 0
    for i in range(3):
        rec.event("e", i=i)
    assert rec.dropped == 0 and len(rec) == 3

    def more():
        for i in range(5):
            rec.event("f", i=i)
    t = threading.Thread(target=more)
    t.start()
    t.join()
    assert len(rec) == 4 and rec.dropped == 4
    assert [e["i"] for e in rec.entries()] == [1, 2, 3, 4]
    rec.clear()
    assert rec.dropped == 0 and len(rec) == 0
    rec.event("g")
    assert rec.dropped == 0


def test_the_timeline_renders_spans_intervals_and_instants():
    rec = SpanRecorder()
    with rec.span("engine.tick", bin="kv0"):
        now = rec.clock()
        rec.complete("device.decode", now, now + 2_000, request=1)
    rec.event("preempt", request=1)
    tl = timeline_from_recorder(rec)
    assert validate_timeline(tl) == []
    slices = {e["name"]: e for e in tl["traceEvents"] if e["ph"] == "X"}
    assert slices["device.decode"]["dur"] == 2.0
    assert slices["engine.tick"]["dur"] >= 2.0
    assert [e["name"] for e in tl["traceEvents"] if e["ph"] == "i"] \
        == ["preempt"]


def test_the_sampling_knobs_are_gone():
    for make in (lambda: SpanRecorder(sample_every=2),
                 lambda: Histogram("h", sample_every=2),
                 lambda: MetricsRegistry(sample_every=2),
                 lambda: MetricsRegistry().histogram("h", sample_every=2)):
        with pytest.raises(TypeError):
            make()
    h = MetricsRegistry().histogram("h")
    h.extend([3.0, 1.0, 2.0])
    assert h.count == 3 and h.percentile(50) == 2.0


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(get_config("phi3-mini-3.8b")),
                              compute_dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device=CPU)


def _served(model, executor=None, rec=None, preempt=False):
    cfg, params = model
    eng = ServingEngine(cfg, params, max_slots=2, max_seq=32,
                        executor=executor, obs=rec)
    ids = [eng.submit(p, max_new_tokens=4) for p in PROMPTS]
    if preempt:
        eng.step()
        eng.step()
        victim = eng._preempt_youngest()
        assert victim is not None
    done = {r.id: list(r.generated) for r in eng.run()}
    return eng, ids, done


def test_a_recorder_changes_no_token(model):
    _, _, plain = _served(model)
    _, _, recorded = _served(model, rec=SpanRecorder())
    assert recorded == plain


def test_the_engine_records_each_requests_path_in_its_ticks(model):
    rec = SpanRecorder()
    with Executor(num_workers=2, devices=[CPU], obs=rec) as ex:
        eng, ids, done = _served(model, executor=ex, rec=rec)
    spans = rec.spans()
    by_id = {s["span"]: s for s in spans}
    names = Counter(s["name"] for s in spans)
    assert not HARNESS_NAMES & set(names)
    assert not any(n.startswith("device.") for n in names)
    assert "device_busy_s" not in eng.metrics
    assert "host_sync_s" not in eng.metrics
    assert rec.dropped == 0

    def up(s, name):
        while s is not None and s["name"] != name:
            s = by_id.get(s.get("parent"))
        return s

    ticks = [s for s in spans if s["name"] == "engine.tick"]
    assert ticks and names["engine.admit"] == len(ticks)
    for t in ticks:            # each tick is a task of the executor
        assert by_id[t["parent"]]["name"] == "engine_tick"
    assert names["executor.predicate"] == names["engine_tick"]
    for rid in ids:
        mine = [s for s in spans if s.get("request") == rid]
        kinds = Counter(s["name"] for s in mine)
        assert kinds["request.queue"] == 1 and kinds["engine.prefill"] == 1
        # the prefill's token and three decode steps, each with its sync
        assert kinds["engine.decode"] == 3
        assert kinds["engine.sync"] == 4
        q = next(s for s in mine if s["name"] == "request.queue")
        pre = next(s for s in mine if s["name"] == "engine.prefill")
        assert "parent" not in q and "preempted" not in q
        assert q["ts"] <= q["end_ts"] <= pre["ts"] <= pre["end_ts"]
        assert up(pre, "engine.admit") is not None
        assert pre["length"] == len(PROMPTS[rid])
        for s in mine:
            if s["name"] == "engine.sync":
                assert by_id[s["parent"]]["name"] in ("engine.prefill",
                                                      "engine.decode")
                assert by_id[s["parent"]]["request"] == rid
            if s["name"] != "request.queue":
                t = up(s, "engine.tick")
                assert t["ts"] <= s["ts"] <= s["end_ts"] <= t["end_ts"]
        pos = sorted(s["pos"] for s in mine if s["name"] == "engine.decode")
        assert pos == [len(PROMPTS[rid]) + k for k in range(3)]
        assert len(done[rid]) == 4


def test_a_preempted_request_waits_in_the_queue_again(model):
    rec = SpanRecorder()
    eng, ids, done = _served(model, rec=rec, preempt=True)
    _, _, plain = _served(model)
    assert done == plain and eng.preemptions == 1
    queues = [s for s in rec.spans() if s["name"] == "request.queue"]
    again = [s for s in queues if s.get("preempted")]
    assert len(again) == 1 and len(queues) == len(ids) + 1
    rid = again[0]["request"]
    first = next(s for s in queues if s["request"] == rid
                 and not s.get("preempted"))
    assert first["end_ts"] < again[0]["ts"] <= again[0]["end_ts"]
    prefills = [s for s in rec.spans() if s["name"] == "engine.prefill"
                and s["request"] == rid]
    assert len(prefills) == 2
