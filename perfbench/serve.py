"""A serving cell: the engine under a closed or an open loop of clients.

Set-up draws the weights on the device from the seed, builds the engine
as ``repro_torch.launch.serve.serve`` does (its graphs are captured
there) and sends one warm-up request through the same loop.  Then each
engine tick is an iteration of ``Executor.run_until``, as in
``ServingEngine.run``, and the predicate between ticks is the clients':
it collects what finished, sends what is due, starts and ends the window
and the traced part of it, and ends the run.

- A closed loop (``clients``): every client sends at once before the
  window and sends its next request the moment its last one finished.
  The window starts at the end of the first tick and ends at the end of
  the first tick past ``seconds``; the run stops there.
- An open loop (``rate_per_s``): requests are sent at their due times
  (at the first tick end past them; the lateness is printed), every one
  due inside the window.  The run ends when every request has finished,
  or ``drain_s`` after the window.

The clients see a token at the end of the tick that produced it: the
harness stamps each request's new tokens there, from the growth of its
``generated`` list, and takes the tokens, the gaps between tokens and
the first-token times from those stamps, not from the engine's
histograms.

The comparison (:mod:`perfbench.check`) reads a sample of the served
requests with the plain reference once the engine is freed.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from . import check, costs, program, stats, traffic
from .trace import Profiler, Spans

KERNELS = ("flash_attention", "decode_attention")


class Clients:
    """The traffic's side of the loop (module docstring)."""

    def __init__(self, eng, config: dict, mix: dict, reqs: list,
                 seconds: float, spans, profiler, clock=time.monotonic):
        self.eng, self.config, self.mix, self.reqs = eng, config, mix, reqs
        self.seconds, self.spans, self.prof = seconds, spans, profiler
        self.clock = clock
        self.token_flops = costs.token_flops(config)
        self.closed = mix["kind"] == "closed_loop"
        self.sent: dict[int, dict] = {}     # engine id -> due, sent, index
        self.next_req = 0
        self.seen_done = len(eng.completed)      # the warm-up's
        self.in_flight = 0
        self.t0 = self.t1 = None
        self.c0 = self.c1 = None
        self.phase = "start"
        #: model FLOPs of every token served so far (each prompt once,
        #: each decoded token at its position): served[rid] = [the
        #: engine's live record, tokens counted] while in flight
        self.flops = 0
        self.served: dict[int, list] = {}
        #: stamps[rid]: when the clients saw each of its tokens
        self.stamps: dict[int, list[float]] = {}
        self.t_rest = self.c_rest = None
        #: the traced part of the window is over: the loop pauses once
        #: for the profiler to stop on its own thread
        self.pause = False

    # -- the engine's counters ------------------------------------------
    def counters(self) -> dict:
        pre = self.eng.prefill_graphs
        return {"flops": self.flops,
                "prefills": getattr(pre, "prefills", None),
                "replays": getattr(pre, "replays", None)}

    def send(self, i: int, due: float, now: float) -> None:
        r = self.reqs[i % len(self.reqs)]
        rid = self.eng.submit(r.prompt, max_new_tokens=r.max_new)
        self.sent[rid] = {"due": due, "sent": now, "index": i}
        self.served[rid] = [self.eng.poll(rid), 0]
        self.stamps[rid] = []
        self.in_flight += 1

    def start(self) -> None:
        """Before the first tick: the profiler starts, a closed loop's
        clients all send."""
        if self.prof is not None:
            self.prof.start()
        now = self.clock()
        if self.closed:
            for _ in range(self.mix["clients"]):
                self.send(self.next_req, now, now)
                self.next_req += 1
        else:
            self._open_window(now)

    def _open_window(self, now: float) -> None:
        self.t0, self.c0, self.phase = now, self.counters(), "window"
        if self.prof is not None:
            self.prof.mark_start()

    def _finished(self, now: float) -> list:
        self._observe(now)
        done = self.eng.completed[self.seen_done:]
        self.seen_done += len(done)
        self.in_flight -= len(done)
        for r in done:
            self.served.pop(r.id, None)
        return done

    def _observe(self, now: float) -> None:
        """Stamp every token that appeared since the last tick end and
        count its FLOPs.  A preempted request's dropped tokens lose their
        stamps; recomputed, they are stamped and counted again."""
        c = self.config
        for rid, rec in self.served.items():
            r, seen = rec
            L, n = len(r.prompt), len(r.generated)
            stamps = self.stamps[rid]
            del stamps[n:]
            for k in range(seen, n):
                self.flops += (costs.prompt_flops(c, L) if k == 0 else
                               self.token_flops(L + k - 1, head=True))
                stamps.append(now)
            rec[1] = n

    def mark_rest(self) -> None:
        """The untraced rest of the window starts (the profiler stopped)."""
        self.t_rest, self.c_rest = self.clock(), self.counters()

    def predicate(self) -> bool:
        with self.spans.span("client"):
            return self._predicate()

    def _predicate(self) -> bool:
        now = self.clock()
        done = self._finished(now)
        if self.phase == "start":                 # the first tick ended
            self._open_window(now)
        if (self.prof is not None and self.prof.running
                and now - self.t0 >= self.mix["trace_seconds"]
                and self.phase == "window"):
            self.pause = True
            return True
        if self.phase == "window":
            if not self.closed:
                self._send_due(now)
            elif now - self.t0 < self.seconds:
                for _ in done:                    # each client sends again
                    self.send(self.next_req, now, now)
                    self.next_req += 1
            now = self.clock()
            if now - self.t0 >= self.seconds:
                self.t1, self.c1 = now, self.counters()
                self.phase = "drain"
        if self.phase == "drain":
            return (self.closed or self.in_flight == 0
                    or now - self.t1 >= self.mix["drain_s"])
        return False

    def _send_due(self, now: float) -> None:
        """Send every request due by ``now``; with nothing in flight, wait
        for the next arrival and send it."""
        reqs = self.reqs
        while True:
            while (self.next_req < len(reqs)
                   and self.t0 + reqs[self.next_req].due <= now):
                self.send(self.next_req, self.t0 + reqs[self.next_req].due,
                          now)
                self.next_req += 1
            if self.in_flight or self.next_req >= len(reqs):
                return
            wait = self.t0 + reqs[self.next_req].due - now
            with self.spans.span("wait_arrival"):
                time.sleep(max(wait, 0.0))
            now = self.clock()


def _loop(ex, eng, clients: Clients, spans) -> None:
    g = program.Heteroflow("serve_tick")
    g.kernel(spans.wrap("tick", eng.step), name="engine_tick")
    clients.start()
    while True:
        ex.run_until(g, clients.predicate).result()
        if clients.prof is not None and clients.prof.running:
            clients.prof.stop()
        if not clients.pause:
            return
        clients.pause = False
        clients.mark_rest()


def _warm_up(ex, eng, mix: dict, vocab: int, seed: int) -> None:
    """One request of ``warmup_prompt`` tokens through the loop."""
    rng = np.random.default_rng(traffic.sub_seed(seed, 7))
    eng.submit(rng.integers(0, vocab, mix["warmup_prompt"], dtype=np.int32),
               max_new_tokens=4)
    g = program.Heteroflow("warm_up")
    g.kernel(eng.step, name="engine_tick")
    before = len(eng.completed)
    ex.run_until(g, lambda: len(eng.completed) > before).result()


def run(ctx) -> dict:
    """Set up, measure and check one run of a serving cell."""
    cell, dev = ctx.cell, ctx.device
    c, mix = cell.config, dict(cell.traffic)
    if ctx.rate is not None:
        mix["rate_per_s"] = ctx.rate
    ref = cell.reference()
    marks = [("start", ctx.t_proc), ("imports", time.monotonic())]
    program.build_kernels(KERNELS, dev)
    marks.append(("kernels", time.monotonic()))
    params = ref.draw_params(
        c, ctx.seed, dev,
        matmul_dtype=getattr(torch, c["serve"]["weights_dtype"]))
    _sync(dev)
    marks.append(("weights", time.monotonic()))
    cfg = program.model_config(c)
    spans = Spans(ctx.trace)
    prof = Profiler(torch, dev, spans) if ctx.trace else None
    closed = mix["kind"] == "closed_loop"
    reqs = (traffic.closed_pool(mix, ctx.seed, c["vocab_size"]) if closed
            else traffic.open_loop(mix, ctx.seconds, ctx.seed,
                                   c["vocab_size"]))
    with program.Executor(num_workers=2, devices=[dev]) as ex:
        eng = program.engine(c, cfg, params, ex, dev)
        if spans.on and eng.decode_graphs is not None:
            pre = eng.prefill_graphs
            eng.decode_graphs.step = spans.wrap(
                "decode", eng.decode_graphs.step,
                lambda slot, tok, pos: {"pos": pos})
            pre.prefill = spans.wrap(
                "prefill", pre.prefill,
                lambda slot, prompt: {"length": len(prompt),
                                      "chunks": pre.plan(len(prompt))})
        marks.append(("engine and graphs", time.monotonic()))
        _warm_up(ex, eng, mix, c["vocab_size"], ctx.seed)
        _sync(dev)
        marks.append(("warm-up request", time.monotonic()))
        clients = Clients(eng, c, mix, reqs, ctx.seconds, spans, prof)
        _loop(ex, eng, clients, spans)
        _sync(dev)
        end = time.monotonic()
    marks.append(("traffic start to window", clients.t0))
    ctx.log("set-up s: " + ", ".join(
        f"{n} {b - a:.4f}" for (_, a), (n, b) in zip(marks, marks[1:])))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    trace = prof.read() if prof is not None else None
    out = _results(ctx, eng, clients, mix, end)
    out.update(memory_peak=peak, trace=trace)
    served = _served(eng, clients)
    sample = traffic.check_sample(
        [(rid, len(p), len(g)) for rid, (p, g) in served.items()],
        ctx.seed, **mix["check"])
    seqs = [served[rid] for rid, _, _ in sample]
    del eng, clients, ex
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"], out["readings"] = check.served(
        ref, c, params, seqs, cell.limits, control=ctx.control)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _served(eng, clients: Clients) -> dict:
    """Every traffic request with a served token: id -> (prompt, tokens)."""
    out = {}
    for rid in clients.sent:
        r = eng.poll(rid)
        if r is not None and r.generated:
            out[rid] = (np.asarray(r.prompt).copy(), list(r.generated))
    return out


def _results(ctx, eng, clients: Clients, mix: dict, end: float) -> dict:
    c0, c1 = clients.c0, clients.c1
    t0, t1 = clients.t0, clients.t1
    window = t1 - t0
    stamps = clients.stamps
    # a token is the window's where the clients saw it in (t0, t1]; a
    # gap is the window's where its later token is
    tokens = sum(t0 < t <= t1 for st in stamps.values() for t in st)
    itl = [b - a for st in stamps.values() for a, b in zip(st, st[1:])
           if t0 < b <= t1]
    e2e = {"setup_s": t0 - ctx.t_proc,
           "ttft_p50_s": None,
           "itl_p95_s": stats.percentile(itl, 95),
           "serve_tokens_per_s": stats.rate(tokens, window)}
    done = {r.id for r in eng.completed if r.id in clients.sent}
    if clients.closed:
        failed = sum(1 for rid in done if not stamps[rid])
    else:
        # every request is due in the window; one with no token by the
        # drain's end counts as infinitely late
        ttft = [stamps[rid][0] - s["due"] if stamps[rid] else math.inf
                for rid, s in clients.sent.items()]
        failed = sum(1 for t in ttft if math.isinf(t))
        e2e["ttft_p90_s"] = stats.percentile(ttft, 90)
        e2e["ttft_p50_s"] = stats.percentile(ttft, 50)
        ctx.log("ttft s at p50/75/80/85/90/95/99: " + " ".join(
            str(stats.percentile(ttft, q)) for q in (50, 75, 80, 85, 90, 95,
                                                     99)))
    ctx.log("itl s at p50/90/95/99: " + " ".join(
        str(stats.percentile(itl, q)) for q in (50, 90, 95, 99)))
    counters = {k: (c1[k] - c0[k]) if c1[k] is not None else None
                for k in ("prefills", "replays")}
    counters.update(window_s=window, tokens=tokens, itl_samples=len(itl))
    # the window's part after the traced one (all of it untraced)
    t_rest, c_rest = ((clients.t_rest, clients.c_rest)
                      if clients.t_rest is not None and
                      clients.t_rest < t1 else (t0, c0))
    counters.update(untraced_s=t1 - t_rest,
                    untraced_flops=c1["flops"] - c_rest["flops"])
    lateness = stats.lateness_p95([s["due"] for s in clients.sent.values()],
                                  [s["sent"] for s in clients.sent.values()])
    ctx.log(f"requests sent {len(clients.sent)}, completed {len(done)}, "
            f"failed {failed}, in flight at the end {clients.in_flight}; "
            f"window {window} s, drain {end - t1} s; generator "
            f"lateness p95 {lateness} s; tokens in the window {tokens}, "
            f"gaps {len(itl)}; " + ", ".join(f"{k} {v}" for k, v in
                                              e2e.items()))
    return {"e2e": e2e, "attempted": len(clients.sent), "failed": failed,
            "counters": counters}
