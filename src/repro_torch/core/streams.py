"""Per-device dispatch lanes and RAII device scopes (paper §III-C).

The paper keeps a *per-worker CUDA stream* so memory ops and kernels from
different workers interleave on the GPU.  Here every CUDA bin owns a
:class:`DispatchLane` with two real ``torch.cuda.Stream``s — one for
copies (H2D pulls, D2H pushes), one for kernels — so that

* a transfer on one bin overlaps a kernel on the same bin (the paper's
  stream overlap, Heteroflow §IV),
* the executor can account for in-flight work per device (the paper's
  stream occupancy → our lane depth, used as a straggler signal), and
* ordering between a kernel and the pulls it reads is explicit: every
  recorded dispatch carries a ``torch.cuda.Event`` that the consumer's
  stream waits on (the paper's ``cudaStreamWaitEvent``).

On a CPU device the lanes are synchronous: work has finished when the
call returns, so a lane records no events and is always drained.

``ScopedDeviceContext`` mirrors the paper's RAII ``cudaSetDevice`` scope
with ``torch.cuda.device`` + ``torch.cuda.stream`` — both thread-local,
like the executor's worker threads.  A live mesh slice
(``MeshBin.from_mesh``) runs on its member device's lanes, and its scope
also enters the slice (the reference enters its ``Mesh``): DTensor
implicit replication, so the plain tensors a kernel makes (positions,
a hand-written kernel's output) act as replicated over the slice.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque
from typing import Any, Sequence

import torch

__all__ = ["DispatchLane", "ScopedDeviceContext", "LaneRegistry",
           "device_key", "bin_labels", "dedup_labels", "execution_target",
           "torch_device", "live_mesh", "is_dtensor", "lane_kind",
           "COPY_LANE", "COMPUTE_LANE",
           "HOST_LANE", "DEFAULT_LANE_DEPTH"]

#: Lane classes a device bin multiplexes, mirroring the paper's per-device
#: streams: one lane serializes memory ops (H2D pulls / D2H pushes), one
#: serializes kernel launches.  ``repro_torch.sched.simulator`` models
#: exactly these two lanes per bin.  Host tasks occupy no device lane; the
#: simulator and the timeline exporter file them under ``HOST_LANE``.
COPY_LANE = "copy"
COMPUTE_LANE = "compute"
HOST_LANE = "host"

#: Default number of concurrently-in-flight ops a bin admits.  With one
#: copy lane and one compute lane each serializing their own class, depth
#: 2 means a transfer may overlap a kernel (the paper's stream overlap,
#: Heteroflow §IV); depth 1 degenerates to fully serialized dispatch —
#: the conservative model the simulator used before lanes existed.
DEFAULT_LANE_DEPTH = 2


def lane_kind(task_type: Any) -> str:
    """Lane class a task type occupies on its bin: pulls/pushes ride the
    copy lane, kernels the compute lane, everything else (host tasks,
    placeholders) the host lane.  Accepts a ``TaskType`` enum or its
    string value — shared by the simulator's lane model and the
    ``repro_torch.obs`` timeline exporter so measured and simulated rows
    land on matching lanes."""
    v = getattr(task_type, "value", task_type)
    if v in ("pull", "push"):
        return COPY_LANE
    if v == "kernel":
        return COMPUTE_LANE
    return HOST_LANE


def device_key(device: Any) -> str:
    """Stable identifier of a *physical* device bin, usable across runs.

    ``torch.device`` → ``"cuda:N"`` / ``"cpu:0"``; strings pass through;
    execution bins (``repro_torch.sched.bins.ExecutionBin``, duck-typed by
    their ``kind``/``label`` attributes) carry their own run-stable label;
    anything else falls back to its repr.  Profiler traces and
    ``Executor.stats()['lane_depths']`` key on this instead of the
    enumeration index, so two runs over the same hardware agree on bin
    identities.
    """
    if isinstance(device, torch.device):
        if device.type == "cuda":
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            return f"cuda:{index}"
        return f"{device.type}:{device.index or 0}"
    if isinstance(device, str):
        return device
    label = getattr(device, "label", None)
    if label is not None and getattr(device, "kind", None) is not None:
        return str(label)
    return f"{type(device).__name__}:{device!r}"


def execution_target(b: Any) -> Any:
    """The bin ``b`` actually executes on: pipeline-stage slots
    (``repro_torch.sched.bins.StageBin``, duck-typed by ``kind ==
    "stage"``) delegate to their member, recursively.  The single
    definition of stage-delegation semantics — the executor's dispatch,
    the device scopes below, and ``repro_torch.sched.bins`` all resolve
    through here."""
    while getattr(b, "kind", None) == "stage":
        b = b.member
    return b


def torch_device(b: Any) -> torch.device | None:
    """The ``torch.device`` bin ``b`` runs on, or ``None`` for bins with
    none (host bins, simulation labels, synthetic mesh slices).  A live
    mesh slice runs on this rank's device of it."""
    b = execution_target(b)
    if getattr(b, "kind", None) in ("device", "mesh"):
        b = getattr(b, "device", b)
    return b if isinstance(b, torch.device) else None


def live_mesh(b: Any) -> Any:
    """The ``DeviceMesh`` of a live mesh-slice bin (stage slots resolved
    to their member), or ``None``."""
    b = execution_target(b)
    return getattr(b, "mesh", None) if getattr(b, "kind", None) == "mesh" \
        else None


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``DTensor`` — without importing
    ``torch.distributed.tensor`` (a second of import time) when nothing
    has: no DTensor exists before it is imported (a module another
    thread is still importing may not define the class yet)."""
    cls = getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                  None)
    return cls is not None and isinstance(x, cls)


class _MeshScope:
    """DTensor implicit replication while any live-mesh task runs.  The
    switch is process-wide in torch (one flag read by DTensor's
    dispatcher), so the scopes of concurrent worker threads are counted
    and the flag stays on until the last one exits.  It changes nothing
    for a plain-tensor op: only an op that mixes a DTensor with a plain
    tensor reads it."""

    _lock = threading.Lock()
    _depth = 0
    _ctx: Any = None

    def __enter__(self):
        with _MeshScope._lock:
            if _MeshScope._depth == 0:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                _MeshScope._ctx = implicit_replication()
                _MeshScope._ctx.__enter__()
            _MeshScope._depth += 1
        return self

    def __exit__(self, *exc):
        with _MeshScope._lock:
            _MeshScope._depth -= 1
            if _MeshScope._depth == 0:
                _MeshScope._ctx.__exit__(None, None, None)
                _MeshScope._ctx = None
        return False


def _is_cuda(device: torch.device | None) -> bool:
    return device is not None and device.type == "cuda"


def dedup_labels(keys: Sequence[str]) -> list[str]:
    """Disambiguate repeated keys with a positional ``#<slot>`` suffix,
    keeping unique keys untouched — stable for a fixed input order."""
    seen: dict[str, int] = {}
    for k in keys:
        seen[k] = seen.get(k, 0) + 1
    return [f"{k}#{i}" if seen[k] > 1 else k for i, k in enumerate(keys)]


def bin_labels(bins: Sequence[Any]) -> list[str]:
    """Stable label per *scheduling* bin slot.

    Normally ``device_key`` of each bin; duplicate physical devices in
    the bin list (e.g. ``[torch.device("cpu")] * 2``) get a ``#<slot>``
    suffix so every slot keeps a distinct, run-stable identity —
    required for locality-aware stealing and per-bin calibration to
    remain meaningful when bins outnumber devices.
    """
    return dedup_labels([device_key(b) for b in bins])


class DispatchLane:
    """FIFO accounting of asynchronously dispatched device work.

    A lane over a CUDA device owns its bin's ``copy_stream`` and
    ``compute_stream``; both start ordered after the work already queued
    on the device's default stream (weights and caches the caller made
    before the first task).  Over any other device both are ``None``.
    """

    def __init__(self, device: Any):
        self.device = device
        self.key = device_key(device)
        self.torch_device = torch_device(device)
        self.copy_stream = self.compute_stream = None
        if _is_cuda(self.torch_device):
            default = torch.cuda.default_stream(self.torch_device)
            self.copy_stream = torch.cuda.Stream(self.torch_device)
            self.compute_stream = torch.cuda.Stream(self.torch_device)
            self.copy_stream.wait_stream(default)
            self.compute_stream.wait_stream(default)
        self._lock = threading.Lock()
        self._inflight: deque = deque()
        self.dispatched = 0
        self.retired = 0
        self.max_depth = 0            # in-flight high-watermark
        self.first_dispatch_ts: float | None = None
        self.last_dispatch_ts: float | None = None
        self.last_retire_ts: float | None = None

    def record(self, token: Any, event: Any = None) -> Any:
        """Record a dispatched value (a tensor or a pytree of them).

        On a CUDA lane the entry carries ``event`` — or, when none is
        given, a new event recorded on the calling thread's current
        stream — marking when the value materializes; the event is
        returned so a consumer can wait on it.  CPU lanes record no
        event.  Timestamps use ``time.perf_counter`` — the same clock the
        profiler stamps task records with, so lane residency windows
        align with trace start/end times.
        """
        if event is None and self.compute_stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.torch_device))
        now = time.perf_counter()
        with self._lock:
            self._inflight.append((token, event))
            self.dispatched += 1
            self.max_depth = max(self.max_depth, len(self._inflight))
            if self.first_dispatch_ts is None:
                self.first_dispatch_ts = now
            self.last_dispatch_ts = now
        return event

    def depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self) -> None:
        """Block until everything recorded on this lane has materialized
        (the lane's ``cudaStreamSynchronize``)."""
        while True:
            with self._lock:
                if not self._inflight:
                    return
                _, event = self._inflight.popleft()
            if event is not None:
                event.synchronize()
            with self._lock:
                self.retired += 1
                self.last_retire_ts = time.perf_counter()

    def retire_ready(self) -> int:
        """Opportunistically pop entries that have already materialized."""
        n = 0
        while True:
            with self._lock:
                if not self._inflight:
                    return n
                entry = self._inflight[0]
            if _is_ready(entry[1]):
                with self._lock:
                    if self._inflight and self._inflight[0] is entry:
                        self._inflight.popleft()
                        self.retired += 1
                        self.last_retire_ts = time.perf_counter()
                        n += 1
            else:
                return n

    def stream_for(self, task_type: Any) -> Any:
        """The stream a task of ``task_type`` runs on (``None`` off CUDA)."""
        if lane_kind(task_type) == COPY_LANE:
            return self.copy_stream
        return self.compute_stream

    def wait_for(self, stream: Any) -> None:
        """Order this lane's streams after the work queued on ``stream``."""
        if self.compute_stream is not None:
            self.copy_stream.wait_stream(stream)
            self.compute_stream.wait_stream(stream)

    def join_into(self, stream: Any) -> None:
        """Order the work later queued on ``stream`` after this lane's."""
        if self.compute_stream is not None:
            stream.wait_stream(self.copy_stream)
            stream.wait_stream(self.compute_stream)

    def snapshot(self) -> dict[str, Any]:
        """Dispatch/retire counters + timestamps for profiler traces."""
        with self._lock:
            return {
                "key": self.key,
                "depth": len(self._inflight),
                "max_depth": self.max_depth,
                "dispatched": self.dispatched,
                "retired": self.retired,
                "first_dispatch_ts": self.first_dispatch_ts,
                "last_dispatch_ts": self.last_dispatch_ts,
                "last_retire_ts": self.last_retire_ts,
            }


def _is_ready(event: Any) -> bool:
    return event is None or event.query()


#: per-thread stack of active device-scope keys — fused batch dispatch
#: (``Executor(fuse_batch=N)``) wraps N tasks in ONE outer scope, and the
#: per-task handlers' inner scopes for the same target must become no-ops
#: or the batch pays N redundant context entries anyway
_scope_stack = threading.local()


class ScopedDeviceContext(contextlib.AbstractContextManager):
    """RAII-style device scope (paper Listing 13 line 3).

    Accepts raw ``torch.device``s and execution bins
    (``repro_torch.sched.bins``): a device bin unwraps to its
    ``torch.device``, a stage slot to its member, a live mesh slice to
    this rank's device of it (and enters the slice: :class:`_MeshScope`),
    and a host bin or a synthetic mesh slice deliberately runs
    scope-free.  On a CUDA device the scope makes the device current and,
    when ``stream`` is given, makes that stream current (the bin's copy
    or compute stream).

    Re-entrant per thread: entering a scope for the same resolved target
    and stream as the innermost active scope is a no-op (the outer scope
    already holds them) — what makes one fused-batch scope entry cover
    every member task's own ``with ScopedDeviceContext(...)``.
    """

    def __init__(self, device: Any, stream: Any = None):
        self.device = torch_device(device)
        self.mesh = live_mesh(device)
        self.stream = stream
        self._ctx: list = []

    def __enter__(self):
        stack = getattr(_scope_stack, "keys", None)
        if stack is None:
            stack = _scope_stack.keys = []
        key = (self.device, id(self.stream), id(self.mesh))
        if stack and stack[-1] == key:
            pass                             # same target: re-entry no-op
        else:
            if _is_cuda(self.device):
                self._ctx = [torch.cuda.device(self.device)]
                if self.stream is not None:
                    self._ctx.append(torch.cuda.stream(self.stream))
            if self.mesh is not None:
                self._ctx.append(_MeshScope())
            for ctx in self._ctx:
                ctx.__enter__()
        stack.append(key)
        return self

    def __exit__(self, *exc):
        _scope_stack.keys.pop()
        for ctx in reversed(self._ctx):
            ctx.__exit__(*exc)
        self._ctx = []
        return False


class LaneRegistry:
    """One lane per device bin, created on demand; thread-safe."""

    def __init__(self):
        self._lanes: dict[int, DispatchLane] = {}
        self._lock = threading.Lock()

    def lane(self, device: Any) -> DispatchLane:
        key = id(device)
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._lanes[key] = DispatchLane(device)
            return lane

    def lanes(self) -> list[DispatchLane]:
        with self._lock:
            return list(self._lanes.values())

    def drain_all(self) -> None:
        for lane in self.lanes():
            lane.drain()
