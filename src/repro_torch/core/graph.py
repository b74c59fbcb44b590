"""Heteroflow task-dependency graph (paper §III-A), adapted to PyTorch.

The paper's four task types map onto PyTorch as follows (DESIGN.md §2):

* ``host``   — a Python callable executed by a CPU worker thread.
* ``pull``   — a host→device transfer (a pinned copy on the bin's copy stream); *stateful*: the
  host source is captured by reference (list / np.ndarray / callable), so
  mutations made by preceding host tasks are visible at transfer time —
  this mirrors the paper's StatefulTuple span capture (Listing 4).
* ``push``   — a device→host transfer; takes a source :class:`PullTask`
  whose *device* buffer is copied back into the host target (Listing 6).
* ``kernel`` — device compute.  A callable on tensors whose
  arguments may include :class:`PullTask` handles; at invoke time the
  executor substitutes each handle with its device tensor, the analogue
  of the paper's ``PointerCaster`` (Listing 9).  Source pull tasks are
  gathered from the argument list (``gather_sources``, Listing 8 line 3)
  to drive device placement (Algorithm 1).

Dependencies are explicit only: ``precede`` / ``succeed`` (paper §III-A.5).
Task handles are lightweight wrappers over graph nodes; they may be empty
placeholders re-bound later (paper's placeholder tasks).
"""
from __future__ import annotations

import enum
import io
import itertools
import threading
from typing import Any, Callable, Sequence

import numpy as np

__all__ = [
    "TaskType",
    "Node",
    "Task",
    "HostTask",
    "PullTask",
    "PushTask",
    "KernelTask",
    "Heteroflow",
]


class TaskType(enum.Enum):
    HOST = "host"
    PULL = "pull"
    PUSH = "push"
    KERNEL = "kernel"
    PLACEHOLDER = "placeholder"


_node_ids = itertools.count()


class Node:
    """A graph node: work item + dependency bookkeeping.

    ``join_counter`` is the runtime fan-in count used by the executor; it is
    reset from ``num_dependents`` at the start of every topology iteration
    (the paper re-runs graphs via run_n / run_until).
    """

    __slots__ = (
        "id", "name", "type", "work", "successors", "dependents",
        "device", "group", "bin_key", "state", "join_counter", "topology",
    )

    def __init__(self, type_: TaskType, name: str | None = None):
        self.id = next(_node_ids)
        self.type = type_
        self.name = name or f"{type_.value}_{self.id}"
        self.work: Callable[..., Any] | None = None
        self.successors: list[Node] = []
        self.dependents: list[Node] = []
        self.device = None          # assigned by placement (Algorithm 1)
        self.group: int | None = None  # union-find root id after placement
        self.bin_key: str | None = None  # stable bin label (sched.apply_assignment)
        self.state: dict[str, Any] = {}  # runtime state (device buffers &c.)
        self.join_counter = 0
        self.topology = None

    @property
    def num_dependents(self) -> int:
        return len(self.dependents)

    def _link(self, other: "Node") -> None:
        if other is self:
            raise ValueError(f"self-dependency on task '{self.name}'")
        self.successors.append(other)
        other.dependents.append(self)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<Node {self.name} ({self.type.value})>"


class Task:
    """Lightweight task handle (paper §III-A.1).

    Wraps a node pointer; prevents user access to internal storage.  An
    empty handle is a *placeholder* and may be re-bound via the
    ``Heteroflow`` factory methods.
    """

    def __init__(self, node: Node | None = None):
        self._node = node

    # -- introspection -------------------------------------------------
    @property
    def empty(self) -> bool:
        return self._node is None

    def name(self, new_name: str | None = None):
        self._require()
        if new_name is None:
            return self._node.name
        self._node.name = new_name
        return self

    @property
    def num_successors(self) -> int:
        self._require()
        return len(self._node.successors)

    @property
    def num_dependents(self) -> int:
        self._require()
        return len(self._node.dependents)

    @property
    def type(self) -> TaskType:
        self._require()
        return self._node.type

    # -- dependency edges (paper §III-A.5) ------------------------------
    def precede(self, *tasks: "Task") -> "Task":
        """Force *this* task to run before every task in ``tasks``."""
        self._require()
        for t in tasks:
            t._require()
            self._node._link(t._node)
        return self

    def succeed(self, *tasks: "Task") -> "Task":
        """Force *this* task to run after every task in ``tasks``."""
        self._require()
        for t in tasks:
            t._require()
            t._node._link(self._node)
        return self

    def _require(self) -> None:
        if self._node is None:
            raise RuntimeError("operating on an empty (placeholder) task")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Task({'empty' if self.empty else self._node.name})"


class HostTask(Task):
    def rebind(self, callable_: Callable[[], Any]) -> "HostTask":
        """Swap the callable (stateful re-binding, paper placeholders)."""
        self._require()
        self._node.work = callable_
        return self


class PullTask(Task):
    """Handle to a host→device transfer; owns the device buffer after run."""

    def device_data(self):
        """The device array produced by the last execution (paper
        ``PullTask::device_data``)."""
        self._require()
        try:
            return self._node.state["device_data"]
        except KeyError:
            raise RuntimeError(
                f"pull task '{self._node.name}' has not executed yet"
            ) from None

    def rebind(self, source, size: int | None = None) -> "PullTask":
        self._require()
        self._node.state["source"] = source
        self._node.state["size"] = size
        return self


class PushTask(Task):
    pass


class KernelTask(Task):
    def device(self):
        self._require()
        return self._node.device

    def result(self):
        """The value returned by the kernel's last execution (the public
        accessor collect sinks and metrics hooks read — user code should
        never reach into ``_node.state``)."""
        self._require()
        try:
            return self._node.state["result"]
        except KeyError:
            raise RuntimeError(
                f"kernel '{self._node.name}' has not executed yet"
            ) from None

    def host_result(self):
        """:meth:`result` as host numpy, read once the device work that
        made it has finished (the ready event its bin recorded): a
        tensor is copied to the host (bf16 widened to f32, which numpy
        lacks), a DTensor gathered whole first; any other value goes
        through ``np.asarray``."""
        value = self.result()
        ready = self._node.state.get("ready")
        if ready is not None:
            ready.synchronize()
        return _to_numpy(value)


def _to_numpy(value) -> np.ndarray:
    import torch
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    if hasattr(value, "full_tensor"):            # a DTensor
        value = value.full_tensor()
    value = value.detach()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.cpu().numpy()


def map_tree(fn: Callable[[Any], Any], tree):
    """``fn`` applied to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _leaf_view(leaf):
    """One leaf of a tree source: a CPU tensor stays a tensor (bf16 has
    no numpy dtype), anything else becomes an array view."""
    import torch
    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            raise ValueError(f"a pull's source must be on the host; a leaf "
                             f"is on {leaf.device}")
        return leaf.detach()
    return np.asarray(leaf)


def _span_view(source, size=None):
    """Materialize a host source into a contiguous array view.

    The analogue of the paper's ``std::span`` construction: accepts a
    list, np.ndarray, CPU tensor, or a zero-arg callable returning one
    (fully late-bound state).  Mutations by preceding host tasks are seen
    because the *reference* is captured, not a copy.  A dict source is
    a tree (the reference's ``device_put`` takes a pytree: a stage's
    weights, a block's dict of leaves with lists nested in it): the same
    tree of leaf views (:func:`_leaf_view`); ``size`` does not apply.
    """
    if callable(source):
        source = source()
    if isinstance(source, dict):
        if size is not None:
            raise ValueError("a pull of a tree takes no size")
        return map_tree(_leaf_view, source)
    arr = np.asarray(source)
    if size is not None:
        arr = arr.reshape(-1)[:size]
    return arr


def span_nbytes(span) -> int:
    """Bytes of a :func:`_span_view` result: an array's, or a tree's
    leaves summed."""
    return sum(int(x.nbytes) if isinstance(x, np.ndarray)
               else x.numel() * x.element_size() for x in tree_leaves(span))


class Heteroflow:
    """A task-dependency-graph builder (the paper's ``hf::Heteroflow``)."""

    def __init__(self, name: str = "heteroflow"):
        self.name = name
        self._nodes: list[Node] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # task factories
    # ------------------------------------------------------------------
    def _add(self, type_: TaskType, name: str | None = None) -> Node:
        node = Node(type_, name)
        with self._lock:
            self._nodes.append(node)
        return node

    def host(self, callable_: Callable[[], Any], name: str | None = None) -> HostTask:
        """Create a host task running ``callable_`` on a CPU worker."""
        node = self._add(TaskType.HOST, name)
        node.work = callable_
        return HostTask(node)

    def placeholder(self, name: str | None = None) -> HostTask:
        """A node whose content is bound later (paper §III-A.1)."""
        node = self._add(TaskType.PLACEHOLDER, name)
        return HostTask(node)

    def pull(self, source, size: int | None = None, *,
             sharding=None, stage: int | None = None,
             name: str | None = None) -> PullTask:
        """Create a pull (H2D) task.

        ``source`` may be an array, a list, or a zero-arg callable
        producing one — evaluated lazily at run time (stateful capture).
        ``sharding`` optionally pins the transfer to a NamedSharding; when
        omitted, the scheduler's device placement decides (paper §III-A.2:
        "the exact GPU ... is decided by the scheduler at runtime").
        ``stage`` tags the pull with a pipeline-stage id (see
        :meth:`kernel`) so it joins that stage's placement group.
        """
        node = self._add(TaskType.PULL, name)
        node.state.update(source=source, size=size, sharding=sharding)
        if stage is not None:
            node.state["stage"] = int(stage)
        return PullTask(node)

    def push(self, source: PullTask, target, size: int | None = None, *,
             name: str | None = None) -> PushTask:
        """Create a push (D2H) task copying ``source``'s device data into
        ``target`` (an ndarray-like written in place, or a callable
        receiving the host copy)."""
        if not isinstance(source, PullTask):
            raise TypeError("push source must be a PullTask")
        source._require()
        node = self._add(TaskType.PUSH, name)
        node.state.update(src=source._node, target=target, size=size)
        return PushTask(node)

    def kernel(self, fn: Callable[..., Any], *args: Any,
               writes: Sequence[PullTask] = (), cost: float | None = None,
               requires: Sequence[str] = (), stage: int | None = None,
               activation_bytes: int | None = None,
               name: str | None = None) -> KernelTask:
        """Create a kernel task offloading ``fn(*args)`` to a device.

        Any :class:`PullTask` in ``args`` is (a) recorded as a *source*
        (paper ``gather_sources``) so Algorithm 1 co-places it with this
        kernel, and (b) substituted by its device array at invoke time.
        ``fn``'s return value is stored and, if the kernel is itself used
        as an argument to another kernel, forwarded (device-to-device
        dataflow without a host round-trip).

        ``writes`` is the functional adaptation of the paper's
        in-place GPU writes: the kernel's outputs re-bind the listed pull
        tasks' device buffers (in order), so downstream ``push`` tasks
        observe the update.  ``cost`` feeds Algorithm 1's balanced-load
        bin packing (default unit load).

        ``requires`` is a set of capability tags restricting placement
        (StarPU-style codelet eligibility, ``repro_torch.sched.bins``): e.g.
        ``requires={"mesh"}`` marks a sharded kernel that only a
        mesh-slice bin may run.  The scheduler enforces it for the whole
        affinity group; an empty set (default) is eligible everywhere.

        ``stage`` tags the kernel with a pipeline-stage id: every node
        sharing a stage id is unioned into ONE placement group
        (``repro_torch.sched.base.build_groups``), so any policy moves the
        stage atomically — the mechanism ``distributed.pipeline`` emits
        its cells with, replacing hand-pinned stage placement.  It is an
        identity, not a pin: the scheduler still chooses the bin.

        ``activation_bytes`` declares the kernel's peak *resident*
        working-set bytes beyond its operand spans (intermediate
        activations).  Memory-budgeted scheduling
        (``repro_torch.sched.bins`` ``memory_bytes``) charges it — together
        with the group's pull spans — against a candidate bin's byte
        budget; the default 0 keeps kernels footprint-free, the
        pre-budget behavior.
        """
        node = self._add(TaskType.KERNEL, name)
        sources = [a._node for a in args if isinstance(a, PullTask)]
        node.state.update(fn=fn, args=args, sources=sources, writes=tuple(writes))
        if cost is not None:
            node.state["cost"] = float(cost)
        if activation_bytes is not None:
            node.state["activation_bytes"] = int(activation_bytes)
        if requires:
            if isinstance(requires, str):       # requires="mesh" is one
                requires = (requires,)          # tag, not four letters
            node.state["requires"] = frozenset(requires)
        if stage is not None:
            node.state["stage"] = int(stage)
        return KernelTask(node)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def nodes(self) -> list[Node]:
        return self._nodes

    def empty(self) -> bool:
        return not self._nodes

    def acyclic(self) -> bool:
        order = self.topological_order()
        return order is not None

    def topological_order(self) -> list[Node] | None:
        """Kahn's algorithm; None if the graph has a cycle."""
        indeg = {n.id: len(n.dependents) for n in self._nodes}
        ready = [n for n in self._nodes if indeg[n.id] == 0]
        order: list[Node] = []
        while ready:
            n = ready.pop()
            order.append(n)
            for s in n.successors:
                indeg[s.id] -= 1
                if indeg[s.id] == 0:
                    ready.append(s)
        return order if len(order) == len(self._nodes) else None

    # ------------------------------------------------------------------
    # DOT visualization (paper §III-A.6)
    # ------------------------------------------------------------------
    _DOT_STYLE = {
        TaskType.HOST: "shape=ellipse",
        TaskType.PULL: "shape=box,style=filled,fillcolor=lightblue",
        TaskType.PUSH: "shape=box,style=filled,fillcolor=lightyellow",
        TaskType.KERNEL: "shape=box3d,style=filled,fillcolor=lightpink",
        TaskType.PLACEHOLDER: "shape=ellipse,style=dashed",
    }

    def dump(self, stream: io.TextIOBase | None = None) -> str:
        """Emit the graph in DOT format (usable with graphviz/viz.js)."""
        buf = io.StringIO()
        buf.write(f'digraph "{self.name}" {{\n')
        for n in self._nodes:
            buf.write(f'  n{n.id} [label="{n.name}",{self._DOT_STYLE[n.type]}];\n')
        for n in self._nodes:
            for s in n.successors:
                buf.write(f"  n{n.id} -> n{s.id};\n")
        buf.write("}\n")
        out = buf.getvalue()
        if stream is not None:
            stream.write(out)
        return out
