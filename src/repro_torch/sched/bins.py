"""Execution bins: the resources Algorithm-1 groups are placed onto.

Heteroflow's placement model assumes a bin is one GPU.  At multi-card
scale a "device" for a sharded kernel is the *mesh slice* it runs on —
so bins become first-class objects with a *kind*, a stable
label, and a **capability set**, mirroring StarPU's per-architecture
codelet eligibility (a codelet declaring a CUDA implementation only runs
on CUDA workers) and Specx's heterogeneous task placement:

* :class:`DeviceBin` — one physical device (the legacy behavior; plain
  ``torch.device``/string bin objects keep working unwrapped and are
  treated as device bins everywhere).
* :class:`HostBin`   — host-resident execution: pulls keep their span on
  the host, kernels run without a device scope.
* :class:`MeshBin`   — a named sub-mesh slice (axis-name → size shape),
  enumerated from a ``torch.distributed.device_mesh.DeviceMesh`` via
  :meth:`MeshBin.from_mesh` or built synthetically for simulator-only
  studies.  Carries the placements pulls need (``put_target`` → the
  slice's mesh and DTensor placements, replicating over the slice by
  default) and a ``device_count`` the policies and simulator use to
  cost sharded compute.
* :class:`StageBin`  — a **pipeline-stage slot**: wraps any member bin
  (device / host / mesh slice) and adds the inter-stage *link* the
  Pipeflow model costs explicitly (bandwidth + latency of the
  activation path into this stage), instead of assuming adjacent
  stages are pinned next to each other.  Execution delegates to the
  member (:func:`execution_target`); scheduling sees the stage as one
  first-class bin whose transfers in/out are charged over its link
  (``CostModel.transfer_time`` consults :func:`stage_link`).

Capability tags close the loop: ``Heteroflow.kernel(...,
requires={"mesh"})`` marks a kernel (and, through affinity grouping,
its whole group) as eligible only on bins whose
:func:`bin_capabilities` superset the tag set — a sharded pjit kernel
tagged ``{"mesh"}`` can never be placed on a single-device bin, exactly
the way StarPU refuses to dispatch a CUDA-only codelet to a CPU worker.
Untagged groups (the default) remain eligible everywhere.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from repro_torch.core.graph import Node, TaskType
# stage-delegation semantics live in ONE place — core.streams — shared
# by the executor's dispatch, the device scopes, and the views below
from repro_torch.core.streams import execution_target

__all__ = [
    "ExecutionBin", "DeviceBin", "HostBin", "MeshBin", "StageBin",
    "stage_bins", "stage_link", "execution_target",
    "bin_kind", "bin_capabilities", "bin_lane_width", "bin_compute_scale",
    "bin_memory_bytes",
    "eligible_bins", "node_requires", "mesh_wide",
    "describe_bin", "bin_from_descriptor", "bins_from_trace",
]


class ExecutionBin:
    """Base class for first-class bins.

    Subclasses define ``kind`` (``"device"`` / ``"host"`` / ``"mesh"``),
    a run-stable ``label`` (consumed by ``core.streams.device_key``, so
    traces and ``Executor.stats()`` key on it), a ``capabilities``
    frozenset, and ``device_count`` (lane pairs the simulator gives the
    bin; compute scale for mesh-sharded kernels).

    Bins compare by VALUE (kind + label + shape), like the string bins
    the simulator sweeps use — a placement built against one
    ``MeshBin("m", {...})`` resolves against an equal reconstruction
    (e.g. ``bins_from_trace``).  Two equal bins in one bin list are two
    scheduling slots, exactly like duplicate devices (``bin_labels``
    disambiguates their labels positionally; index-keyed loads keep
    them apart).
    """

    kind: str = "device"
    label: str = ""
    capabilities: frozenset[str] = frozenset({"device"})
    device_count: int = 1
    #: optional byte budget (StarPU memory-node capacity): the resident
    #: footprint the scheduler/simulator may charge against this bin.
    #: ``None`` (the default everywhere) means *unlimited* — every
    #: pre-budget placement and simulation reproduces bit-for-bit.
    memory_bytes: int | None = None

    def _set_memory_bytes(self, memory_bytes: int | None) -> None:
        if memory_bytes is not None:
            memory_bytes = int(memory_bytes)
            if memory_bytes <= 0:
                raise ValueError(
                    f"memory_bytes must be positive or None (= unlimited), "
                    f"got {memory_bytes!r}")
        self.memory_bytes = memory_bytes

    def _eq_key(self) -> tuple:
        return (type(self), self.kind, self.label)

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, ExecutionBin)
                and self._eq_key() == other._eq_key())

    def __hash__(self) -> int:
        return hash(self._eq_key())

    def put_target(self) -> Any:
        """``torch.device`` a pull's span is copied onto; ``None`` means
        the bin has no device to copy onto."""
        return None

    def describe(self) -> dict[str, Any]:
        """JSON-serializable descriptor (trace v3 ``meta.bin_descriptors``;
        v5 adds ``memory_bytes`` when a budget is set)."""
        d = {"kind": self.kind, "label": self.label,
             "capabilities": sorted(self.capabilities),
             "device_count": self.device_count}
        if self.memory_bytes is not None:
            d["memory_bytes"] = self.memory_bytes
        return d

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.label!r}>"


class DeviceBin(ExecutionBin):
    """One physical device — the legacy bin, wrapped.

    ``device`` may be a ``torch.device`` or any placement target the
    executor already understands (string label for simulation-only use).
    """

    kind = "device"

    def __init__(self, device: Any, *, label: str | None = None,
                 memory_bytes: int | None = None):
        self.device = device
        from repro_torch.core.streams import device_key
        self.label = label or device_key(device)
        platform = (device.type if isinstance(device, torch.device)
                    else None)
        caps = {"device"}
        if platform:
            caps.add(platform)
        self.capabilities = frozenset(caps)
        self._set_memory_bytes(memory_bytes)

    def put_target(self) -> Any:
        return self.device if isinstance(self.device, torch.device) else None

    def describe(self) -> dict[str, Any]:
        return {**super().describe(), "kind": "device"}


class HostBin(ExecutionBin):
    """Host-resident execution: no H2D transfer, no device scope."""

    kind = "host"

    def __init__(self, *, label: str = "host",
                 memory_bytes: int | None = None):
        self.label = label
        self.capabilities = frozenset({"host"})
        self._set_memory_bytes(memory_bytes)

    def put_target(self) -> Any:
        return None


class MeshBin(ExecutionBin):
    """A named sub-mesh slice: ``axis_shape`` maps axis names to sizes.

    ``mesh`` is the live ``DeviceMesh`` over the slice's ranks when the
    bin is executable; ``None`` marks a *synthetic* bin usable by
    policies and the simulator only (handing one to the executor raises
    at invoke time rather than silently running unsharded).  ``spec`` is
    the default partition spec (``repro_torch.distributed.sharding.P``)
    a pull without an explicit ``sharding=`` pin is transferred under
    (default: replicate over the slice): a pull lands as a ``DTensor`` of
    those placements, and the bin's kernels run on this rank's device of
    the slice (``device``) inside the slice's scope
    (``core.streams.ScopedDeviceContext``).  Capabilities are ``{"mesh"}``
    plus the mesh's device type when built over a live mesh; synthetic
    bins take extra tags via ``capabilities=`` (e.g. ``("cuda",)`` to
    satisfy platform-qualified kernels in offline studies).
    """

    kind = "mesh"

    def __init__(self, name: str, axis_shape: Mapping[str, int], *,
                 mesh: Any = None, spec: Any = None,
                 capabilities: Sequence[str] = (),
                 memory_bytes: int | None = None):
        if not axis_shape:
            raise ValueError("MeshBin needs a non-empty axis_shape")
        self.label = name
        self.axis_shape = dict(axis_shape)
        self.mesh = mesh
        self.spec = spec
        self.device = None
        self.device_count = 1
        for n in self.axis_shape.values():
            self.device_count *= int(n)
        caps = {"mesh", *capabilities}
        if mesh is not None:
            caps.add(mesh.device_type)
            self.device = (torch.device("cuda", torch.cuda.current_device())
                           if mesh.device_type == "cuda"
                           else torch.device(mesh.device_type))
        self.capabilities = frozenset(caps)
        # the budget is the SLICE aggregate (sum over member devices) —
        # the resident set a replicated pull occupies on every member is
        # the caller's to model via the footprint it charges
        self._set_memory_bytes(memory_bytes)

    def _eq_key(self) -> tuple:
        return (type(self), self.kind, self.label,
                tuple(sorted(self.axis_shape.items())))

    @classmethod
    def from_mesh(cls, mesh: Any, tile: Mapping[str, int] | None = None, *,
                  spec: Any = None, prefix: str = "mesh") -> list["MeshBin"]:
        """Enumerate non-overlapping sub-mesh slices of ``mesh`` (a
        ``DeviceMesh`` with named dims).

        ``tile`` maps axis names to slice sizes (axes omitted keep their
        full extent); every tile size must divide its axis.  Returns one
        executable :class:`MeshBin` per slice, in row-major slice order
        with run-stable labels ``{prefix}:{shape}[{i}]``.  A slice that is
        the whole mesh is ``mesh`` itself; a smaller one is a new
        ``DeviceMesh`` over its ranks (every rank must enumerate the same
        tiles, as process groups are made collectively).
        """
        from torch.distributed.device_mesh import DeviceMesh

        names = list(mesh.mesh_dim_names)
        sizes = dict(zip(names, tuple(mesh.mesh.shape)))
        tile = dict(tile or {})
        for ax, t in tile.items():
            if ax not in sizes:
                raise ValueError(f"mesh has no axis {ax!r} "
                                 f"(axes: {names})")
            if sizes[ax] % t:
                raise ValueError(
                    f"tile size {t} does not divide axis {ax!r} "
                    f"of size {sizes[ax]}")
        shape = {ax: tile.get(ax, sizes[ax]) for ax in names}
        import itertools as _it
        steps = [range(0, sizes[ax], shape[ax]) for ax in names]
        shape_str = "x".join(str(shape[ax]) for ax in names)
        out = []
        for i, origin in enumerate(_it.product(*steps)):
            sl = tuple(slice(o, o + shape[ax])
                       for o, ax in zip(origin, names))
            sub = mesh if shape == sizes else DeviceMesh(
                mesh.device_type, mesh.mesh[sl], mesh_dim_names=tuple(names))
            out.append(cls(f"{prefix}:{shape_str}[{i}]", shape,
                           mesh=sub, spec=spec))
        return out

    def put_target(self) -> Any:
        """``(mesh, placements)``: the slice and the DTensor placements of
        its ``spec`` (all ``Replicate`` by default)."""
        if self.mesh is None:
            # the capability gate makes placement LOOK enforced; running
            # a sharded kernel unsharded on one device instead would be
            # silently wrong — fail loudly at invoke time
            raise RuntimeError(
                f"MeshBin {self.label!r} is synthetic (no live mesh) — "
                f"usable by policies and the simulator only; enumerate "
                f"executable slices with MeshBin.from_mesh")
        from repro_torch.distributed.sharding import P, placements
        return self.mesh, placements(self.mesh, self.spec or P())

    def describe(self) -> dict[str, Any]:
        return {**super().describe(), "axis_shape": dict(self.axis_shape)}


class StageBin(ExecutionBin):
    """A pipeline-stage slot: a member bin plus its inter-stage link.

    ``member`` is the resource the stage actually executes on — a
    :class:`DeviceBin` / :class:`HostBin` / :class:`MeshBin`, a raw
    ``torch.device``, or a plain string label for simulator-only studies.
    The stage inherits the member's capabilities (plus ``"stage"``, the
    tag ``distributed.pipeline`` puts on its cell kernels) and its
    ``device_count``, so a stage backed by a mesh slice still gets the
    slice's lane pairs and sharded-compute scaling.

    ``link_bandwidth`` (bytes/s) and ``link_latency_s`` describe the
    **input link** of this stage — the path activations travel to reach
    it from wherever the previous stage landed (StarPU costs each
    codelet's data transfers explicitly; Pipeflow schedules stages
    inside the task-graph runtime rather than beside it).  ``None``
    falls back to the cost model's fitted ``stage_link_bandwidth`` /
    generic ``d2d_bandwidth`` and ``latency_s``.

    ``stage_id`` is advisory identity, NOT a pin: any policy may place
    any stage group on any stage bin — the scheduled-vs-pinned parity
    gate in ``benchmarks/sched_bench.py`` exists precisely because the
    free placement must not lose to the historical hand-pinning.
    """

    kind = "stage"

    def __init__(self, stage_id: int, member: Any, *,
                 link_bandwidth: float | None = None,
                 link_latency_s: float | None = None,
                 label: str | None = None,
                 memory_bytes: int | None = None):
        # only None means "fall back to the cost model" — a zero
        # bandwidth would silently model as full-speed d2d otherwise
        if link_bandwidth is not None and link_bandwidth <= 0:
            raise ValueError(
                f"StageBin link_bandwidth must be positive or None, "
                f"got {link_bandwidth!r}")
        if link_latency_s is not None and link_latency_s < 0:
            raise ValueError(
                f"StageBin link_latency_s must be >= 0 or None, "
                f"got {link_latency_s!r}")
        self.stage_id = int(stage_id)
        self.member = member
        self.link_bandwidth = link_bandwidth
        self.link_latency_s = link_latency_s
        if label is None:
            from repro_torch.core.streams import device_key
            label = f"stage{self.stage_id}:{device_key(member)}"
        self.label = label
        self.device_count = bin_lane_width(member)
        self.capabilities = frozenset({"stage"} | bin_capabilities(member))
        # a stage slot's capacity is its member's unless overridden (the
        # stage is a scheduling identity; the member owns the memory)
        self._set_memory_bytes(memory_bytes if memory_bytes is not None
                               else bin_memory_bytes(member))

    def _eq_key(self) -> tuple:
        return (type(self), self.kind, self.label, self.stage_id)

    def put_target(self) -> Any:
        m = self.member
        if isinstance(m, ExecutionBin):
            return m.put_target()
        return m if isinstance(m, torch.device) else None

    def describe(self) -> dict[str, Any]:
        return {**super().describe(),
                "stage_id": self.stage_id,
                "link_bandwidth": self.link_bandwidth,
                "link_latency_s": self.link_latency_s,
                "member": describe_bin(self.member)}


def stage_bins(members: Sequence[Any], *,
               link_bandwidth: float | None = None,
               link_latency_s: float | None = None) -> list[StageBin]:
    """Wrap a bin list into consecutive stage slots with uniform links —
    the one-liner turning a device list into a pipeline pool."""
    return [StageBin(i, m, link_bandwidth=link_bandwidth,
                     link_latency_s=link_latency_s)
            for i, m in enumerate(members)]




def stage_link(src_bin: Any, dst_bin: Any) -> tuple[float | None,
                                                    float | None] | None:
    """(bandwidth, latency) of the stage link a transfer crosses.

    The *destination* stage's input link governs the transfer (data
    flows into a stage over its own link); when only the source is a
    stage bin its link covers the egress.  ``None`` when neither
    endpoint is a stage — the caller charges generic d2d.  Either
    tuple element may itself be ``None`` (bin declared no explicit
    figure): the cost model substitutes its fitted/stage defaults.
    """
    for b in (dst_bin, src_bin):
        if getattr(b, "kind", None) == "stage":
            return (b.link_bandwidth, b.link_latency_s)
    return None


# ----------------------------------------------------------------------
# duck-typed views over arbitrary bin objects (legacy bins stay raw)
# ----------------------------------------------------------------------
def bin_kind(b: Any) -> str:
    """``"device"`` / ``"host"`` / ``"mesh"``; raw objects are devices."""
    return getattr(b, "kind", "device")


def bin_capabilities(b: Any) -> frozenset[str]:
    caps = getattr(b, "capabilities", None)
    if caps is not None:
        return frozenset(caps)
    if isinstance(b, torch.device):
        return frozenset({"device", b.type})
    return frozenset({"device"})


def bin_lane_width(b: Any) -> int:
    """Copy/compute lane *pairs* a bin owns: one per member device (a
    mesh slice runs one independent stream pair per chip; a device bin
    owns exactly one — the unchanged overlap model)."""
    return int(getattr(b, "device_count", 1))


def bin_compute_scale(b: Any) -> float:
    """Speedup a mesh-sharded kernel gets from occupying the whole
    slice: ideal linear scaling over member devices."""
    return float(getattr(b, "device_count", 1))


def bin_memory_bytes(b: Any) -> int | None:
    """Byte budget of a bin; ``None`` = unlimited (every raw/legacy bin,
    and every ExecutionBin constructed without ``memory_bytes=``) — the
    pre-budget behavior, so existing placements reproduce bit-for-bit."""
    m = getattr(b, "memory_bytes", None)
    return int(m) if m is not None else None


def eligible_bins(requires: frozenset[str], bins: Sequence[Any]) -> list[int]:
    """Bin indices whose capabilities satisfy ``requires`` (StarPU-style
    per-codelet eligibility; an empty tag set is eligible everywhere)."""
    if not requires:
        return list(range(len(bins)))
    return [i for i, b in enumerate(bins)
            if requires <= bin_capabilities(b)]


def node_requires(node: Node) -> frozenset[str]:
    """Capability tags a node carries: a kernel's own ``requires``; a
    pull inherits the union of the kernels it feeds (its transfers are
    sharded exactly when its consumer is)."""
    if node.type == TaskType.KERNEL:
        return frozenset(node.state.get("requires", ()))
    if node.type == TaskType.PULL:
        out: set[str] = set()
        for s in node.successors:
            if s.type == TaskType.KERNEL:
                out |= set(s.state.get("requires", ()))
        return frozenset(out)
    return frozenset()


def mesh_wide(node: Node, b: Any) -> bool:
    """True when ``node`` occupies ALL lane pairs of bin ``b``: a
    mesh-tagged (sharded) task on a mesh bin — directly or wrapped in a
    stage slot — spans every member device; everything else uses one
    lane pair."""
    return (bin_kind(execution_target(b)) == "mesh"
            and "mesh" in node_requires(node))


# ----------------------------------------------------------------------
# trace v3 descriptors
# ----------------------------------------------------------------------
def describe_bin(b: Any) -> dict[str, Any]:
    """Serializable descriptor for any bin object (trace v3; v5 carries
    ``memory_bytes`` for budgeted bins)."""
    if isinstance(b, ExecutionBin):
        return b.describe()
    from repro_torch.core.streams import device_key
    return {"kind": "device", "label": device_key(b),
            "capabilities": sorted(bin_capabilities(b)), "device_count": 1}


def bin_from_descriptor(desc: Mapping[str, Any]) -> ExecutionBin:
    """Reconstruct a bin from its trace descriptor.

    Mesh bins come back *synthetic* (no live ``Mesh``) — enough for the
    simulator's replay/cost model, which only needs kind, label, shape,
    capabilities, and (v5) the byte budget."""
    kind = desc.get("kind", "device")
    label = desc.get("label", "")
    mem = desc.get("memory_bytes")  # absent in v1-v4 → unlimited
    if kind == "stage":
        member = desc.get("member")
        b = StageBin(int(desc.get("stage_id", 0)),
                     bin_from_descriptor(member) if member
                     else DeviceBin(label, label=label),
                     link_bandwidth=desc.get("link_bandwidth"),
                     link_latency_s=desc.get("link_latency_s"),
                     label=label or None, memory_bytes=mem)
        b.device_count = int(desc.get("device_count", b.device_count))
        if desc.get("capabilities"):
            b.capabilities = frozenset(desc["capabilities"])
        return b
    if kind == "host":
        return HostBin(label=label or "host", memory_bytes=mem)
    if kind == "mesh":
        b = MeshBin(label or "mesh", desc.get("axis_shape") or {"_": 1},
                    memory_bytes=mem)
        b.device_count = int(desc.get("device_count", b.device_count))
        if desc.get("capabilities"):
            b.capabilities = frozenset(desc["capabilities"])
        return b
    b = DeviceBin(label, label=label, memory_bytes=mem)
    if desc.get("capabilities"):
        b.capabilities = frozenset(desc["capabilities"])
    return b


def bins_from_trace(trace: Mapping[str, Any]) -> list[ExecutionBin]:
    """Bins recorded in a trace, reconstructed for replay.

    v3 traces carry full descriptors; v1/v2 traces only have
    ``meta.bins`` labels, which come back as label-only device bins."""
    meta = trace.get("meta", {})
    descs = meta.get("bin_descriptors")
    if descs:
        return [bin_from_descriptor(d) for d in descs]
    return [DeviceBin(label, label=label)
            for label in meta.get("bins", ())]
