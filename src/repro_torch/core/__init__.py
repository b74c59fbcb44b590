"""repro_torch.core — Heteroflow-style heterogeneous task-graph runtime in PyTorch.

The paper's primary contribution (Huang & Lin, "Concurrent CPU-GPU Task
Programming using Modern C++"): a four-type task taxonomy (host / pull /
push / kernel), explicit-DAG graph language, a work-stealing executor with
union-find + bin-packing device placement, per-device dispatch lanes, and
buddy-allocator memory arenas.  See DESIGN.md for the mapping.
"""
from .graph import (
    Heteroflow,
    HostTask,
    KernelTask,
    Node,
    PullTask,
    PushTask,
    Task,
    TaskType,
)
from .executor import Executor, Topology
from .memory import BuddyAllocator, DeviceArena, OutOfMemory
from .placement import UnionFind, estimate_node_cost, place
from .streams import DispatchLane, LaneRegistry, ScopedDeviceContext

__all__ = [
    "Heteroflow", "HostTask", "KernelTask", "Node", "PullTask", "PushTask",
    "Task", "TaskType", "Executor", "Topology", "BuddyAllocator",
    "DeviceArena", "OutOfMemory", "UnionFind", "estimate_node_cost", "place",
    "DispatchLane", "LaneRegistry", "ScopedDeviceContext",
]
