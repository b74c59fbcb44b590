"""What a kernel wrapper does with a ``DTensor`` operand.

A hand-written kernel takes plain tensors.  On a mesh bin
(``repro_torch.sched.bins.MeshBin.from_mesh``, one rank) its operands may
arrive as DTensors that each hold the whole value: they are unwrapped to
their local tensors.  On a mesh of more ranks (a sharded model; the
dry-run's fake meshes) a DTensor is kept, and the wrapper calls the
kernel's custom op on it: DTensor's dispatch then applies the op's
sharding rule (:func:`register_rules`), which runs the kernel on each
rank's block over the dims the kernel is independent in and
redistributes any other layout first, so no kernel ever runs one shard
as if it were the whole operand.

Grouped-query attention with its kv heads replicated while the q heads
are sharded (fewer kv heads than ranks: llama4's 8 on a model axis of
16) is laid out by :func:`kv_for_q_heads`: each rank reads the kv head
its q heads map to globally (h → h // G).
"""
from __future__ import annotations

from typing import Callable

from ..core.streams import is_dtensor

__all__ = ["counting_mode", "kv_for_q_heads", "local_operands",
           "register_rules", "route", "sharding_rule"]

#: each custom op's sharding rule, registered with DTensor on first use
_RULES: dict = {}
_registered: set = set()


def local_operands(kernel: str, *tensors):
    """``tensors`` as the kernel's wrapper takes them: a plain tensor as it
    is; a DTensor on a mesh of one rank as its local tensor (the whole
    value); a DTensor on a mesh of more ranks as it is, for the custom
    op's sharding rule (the rules are registered with DTensor here)."""
    out = []
    for t in tensors:
        if is_dtensor(t):
            if t.device_mesh.size() == 1:
                t = t.to_local()
            else:
                register_rules()
        out.append(t)
    return out


def route(t) -> str:
    """Where a wrapper sends a call whose first operand is ``t``:
    ``"plain"`` for a real CPU tensor (the plain version); ``"op"`` for a
    fake or meta tensor, a DTensor, or any call under a Python dispatch
    mode (``FlopCounterMode``, a memory tracker, a tracer): the custom
    op, which they see through; ``"launch"`` for a real CUDA tensor in
    plain eager code: the launch function the custom op's CUDA
    implementation calls, without the dispatcher (16-44 µs of host time a
    call on the H100 machine; dispatched eager flash calls were also seen
    to break a later CUDA-graph capture there, PERF.md §6).  Selective
    checkpointing's own modes (remat ``"dots"``) count as plain eager
    code: they keep only the matmuls, so a kernel they do not see is
    recomputed, as they would have it, and a captured step under them
    launches directly too."""
    from torch._subclasses.fake_tensor import is_fake
    if is_dtensor(t) or is_fake(t) or t.device.type == "meta":
        return "op"
    if t.device.type == "cpu":
        return "plain"
    return "op" if counting_mode() else "launch"


def counting_mode() -> bool:
    """Whether a Python dispatch mode other than selective checkpointing's
    own is active: ``FlopCounterMode``, a memory tracker, a tracer."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    from torch.utils.checkpoint import (_CachedTorchDispatchMode,
                                        _CachingTorchDispatchMode)
    sac = (_CachedTorchDispatchMode, _CachingTorchDispatchMode)
    return any(not isinstance(m, sac)
               for m in _get_current_dispatch_mode_stack())


def sharding_rule(op) -> Callable:
    """Decorator: ``fn`` is ``op``'s DTensor sharding rule (the
    ``register_sharding`` form: it gets the op's arguments, tensors as
    their specs, and returns (output placements, input placements) per
    acceptable layout of one mesh dim).  Registered with DTensor by
    :func:`register_rules`, so importing a kernel module does not import
    ``torch.distributed.tensor``."""
    def wrap(fn):
        _RULES[op] = fn
        return fn
    return wrap


def register_rules() -> None:
    """Register every kernel's sharding rule with DTensor (once)."""
    from torch.distributed.tensor.experimental import register_sharding
    for op, fn in _RULES.items():
        if op not in _registered:
            register_sharding(op)(fn)
            _registered.add(op)


def kv_for_q_heads(q, k, v, q_dim: int, kv_dim: int):
    """``q``, ``k`` and ``v`` laid out for a kernel call in which ``q``'s
    heads (dim ``q_dim``) may be sharded over a mesh dim while the kv
    heads (dim ``kv_dim`` of k and v) are not.

    With K kv heads dividing the mesh dim's n ranks, the rule shards the
    kv heads with q's, and each rank's q heads [r·H/n, (r+1)·H/n) meet
    their kv heads [r·K/n, (r+1)·K/n).  With fewer (K % n != 0), each
    rank's H/n q heads fall in one group of G = H/K when H/n divides G:
    k and v are taken whole on that mesh dim and each rank keeps the one
    kv head (r·H/n) // G its q heads map to, as a DTensor sharded over a
    virtual kv-head dim of n (a view; the gradient of the whole k is the
    sum over the ranks).  Otherwise q's heads are gathered on that mesh
    dim, and the call runs whole there."""
    if not is_dtensor(q):
        return q, k, v
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    H, K = q.shape[q_dim], k.shape[kv_dim]
    for m, p in enumerate(q.placements):
        n = mesh.size(m)
        if p != Shard(q_dim) or n == 1 or K % n == 0:
            continue
        G, h_loc = H // K, H // n
        if H % n or G % h_loc:
            places = list(q.placements)
            places[m] = Replicate()
            q = q.redistribute(mesh, places)
            continue
        kv_head = mesh.get_local_rank(m) * h_loc // G
        laid = []
        for t in (k, v):
            if not is_dtensor(t):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            whole = list(t.placements)
            whole[m] = Replicate()
            t = t.redistribute(mesh, whole)
            grad = list(whole)
            grad[m] = Partial()
            local = t.to_local(grad_placements=grad).narrow(kv_dim, kv_head,
                                                            1)
            virtual = list(whole)
            virtual[m] = Shard(kv_dim)
            laid.append(DTensor.from_local(local, mesh, virtual,
                                           run_check=False))
        k, v = laid
    return q, k, v
