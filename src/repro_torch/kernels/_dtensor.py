"""What a kernel wrapper does with a ``DTensor`` operand.

A hand-written kernel takes plain tensors.  On a mesh bin
(``repro_torch.sched.bins.MeshBin.from_mesh``) its operands may arrive
as DTensors: one that holds the whole value on this rank is unwrapped to
its local tensor; a sharded one raises, so no kernel ever runs one shard
as if it were the whole operand.
"""
from __future__ import annotations

from ..core.streams import is_dtensor

__all__ = ["local_operands"]


def local_operands(kernel: str, *tensors):
    """``tensors`` as the kernel reads them: a plain tensor as it is; a
    DTensor whose local tensor is the whole value (every placement
    ``Replicate``, or any placement on a mesh dim of size 1) as that
    local tensor.  A DTensor sharded (or partial) over a mesh dim of more
    than one rank raises ``ValueError``."""
    out = []
    for t in tensors:
        if is_dtensor(t):
            mesh = t.device_mesh
            for dim, p in enumerate(t.placements):
                if not p.is_replicate() and mesh.size(dim) > 1:
                    raise ValueError(
                        f"{kernel}: an operand is a DTensor placed "
                        f"{tuple(t.placements)} on {mesh}; the kernel takes "
                        f"whole tensors, not a shard")
            t = t.to_local()
        out.append(t)
    return out
