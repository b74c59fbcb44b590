"""Device meshes over ``torch.distributed``.

The port of ``repro.launch.mesh``.  ``make_smoke_mesh`` is a 1×1
``("data", "model")`` mesh over the caller's one device — the card by
default (NCCL), the CPU with gloo when asked — and brings up a one-rank
process group over an in-memory store when none is up (no network, no
address); a group already up is reused, so two calls in one process do
not clash.  ``make_production_mesh`` is the reference's 16×16 (or
2×16×16) layout and needs that many ranks, launched by the caller (e.g.
``torchrun``); it never falls back to a smaller mesh.
"""
from __future__ import annotations

import torch

__all__ = ["make_smoke_mesh", "make_production_mesh"]


def _ensure_group(device_type: str) -> None:
    """A one-rank process group for ``device_type`` over a ``HashStore``
    when no group is up; a group already up is left as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
               device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """16×16 (data, model) single pod or 2×16×16 (pod, data, model) for
    two pods, over the process group the caller launched; raises unless
    it has exactly that many ranks."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"the production mesh {shape} needs {need} "
                           f"ranks; this process group has {have}")
    return _make_mesh(shape, axes, device_type)


def make_smoke_mesh(device: str | torch.device | None = None):
    """1×1 (data, model) mesh over one device: ``cuda`` (default) or
    ``cpu``.  Needs a world of one rank."""
    import torch.distributed as dist

    device_type = torch.device(device or "cuda").type
    _ensure_group(device_type)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the smoke mesh is 1x1; this process group has "
                           f"{dist.get_world_size()} ranks")
    return _make_mesh((1, 1), ("data", "model"), device_type)
