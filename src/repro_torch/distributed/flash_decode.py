"""Flash-decoding over a sequence-sharded KV cache.

The port of ``repro.distributed.flash_decode``.  With the cache sharded
(B@batch, S@model, K, hd):

* each model rank owns rows [j·S_loc, (j+1)·S_loc) of the cache and
  updates the write position **locally** (one row, no replication);
* attention runs as a partial softmax per rank (local max / sum / acc),
  combined over the model axis's process group with one ``all_reduce``
  MAX and two SUMs of (B, K, G, ·) — flash-decoding's cross-device
  reduction, bytes ≈ B·H·hd·4 per step (KB-scale, vs the GB-scale
  cache).

The reference computes this in plain JAX, not in a Pallas kernel, and so
does the port in plain PyTorch.  The cache is read in its own dtype
with f32 accumulators: scores and the value sum are f32 products of the
widened rows.  The reference rounds the softmax weights to the cache's
dtype before the value sum, for the MXU's bf16 × bf16 → f32 product;
the port keeps them f32, as the decode kernel does (identical at an f32
cache).
"""
from __future__ import annotations

import math

import torch

from .context import manual_mode
from .sharding import P, as_like, local_block

_NEG = -1e30


def flash_decode_update(q, k_new, v_new, k_cache, v_cache, length, *,
                        mesh, baxes, maxis, scale: float | None = None):
    """One decode step against an S-sharded cache.

    q: (B, 1, H, hd); k_new/v_new: (B, 1, K, hd); k_cache/v_cache:
    (B, S, K, hd) laid out (batch, model, None, None); length: the write
    position (an int or a one-element int tensor, on the device: a
    captured step's ``pos``).  Each tensor is a global DTensor (taken to
    this rank's block, as the reference's shard_map in_specs) or this
    rank's block already (a plain tensor; at one rank, the whole value).
    ``mesh`` is a ``DeviceMesh`` with axes ``baxes`` and ``maxis``.

    The caches' blocks are updated IN PLACE (the port's caches are; the
    reference returns new arrays).  Returns (out (B, 1, H, hd), k_cache,
    v_cache), each of the kind it came as."""
    import torch.distributed as dist

    bspec = baxes if baxes else None
    tok_spec = P(bspec, None, None, None)
    cache_spec = P(bspec, maxis, None, None)
    q_l = local_block(q, mesh, tok_spec)
    kn = local_block(k_new, mesh, tok_spec)
    vn = local_block(v_new, mesh, tok_spec)
    kc = local_block(k_cache, mesh, cache_spec)
    vc = local_block(v_cache, mesh, cache_spec)
    B, _, H, hd = q_l.shape
    S_loc, K = kc.shape[1], kc.shape[2]
    G = H // K
    scale_ = scale if scale is not None else 1.0 / math.sqrt(hd)
    j = mesh.get_local_rank(maxis)
    group = mesh.get_group(maxis)
    with manual_mode():
        pos = torch.as_tensor(length, device=kc.device).reshape(())
        slot = pos - j * S_loc
        in_range = (slot >= 0) & (slot < S_loc)
        slot_c = slot.clamp(0, S_loc - 1).reshape(1)
        # one-row local update: read the row, blend, write back
        for cache_t, new in ((kc, kn), (vc, vn)):
            row = cache_t.index_select(1, slot_c)
            cache_t.index_copy_(1, slot_c, torch.where(
                in_range, new.to(cache_t.dtype), row))

        # partial softmax over the local rows
        qh = q_l[:, 0].reshape(B, K, G, hd).float()
        s = torch.einsum("bkgd,bskd->bkgs", qh, kc.float()) * scale_
        kpos = j * S_loc + torch.arange(S_loc, device=kc.device)
        s = s + _NEG * (kpos > pos).float()[None, None, None]
        m_loc = s.amax(dim=-1)
        p = torch.exp(s - m_loc[..., None])
        l_loc = p.sum(dim=-1)
        acc = torch.einsum("bkgs,bskd->bkgd", p, vc.float())

        # flash-decoding combine across the model axis
        m_g = m_loc.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m_loc - m_g)
        l_g = l_loc * corr
        dist.all_reduce(l_g, group=group)
        acc_g = acc * corr[..., None]
        dist.all_reduce(acc_g, group=group)
        out = acc_g / torch.clamp(l_g, min=1e-30)[..., None]
        out = out.reshape(B, 1, H, hd).to(q_l.dtype)
    return as_like(out, q, mesh, tok_spec), k_cache, v_cache
