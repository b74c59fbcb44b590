"""Modality frontends: stubs, as in the reference
(``repro.models.frontends``).

The audio and vision configs describe the transformer backbone only; the
frontend hands it precomputed inputs:

* **musicgen-large**: the EnCodec encoder is stubbed; the backbone's
  inputs are the (already quantized) codebook ids themselves (vocab
  2048), and :func:`make_audio_tokens` draws a stream of them.
* **qwen2-vl-7b**: the vision tower is stubbed; :func:`make_patch_embeds`
  draws patch embeddings (B, n_visual_tokens, d_model) that the backbone
  takes as ``forward(extra_embeds=...)`` with M-RoPE positions.

Both draw from an explicit ``torch.Generator``; the numbers differ from
``jax.random``'s, the shapes, dtypes and scale are the reference's.
"""
from __future__ import annotations

import torch

__all__ = ["make_audio_tokens", "make_patch_embeds"]


def make_audio_tokens(gen: torch.Generator, batch: int, seq: int,
                      vocab: int = 2048, device=None) -> torch.Tensor:
    """Stub EnCodec token stream: (batch, seq) int32 ids below ``vocab``."""
    return torch.randint(0, vocab, (batch, seq), generator=gen,
                         dtype=torch.int32, device=device)


def make_patch_embeds(gen: torch.Generator, batch: int, n_tokens: int,
                      d_model: int, dtype=torch.bfloat16,
                      device=None) -> torch.Tensor:
    """Stub ViT patch embeddings, already projected into ``d_model``:
    (batch, n_tokens, d_model) normal draws times 0.02, in ``dtype``."""
    x = torch.randn((batch, n_tokens, d_model), generator=gen,
                    dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)
