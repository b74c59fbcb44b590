"""The yardstick's arithmetic: the data-sheet peaks, the kernels' work
and the models' FLOPs.

Frozen copies, so that a change to the program cannot move its own
yardstick:

- ``seen_pairs``, ``flash_attention_cost``, ``flash_attention_bwd_cost``
  and ``decode_attention_cost``: the kernels' cost formulas of
  ``repro_torch/kernels/flash_attention/ops.py`` and
  ``repro_torch/kernels/decode_attention/ops.py``, taking shapes instead
  of tensors;
- ``mixer_flops`` and ``train_step_flops``: ``chip_smoke.py``'s
  ``_mixer_flops`` (its attention term) and ``_model_flops``;
- the peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
  700 W power limit).

A test holds each copy equal to the program's formula on sample shapes.
"""
from __future__ import annotations

import numpy as np

#: bf16 dense tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def seen_pairs(Sq: int, Sk: int, *, causal: bool = True,
               window: int | None = None, q_offset: int = 0) -> int:
    """The (query, key) pairs an attention call computes: query row i, at
    position p = q_offset + i, sees keys j <= p (causal) within the
    window."""
    p = np.arange(q_offset, q_offset + Sq, dtype=np.int64)
    hi = np.minimum(p + 1, Sk) if causal else np.full_like(p, Sk)
    lo = np.maximum(p - window + 1, 0) if window else np.zeros_like(p)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention_cost(B: int, Sq: int, Sk: int, H: int, K: int, D: int,
                         Dv: int, *, elem: int = BF16_BYTES,
                         q_offset: int = 0, window: int = 0,
                         with_lse: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of a forward call: q·Kᵀ over D and P·V over Dv for
    every seen pair, per query head; q, k, v read once, the output (and
    an f32 log-sum-exp) written once."""
    seen = seen_pairs(Sq, Sk, window=window or None, q_offset=q_offset)
    nbytes = elem * B * (Sq * H * (D + Dv) + Sk * K * (D + Dv))
    return 2 * B * H * (D + Dv) * seen, nbytes + (4 * B * H * Sq
                                                  if with_lse else 0)


def flash_attention_bwd_cost(B: int, S: int, H: int, K: int, D: int,
                             Dv: int, *, elem: int = BF16_BYTES,
                             window: int = 0) -> tuple[int, int]:
    """(FLOPs, bytes) of a backward call: the five products (S, dK, dQ
    over D; dP, dV over Dv) for every seen pair; q, k, v, out, dout and
    the log-sum-exp read once, dq, dk and dv written once."""
    seen = seen_pairs(S, S, window=window or None)
    nbytes = elem * B * (S * H * 2 * (D + Dv) + S * K * 2 * (D + Dv))
    return 2 * B * H * (3 * D + 2 * Dv) * seen, nbytes + 4 * B * H * S


def decode_attention_cost(B: int, S: int, H: int, K: int, D: int, Dv: int,
                          *, rows: int, elem: int = BF16_BYTES,
                          len_bytes: int = 4) -> tuple[int, int]:
    """(FLOPs, bytes) of a decode call: q·Kᵀ and p·V for each query head
    and each cache row read (``rows`` = Σ min(valid_len, S)), the rows
    read once, q read and the output written."""
    flops = 2 * rows * H * (D + Dv)
    nbytes = elem * (rows * K * (D + Dv) + B * H * (D + Dv)) + len_bytes * B
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip needs: the larger of the operations at the
    bf16 peak and the bytes at the HBM bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---------------------------------------------------------------------------
# model FLOPs of the dense decoder (a configuration file's numbers)
# ---------------------------------------------------------------------------
def layer_matmul_params(c: dict) -> int:
    """Matmul weights of one pre-norm block: q, k, v, o and the SwiGLU."""
    d, hd, H, K = c["d_model"], c["head_dim"], c["n_heads"], c["n_kv_heads"]
    return d * H * hd + 2 * d * K * hd + H * hd * d + 3 * d * c["d_ff"]


def param_count(c: dict) -> int:
    """Every parameter: embedding, head unless tied, the blocks' matmuls
    and norm scales, the final norm."""
    d, V = c["d_model"], c["vocab_size"]
    head = 0 if c["tie_embeddings"] else V * d
    return V * d + head + c["n_layers"] * (layer_matmul_params(c) + 2 * d) + d


def mixer_flops(c: dict, batch: int, seq: int) -> int:
    """A train step's attention products (QKᵀ and PV over the causal
    pairs), forward once and backward twice."""
    seen = seen_pairs(seq, seq)
    hd = c["head_dim"]
    return c["n_layers"] * 3 * 2 * batch * c["n_heads"] * (hd + hd) * seen


def train_step_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one train step: 6·N·T over the matmul parameters
    (every parameter but the embedding lookup, which counts where the
    head is tied to it) plus the attention products; recomputation not
    counted."""
    n_matmul = param_count(c) - (0 if c["tie_embeddings"]
                                 else c["vocab_size"] * c["d_model"])
    return 6 * n_matmul * batch * seq + mixer_flops(c, batch, seq)


def forward_token_flops(c: dict, position: int, *, head: bool) -> int:
    """Model FLOPs of one token's forward pass at ``position``: 2 per
    matmul weight of every block, the attention products over the
    ``position + 1`` keys it sees, and the head where the token's logits
    are computed (the last token of a chunk, every decoded token)."""
    hd = c["head_dim"]
    body = 2 * layer_matmul_params(c) \
        + 2 * c["n_heads"] * (hd + hd) * (position + 1)
    return c["n_layers"] * body + (2 * c["d_model"] * c["vocab_size"]
                                   if head else 0)


def prompt_flops(c: dict, length: int) -> int:
    """Model FLOPs of a prompt of ``length`` tokens: every token's blocks
    over the causal pairs, and the head once (the first generated
    token's logits), however many chunks the program runs it in."""
    hd = c["head_dim"]
    body = 2 * layer_matmul_params(c) * length \
        + 2 * c["n_heads"] * (hd + hd) * seen_pairs(length, length)
    return c["n_layers"] * body + 2 * c["d_model"] * c["vocab_size"]
