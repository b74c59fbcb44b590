"""The yardstick's arithmetic: the data-sheet peaks, the kernels' work
and the models' FLOPs.

Frozen copies, so that a change to the program cannot move its own
yardstick:

- ``seen_pairs``, ``flash_attention_cost``, ``flash_attention_bwd_cost``
  and ``decode_attention_cost``: the kernels' cost formulas of
  ``repro_torch/kernels/flash_attention/ops.py`` and
  ``repro_torch/kernels/decode_attention/ops.py``, taking shapes instead
  of tensors;
- ``param_count`` and its terms ``mixer_params`` and ``ffn_params``:
  ``ModelConfig.param_count`` and ``active_param_count`` of
  ``repro_torch/configs/base.py``, reading a configuration file's keys;
- ``mixer_flops`` and ``train_step_flops``: ``chip_smoke.py``'s
  ``_mixer_flops`` (its attention and MLA terms) and ``_model_flops``,
  over the parameters active per token;
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
# model FLOPs of a configuration file's layer stack
# ---------------------------------------------------------------------------
#: the mixers and feed-forwards the formulas below count, each by a term
#: of its own; a stack with any other kind is refused (:func:`check`)
MIXERS = ("attn", "mla")
FFNS = ("dense", "moe")
#: the keys of the file's ``mla`` and ``moe`` dicts the formulas read
MLA_KEYS = ("kv_lora_rank", "q_lora_rank", "qk_nope_dim", "qk_rope_dim",
            "v_head_dim")
MOE_KEYS = ("n_experts", "top_k", "n_shared", "d_ff_expert")


def layers(c: dict) -> list[dict]:
    """The file's ``layers``: groups of ``count`` super-blocks, each the
    sub-layers of ``pattern`` (mixers) with ``ffn`` (one feed-forward
    for all, or a list of one a mixer).  Where the file has none, one
    group of ``n_layers`` dense attention layers."""
    return c.get("layers") or [{"pattern": ["attn"], "count": c["n_layers"],
                                "ffn": "dense"}]


def groups(c: dict) -> list[tuple[tuple, int, tuple]]:
    """:func:`layers` as (mixers, count, feed-forwards), one feed-forward
    a mixer."""
    out = []
    for g in layers(c):
        mixers, ffn = tuple(g["pattern"]), g["ffn"]
        out.append((mixers, g["count"], tuple(ffn) if isinstance(ffn, list)
                    else (ffn,) * len(mixers)))
    return out


def check(c: dict) -> int:
    """The layers of the file's stack.  Raises, naming the group, for a
    stack the formulas cannot count: a kind no formula here counts, a
    key its formula reads that the file lacks, or a feed-forward list of
    another length than the mixers'."""
    for i, (g, (mixers, _, ffns)) in enumerate(zip(layers(c), groups(c))):
        if len(ffns) != len(mixers):
            raise ValueError(f"layer group {i} {g}: {len(ffns)} "
                             f"feed-forwards for {len(mixers)} mixers")
        unknown = [k for k in mixers if k not in MIXERS] + \
            [k for k in ffns if k not in FFNS]
        if unknown:
            raise ValueError(
                f"layer group {i} {g}: no formula in perfbench/costs.py "
                f"counts {unknown}; it counts the mixers {MIXERS} and the "
                f"feed-forwards {FFNS}")
        need = [("mla", k) for k in MLA_KEYS if "mla" in mixers] + \
            [("moe", k) for k in MOE_KEYS if "moe" in ffns]
        missing = [f"{d}.{k}" for d, k in need if k not in c.get(d, {})]
        if missing:
            raise ValueError(f"layer group {i} {g}: the file lacks "
                             f"{missing}, which its formulas read")
    return sum(len(mixers) * n for mixers, n, _ in groups(c))


def _uncounted(kind: str):
    return ValueError(f"no formula in perfbench/costs.py counts {kind!r}")


def mixer_params(c: dict, mixer: str) -> int:
    """Matmul weights of one ``mixer``: attention's q, k, v and o; MLA's
    latent down-projection with the shared rope key, the k and v
    up-projections, q (through ``q_lora_rank`` where it is not 0) and o."""
    d, H = c["d_model"], c["n_heads"]
    if mixer == "attn":
        hd, K = c["head_dim"], c["n_kv_heads"]
        return d * H * hd + 2 * d * K * hd + H * hd * d
    if mixer != "mla":
        raise _uncounted(mixer)
    m = c["mla"]
    qk = m["qk_nope_dim"] + m["qk_rope_dim"]
    n = d * m["kv_lora_rank"] + d * m["qk_rope_dim"] \
        + m["kv_lora_rank"] * H * (m["qk_nope_dim"] + m["v_head_dim"])
    n += (d * m["q_lora_rank"] + m["q_lora_rank"] * H * qk
          if m["q_lora_rank"] else d * H * qk)
    return n + H * m["v_head_dim"] * d


def ffn_params(c: dict, ffn: str, *, active: bool = False) -> int:
    """Matmul weights of one feed-forward: the SwiGLU; MoE's router, its
    experts and its shared experts (SwiGLUs of ``d_ff_expert``).  With
    ``active``, those one token runs through on this chip: the router,
    the shared experts and ``top_k · experts_held / n_experts`` routed
    experts, the expected routed work of a chip that holds
    ``moe.experts_held`` of them (all where the file does not say)."""
    d = c["d_model"]
    if ffn == "dense":
        return 3 * d * c["d_ff"]
    if ffn != "moe":
        raise _uncounted(ffn)
    m = c["moe"]
    E, expert = m["n_experts"], 3 * d * m["d_ff_expert"]
    routed = (expert * m["top_k"] * m.get("experts_held", E) // E
              if active else expert * E)
    return d * E + expert * m["n_shared"] + routed


def layer_matmul_params(c: dict, mixer: str = "attn", ffn: str = "dense",
                        *, active: bool = False) -> int:
    """Matmul weights of one pre-norm sub-layer of ``mixer`` and ``ffn``
    (with ``active``, as :func:`ffn_params`)."""
    return mixer_params(c, mixer) + ffn_params(c, ffn, active=active)


def _attention_width(c: dict, mixer: str) -> int:
    """Dqk + Dv a head of one mixer's attention products."""
    if mixer == "attn":
        return 2 * c["head_dim"]
    if mixer != "mla":
        raise _uncounted(mixer)
    m = c["mla"]
    return m["qk_nope_dim"] + m["qk_rope_dim"] + m["v_head_dim"]


def _stack(c: dict, per_sublayer) -> int:
    """Σ over the stack's layers of ``per_sublayer(mixer, ffn)``."""
    return sum(n * sum(per_sublayer(m, f) for m, f in zip(mixers, ffns))
               for mixers, n, ffns in groups(c))


def param_count(c: dict, *, active: bool = False) -> int:
    """Every parameter: embedding, head unless tied, the layers' matmuls
    and two norm scales, the final norm; with ``active``, the
    feed-forwards' as :func:`ffn_params`."""
    d, V = c["d_model"], c["vocab_size"]
    head = 0 if c["tie_embeddings"] else V * d
    return V * d + head + _stack(c, lambda m, f: layer_matmul_params(
        c, m, f, active=active) + 2 * d) + d


def mixer_flops(c: dict, batch: int, seq: int) -> int:
    """A train step's attention products (QKᵀ over Dqk and PV over Dv, for
    the causal pairs), forward once and backward twice."""
    seen = seen_pairs(seq, seq)
    return _stack(c, lambda m, _: 3 * 2 * batch * c["n_heads"]
                  * _attention_width(c, m) * seen)


def train_step_flops(c: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one train step: 6·N·T over the matmul parameters
    active per token (every parameter but the embedding lookup, which
    counts where the head is tied to it) plus the attention products;
    recomputation not counted."""
    n_matmul = param_count(c, active=True) - (
        0 if c["tie_embeddings"] else c["vocab_size"] * c["d_model"])
    return 6 * n_matmul * batch * seq + mixer_flops(c, batch, seq)


def token_flops(c: dict):
    """:func:`forward_token_flops` of ``c`` as a function of
    ``(position, *, head)``, the stack walked once: a serve run counts
    every served token by it."""
    matmul = _stack(c, lambda m, f: 2 * layer_matmul_params(
        c, m, f, active=True))
    per_key = _stack(c, lambda m, _: 2 * c["n_heads"] * _attention_width(c, m))
    logits = 2 * c["d_model"] * c["vocab_size"]

    def flops(position: int, *, head: bool) -> int:
        return matmul + per_key * (position + 1) + (logits if head else 0)
    return flops


def forward_token_flops(c: dict, position: int, *, head: bool) -> int:
    """Model FLOPs of one token's forward pass at ``position``: 2 per
    matmul weight it runs through in every layer, the attention products
    over the ``position + 1`` keys it sees, and the head where the
    token's logits are computed (the last token of a chunk, every
    decoded token)."""
    return token_flops(c)(position, head=head)


def prompt_flops(c: dict, length: int) -> int:
    """Model FLOPs of a prompt of ``length`` tokens: every token's layers
    over the causal pairs, and the head once (the first generated
    token's logits), however many chunks the program runs it in."""
    seen = seen_pairs(length, length)
    return _stack(c, lambda m, f: 2 * layer_matmul_params(
        c, m, f, active=True) * length
        + 2 * c["n_heads"] * _attention_width(c, m) * seen) \
        + 2 * c["d_model"] * c["vocab_size"]
