"""Config system: model / parallelism / run configs.

Every assigned architecture is a :class:`ModelConfig` instance in its own
``configs/<arch_id>.py`` (exact published shapes) plus a ``reduced()``
variant for CPU smoke tests.  The config is the single source of truth the
model builder (`models/transformer.py`), the sharding rules
(`distributed/sharding.py`), and the dry-run (`launch/dryrun.py`) consume.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Literal

Mixer = Literal["attn", "attn_local", "mla", "rglru", "mlstm", "slstm"]
FFN = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerGroup:
    """A scanned stack of identical super-blocks.

    ``pattern`` lists the mixer of each sub-layer in one super-block;
    ``ffn`` the feed-forward attached to each sub-layer; ``count`` how many
    super-blocks are stacked (a loop over the stacked ``count`` axis).  Heterogeneous
    stacks (recurrentgemma's 2-recurrent:1-attention, xLSTM's 7:1) are
    expressed as multi-entry patterns.
    """
    pattern: tuple[Mixer, ...]
    count: int
    ffn: tuple[FFN, ...] | FFN = "dense"

    def ffn_of(self, i: int) -> FFN:
        if isinstance(self.ffn, tuple):
            return self.ffn[i]
        return self.ffn

    @property
    def layers(self) -> int:
        return len(self.pattern) * self.count


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared: int = 0             # always-on shared experts
    d_ff_expert: int = 0          # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_coef: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = no q compression
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RecurrentConfig:
    conv_width: int = 4
    d_rnn: int = 0                # 0 = d_model
    local_window: int = 2048      # sliding-window size for attn_local
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: Literal["dense", "moe", "audio", "hybrid", "ssm", "vlm"]
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: tuple[LayerGroup, ...]
    head_dim: int = 0             # 0 = d_model // n_heads
    rope_theta: float = 1e6
    m_rope_sections: tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w)
    tie_embeddings: bool = False
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    rec: RecurrentConfig = field(default_factory=RecurrentConfig)
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    n_visual_tokens: int = 0      # stub frontend token count (vlm)
    norm_eps: float = 1e-5
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes for DESIGN.md §Arch-applicability
    notes: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(g.layers for g in self.groups)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks); used for the
        6·N·D MODEL_FLOPS roofline term."""
        d, hd = self.d_model, self.head_dim_
        n = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for g in self.groups:
            per_block = 0
            for i, mixer in enumerate(g.pattern):
                per_block += _mixer_params(self, mixer)
                per_block += _ffn_params(self, g.ffn_of(i))
                # RMSNorm scales: norm1 always; norm2 only with an FFN
                per_block += d + (d if g.ffn_of(i) != "none" else 0)
            n += per_block * g.count
        n += d                                        # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        d = self.d_model
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for g in self.groups:
            per_block = 0
            for i, mixer in enumerate(g.pattern):
                per_block += _mixer_params(self, mixer)
                f = g.ffn_of(i)
                if f == "moe":
                    e = 3 * d * self.moe.d_ff_expert
                    per_block += e * (self.moe.top_k + self.moe.n_shared)
                    per_block += d * self.moe.n_experts  # router
                elif f == "dense":
                    per_block += 3 * d * self.d_ff
                per_block += d + (d if f != "none" else 0)
            n += per_block * g.count
        n += d
        return n


def _mixer_params(cfg: ModelConfig, mixer: str) -> int:
    d, hd = cfg.d_model, cfg.head_dim_
    H, K = cfg.n_heads, cfg.n_kv_heads
    if mixer in ("attn", "attn_local"):
        return d * H * hd + 2 * d * K * hd + H * hd * d   # q, k, v, o
    if mixer == "mla":
        m = cfg.mla
        qd = m.qk_nope_dim + m.qk_rope_dim
        n = d * m.kv_lora_rank + d * m.qk_rope_dim          # kv down + shared rope k
        n += m.kv_lora_rank * H * (m.qk_nope_dim + m.v_head_dim)  # kv up
        if m.q_lora_rank:
            n += d * m.q_lora_rank + m.q_lora_rank * H * qd
        else:
            n += d * H * qd
        n += H * m.v_head_dim * d                            # o
        return n
    if mixer == "rglru":
        r = cfg.rec
        dr = r.d_rnn or d
        nb = cfg.n_heads if dr % cfg.n_heads == 0 else 1
        # in-proj (2 branches), temporal conv, block-diag gates (x2),
        # Λ, out-proj — Griffin recurrent block
        return 2 * d * dr + r.conv_width * dr + 2 * dr * (dr // nb) + dr + dr * d
    if mixer == "mlstm":
        r = cfg.rec
        di = int(d * r.mlstm_proj_factor)
        nb = 4 if di % 4 == 0 else 1
        # up(x+o), block-diag qkv, i/f gates, down
        return 2 * d * di + 3 * di * (di // nb) + 2 * di * cfg.n_heads + di * d
    if mixer == "slstm":
        r = cfg.rec
        H_ = cfg.n_heads
        dh = d // H_
        return 4 * d * d + 4 * H_ * dh * dh + int(2 * d * d * r.slstm_proj_factor)
    raise ValueError(mixer)


def _ffn_params(cfg: ModelConfig, ffn: str) -> int:
    d = cfg.d_model
    if ffn == "dense":
        return 3 * d * cfg.d_ff                  # SwiGLU: w_gate, w_up, w_down
    if ffn == "moe":
        e = 3 * d * cfg.moe.d_ff_expert
        return e * (cfg.moe.n_experts + cfg.moe.n_shared) + d * cfg.moe.n_experts
    return 0


@dataclass(frozen=True)
class SchedConfig:
    """Task-scheduling knob consumed by ``core.Executor`` / ``repro_torch.sched``.

    ``policy`` names a registered placement policy (``balanced`` — paper
    Algorithm 1, the default — ``heft``, ``round_robin``, ``random``);
    the examples thread it through to ``Executor(scheduler=...)``.
    ``device_speed`` (bin heterogeneity for simulation/HEFT; empty =
    homogeneous) and ``host_workers`` (simulated host-pool concurrency)
    are the defaults ``benchmarks/sched_bench.py`` starts from.

    Profile-guided knobs (docs/scheduling.md "profile → fit → re-place"):
    ``steal_locality`` toggles the executor's locality-aware work
    stealing; ``replace_every`` (> 0) re-invokes the scheduler between
    graph iterations using measured per-bin load; ``migrate_top_k``
    (> 0) switches those re-placements from full repacking to hot-group
    migration (move at most k hottest groups; near-equal loads keep the
    placement); ``trace_path``, when set, records a
    ``sched.TaskProfiler`` trace there for offline ``CostModel.fit``
    calibration.

    Since the event-driven redesign (docs/scheduling.md "Online
    scheduling") both dynamic knobs route through the long-lived
    :meth:`Scheduler.update` loop: the executor seeds a
    ``SchedulerState`` with ``measured_load`` (and ``migrate_top_k``)
    and sends an empty ``SchedulerUpdate`` — a reschedule *is* an
    update with measured-load state and no new work.  (The old
    ``Scheduler.reschedule()`` entry point went through its two-cycle
    deprecation and was removed; docs/scheduling.md has the migration
    guide.)

    Non-ideal sharded scaling (``CostModel.collective_overhead``):
    ``collective_alpha`` (seconds per ring hop) and ``collective_beta``
    (bytes/s per link) charge mesh-wide compute an α·(n−1) +
    bytes·(n−1)/(n·β) ring-collective term in the simulator and HEFT's
    EFT instead of the ideal linear ``device_count`` speedup.  Both
    default 0 = overhead off (baselines reproduce bit-for-bit);
    ``sched_bench --collective-alpha/--collective-beta`` sweeps them.

    ``memory_bytes`` (> 0) gives every execution bin a byte budget
    (``ExecutionBin.memory_bytes``): policies pack group footprints
    against it, the simulator converts overflow into forced-spill
    charges, and the executor caps each bin's buddy arena at the
    largest power of two under it.  0 = unlimited (the default — all
    pre-existing baselines reproduce bit-for-bit);
    ``sched_bench --memory-bytes`` sweeps it.
    """
    policy: str = "balanced"
    host_workers: int = 4
    device_speed: tuple[float, ...] = ()
    steal_locality: bool = True
    replace_every: int = 0
    migrate_top_k: int = 0
    trace_path: str = ""
    collective_alpha: float = 0.0
    collective_beta: float = 0.0
    memory_bytes: int = 0


DEFAULT_SCHED = SchedConfig()


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic state; DESIGN.md §5)
LONG_CONTEXT_ARCHS = {"recurrentgemma-2b", "xlstm-1.3b"}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test-size variant of a config: same family/pattern, tiny dims.

    Keeps ≥2 super-blocks and the full mixer pattern so the smoke test
    exercises the same code paths as the full config.
    """
    def shrink_group(g: LayerGroup) -> LayerGroup:
        return dataclasses.replace(g, count=min(g.count, 2))

    moe = cfg.moe
    if moe.n_experts:
        # capacity_factor high enough to be dropless at smoke scale, so
        # prefill+decode teacher-forcing consistency is exact
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, 8),
            top_k=min(moe.top_k, 2), d_ff_expert=64,
            n_shared=min(moe.n_shared, 1), capacity_factor=8.0)
    mla = dataclasses.replace(
        cfg.mla, kv_lora_rank=32, q_lora_rank=(32 if cfg.mla.q_lora_rank else 0),
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    rec = dataclasses.replace(
        cfg.rec, d_rnn=(64 if cfg.rec.d_rnn else 0), local_window=32)
    n_heads = min(cfg.n_heads, 4)
    return dataclasses.replace(
        cfg,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, n_heads)),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        m_rope_sections=(4, 2, 2) if cfg.m_rope_sections else (),
        groups=tuple(shrink_group(g) for g in cfg.groups),
        moe=moe, mla=mla, rec=rec,
        n_visual_tokens=min(cfg.n_visual_tokens, 8),
    )
