"""Roofline model: three terms from a dry-run's counts.

The port of ``repro.launch.roofline``, for the NVIDIA H100 SXM 80GB at
its 700 W limit.  Peaks from NVIDIA's data sheet (dense, no sparsity),
not measured:

  989 TFLOP/s bf16 per card · 3.35 TB/s HBM3 · NVLink 4 at 450 GB/s each
  way inside a node of 8 cards · 400 Gb/s NDR InfiniBand (50 GB/s) per
  card across nodes.

Mesh to nodes: ranks are laid out row-major over the mesh's axes, the
model axis innermost, and a node holds ranks 8k…8k+7.  A collective's
group crosses the slowest link it spans: NVLink when all its ranks sit
in one node, InfiniBand otherwise (on the 16×16 mesh a model-axis group
spans two nodes and a data-axis group sixteen).  ``t_collective`` sums
each collective's ring bytes over its group's link.

The counts are per device (``repro_torch.launch.op_cost`` counts each
rank's local operations).  Ring-model scaling per op:

  all-reduce       2(n−1)/n · B     (reduce-scatter + all-gather phases)
  all-gather       (n−1)/n · B_out
  reduce-scatter   (n−1)/n · B_in
  all-to-all       (n−1)/n · B
  collective-permute   1 · B

The reference's ``parse_collectives`` reads XLA's HLO text, which has no
counterpart here: the collectives come from ``op_cost``, which sees each
one DTensor issues.
"""
from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12      # bf16 per card, dense (data sheet)
HBM_BW = 3.35e12         # bytes/s per card (data sheet)
NVLINK_BW = 450e9        # bytes/s each way, inside a node (NVLink 4)
IB_BW = 50e9             # bytes/s per card across nodes (400 Gb/s NDR)
NODE_SIZE = 8            # cards a node holds


def link_bw(ranks) -> float:
    """The bandwidth of the slowest link a group of global ``ranks``
    crosses: NVLink inside one node, InfiniBand across nodes."""
    return NVLINK_BW if len({r // NODE_SIZE for r in ranks}) <= 1 else IB_BW


@dataclass
class CollectiveStats:
    counts: dict[str, int] = field(default_factory=dict)
    raw_bytes: dict[str, int] = field(default_factory=dict)
    ring_bytes: float = 0.0      # per-device bytes on the wire (ring model)
    ring_s: float = 0.0          # the same over each group's link, seconds

    def add(self, op: str, nbytes: int, n: int,
            bw: float = NVLINK_BW) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.raw_bytes[op] = self.raw_bytes.get(op, 0) + nbytes
        if n <= 1:
            return
        if op == "all-reduce":
            wire = 2 * (n - 1) / n * nbytes
        elif op in ("all-gather", "reduce-scatter", "all-to-all"):
            wire = (n - 1) / n * nbytes
        else:  # collective-permute
            wire = nbytes
        self.ring_bytes += wire
        self.ring_s += wire / bw


@dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    model_flops_per_chip: float = 0.0
    #: the collective term over each group's link (``CollectiveStats``);
    #: None: every collective inside one node
    coll_s: float | None = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_s is not None:
            return self.coll_s
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the step's compute is
        useful (catches remat/redundancy waste).  >1 means the count
        misses work (e.g. products outside any counted op); <1 means
        recompute/overhead."""
        if self.flops == 0:
            return 0.0
        return self.model_flops_per_chip / self.flops

    @property
    def mfu_bound(self) -> float:
        """Upper bound on achievable MFU for this cell: useful FLOPs per
        card / (peak FLOP/s × bound time)."""
        if self.t_bound == 0:
            return 0.0
        return self.model_flops_per_chip / PEAK_FLOPS / self.t_bound

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "hbm_bytes_per_chip": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_chip": self.model_flops_per_chip,
            "useful_flop_fraction": self.useful_flop_fraction,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(cfg, shape, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (inference fwd),
    N = active params (MoE: top-k + shared)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
