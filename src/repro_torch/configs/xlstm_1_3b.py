"""xlstm-1.3b [ssm] — arXiv:2405.04517.

48L d_model=2048 4H d_ff=0 vocab=50304 — mLSTM + sLSTM blocks at 7:1
(xLSTM[7:1]); blocks carry their own projections (d_ff=0).
Runs long_500k: matrix/scalar memory is O(1) in sequence length.
"""
from .base import LayerGroup, ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    arch_id="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    # f32 activations: the official xLSTM keeps its exponential-gating
    # cells out of autocast for a reason — under bf16, the step-recurrent
    # decode form and the chunkwise-parallel prefill/teacher-forcing form
    # (algebraically equal, different summation order) drift by ~1 bf16
    # ulp per block, which the gate nonlinearities compound ~1.4x per
    # layer into O(1) logit divergence over the 48-layer stack.  f32
    # keeps the two forms within ~1e-4 end to end
    # (test_prefill_decode_consistency).
    compute_dtype="float32",
    groups=(
        LayerGroup(
            pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                     "mlstm", "mlstm", "mlstm", "slstm"),
            count=6, ffn="none"),
    ),
    rec=RecurrentConfig(mlstm_proj_factor=2.0, slstm_proj_factor=4.0 / 3.0),
    notes="d_ff=0: FFN folded into block projections (mLSTM up/down 2x, "
          "sLSTM gated 4/3 tail). sLSTM is inherently sequential "
          "(hidden-to-hidden R) — lax.scan over time, DESIGN.md §5.",
)
