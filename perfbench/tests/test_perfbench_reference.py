"""The plain reference against the program on reduced configurations on
the CPU, at f32 compute: prefill then decode logits (phi3-mini), one
train step's loss, gradients and update (minicpm-2b); and the fp8
control differing from it."""
import dataclasses

import pytest
import torch

from perfbench import program, spec
from perfbench.reference import dense_decoder as ref

BENCH = spec.load()
SMALL = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=256)
CPU = torch.device("cpu")


def small_config(workload: str, **over) -> dict:
    return {**spec.cell(BENCH, workload).config, **SMALL, **over}


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_reference_matches_the_programs_prefill_and_decode(kv_heads):
    from repro_torch.models import transformer
    c = small_config("phi3.serve.decode", compute_dtype="float32",
                     n_kv_heads=kv_heads)
    cfg = program.model_config(c)
    params = ref.draw_params(c, 11, CPU, matmul_dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, c["vocab_size"], (1, 9), generator=g)
    caches = transformer.init_cache(cfg, 1, 32, dtype=torch.float32,
                                    device=CPU)
    logits, caches = transformer.prefill(cfg, params, prompt, caches)
    seq, got = prompt[0].tolist(), [logits[0]]
    for _ in range(6):
        tok = int(got[-1].argmax())
        seq.append(tok)
        lg, caches = transformer.decode_step(
            cfg, params, torch.tensor([tok]), caches)
        got.append(lg[0])
    want = ref.logits(c, params, torch.tensor(seq))[8:]
    assert torch.allclose(torch.stack(got), want, atol=2e-4, rtol=1e-4)


def test_reference_matches_one_program_train_step():
    from repro_torch.training.optimizer import leaves
    c = small_config("minicpm.train.s4096", compute_dtype="float32")
    opt = c["train"]["optimizer"]
    cfg = program.model_config(c)
    params = ref.draw_params(c, 5, CPU, matmul_dtype=torch.float32)
    state = {"params": params, "opt": program.opt_state(params)}
    step = program.train_step(c, cfg, state, CPU)
    g = torch.Generator().manual_seed(1)
    t = torch.randint(0, c["vocab_size"], (2, 17), generator=g)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    _, metrics = step(state, batch)
    theirs = ref.draw_params(c, 5, CPU, matmul_dtype=torch.float32)
    out = ref.train_steps(c, opt, theirs, [batch])
    assert float(metrics["loss"]) == pytest.approx(out["losses"][0],
                                                   rel=1e-5)
    m = [float(torch.linalg.vector_norm(ref.get(state["opt"]["m"], p)))
         / (1 - opt["b1"]) for p in ref.leaf_paths(c)]
    assert m == pytest.approx(out["grad_norms"], rel=1e-4, abs=1e-7)
    for p in ref.leaf_paths(c):
        assert torch.allclose(ref.get(state["params"], p),
                              ref.get(theirs, p), atol=1e-6, rtol=1e-5)
    assert len(leaves(state["params"])) == len(ref.leaf_paths(c))


def test_the_fp8_control_departs_from_the_reference():
    c = small_config("phi3.serve.decode")
    params = ref.draw_params(c, 2, CPU, matmul_dtype=torch.bfloat16)
    ids = torch.randint(0, c["vocab_size"], (40,),
                        generator=torch.Generator().manual_seed(0))
    f32 = ref.logits(c, params, ids)
    fp8 = ref.logits(c, params, ids, mode="fp8")
    gap = (f32 - fp8).abs().max()
    assert 0.02 < gap < 5.0
    # the rounding itself: e4m3 keeps 3 bits, at most 1/16 off a value
    x = torch.randn(64, 32)
    q = ref._fp8(x, -1)
    assert ((q - x).abs() <= x.abs() / 16 + 1e-6 * x.abs().amax()).all()


def test_weights_are_drawn_from_the_seed_leaf_by_leaf():
    c = small_config("minicpm.train.s4096")
    a = ref.draw_params(c, 2**40 + 1, CPU, matmul_dtype=torch.float32)
    b = ref.draw_params(c, 2**40 + 1, CPU, matmul_dtype=torch.float32)
    d = ref.draw_params(c, 2**40 + 2, CPU, matmul_dtype=torch.float32)
    for i, p in enumerate(ref.leaf_paths(c)):
        assert torch.equal(ref.get(a, p), ref.get(b, p))
        assert torch.equal(ref.redraw(c, 2**40 + 1, i, CPU), ref.get(a, p))
        if ref.get(a, p).abs().sum() > 0:
            assert not torch.equal(ref.get(a, p), ref.get(d, p))
    assert "lm_head" not in a                     # tied to the embedding
    cfg = program.model_config(small_config("phi3.serve.decode"))
    assert dataclasses.asdict(cfg)["groups"][0]["count"] == 2
