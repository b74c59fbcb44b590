"""The port's kernels, as they run on the CPU (their plain PyTorch
versions), against the JAX package's Pallas kernels in interpret mode and
their pure-jnp references, on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of one thread per core would crowd the timing-
# sensitive runtime tests running beside these
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as j_decode  # noqa: E402
from repro.kernels import flash_attention as j_flash  # noqa: E402
from repro.kernels import moe_gating as j_gating  # noqa: E402
from repro.kernels import rglru_scan as j_rglru  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.moe_gating.ref import moe_gating_ref  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import (decode_attention, decode_attention_plain,  # noqa: E402
                                 flash_attention, flash_attention_bwd_plain,
                                 flash_attention_plain, moe_gating,
                                 moe_gating_plain, rglru_scan,
                                 rglru_scan_plain)
from repro_torch.kernels.flash_attention.ops import bwd_launch_shape  # noqa: E402
from repro_torch.kernels.moe_gating.ops import gating_launch_shape  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import scan_launch_shape  # noqa: E402

#: as tests/test_kernels.py: f32 sums in another order; bf16 rounding
TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor (bf16 rounds to
    nearest even in both)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,D,win,qb,kb", [
    (2, 4, 2, 256, 64, None, 128, 128),
    (1, 4, 1, 100, 32, None, 64, 32),      # MQA + ragged seq
    (2, 2, 2, 128, 16, 48, 32, 64),        # sliding window
    (1, 8, 8, 64, 128, None, 64, 64),      # MHA, head dim 128
    (1, 4, 4, 80, 96, None, 32, 32),       # phi3-mini's head dim 96
    (1, 10, 1, 100, 256, 48, 32, 32),      # recurrentgemma: MQA, D 256, window
])
def test_flash_plain_matches_pallas_and_ref(dtype, B, H, K, S, D, win, qb, kb):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, S, n, D)).astype(np.float32), dtype)
        for n in (H, K, K))
    out = flash_attention(tq, tk, tv, window=win)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, D)
    pallas = j_flash(jq, jk, jv, window=win, q_block=qb, kv_block=kb,
                     interpret=True)
    ref = attention_ref(jq.transpose(0, 2, 1, 3), jk.transpose(0, 2, 1, 3),
                        jv.transpose(0, 2, 1, 3), window=win
                        ).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,D,kb", [
    (2, 8, 2, 256, 64, 64),
    (1, 4, 4, 100, 32, 32),
    (3, 2, 1, 64, 16, 16),
    (2, 4, 4, 96, 96, 32),                 # phi3-mini's head dim 96
    (2, 10, 1, 64, 256, 32),               # recurrentgemma: G 10, D 256
])
def test_decode_plain_matches_pallas_and_ref(dtype, B, H, K, S, D, kb):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng.standard_normal((B, H, D)).astype(np.float32), dtype)
    (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, S, K, D)).astype(np.float32), dtype)
        for _ in range(2))
    lens = np.array([max(1, S - 7 * i) for i in range(B)], np.int32)
    out = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == (B, H, D)
    pallas = j_decode(jq, jk, jv, jnp.asarray(lens), kv_block=kb,
                      interpret=True)
    ref = decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])


# a value head dim Dv unlike the q/k head dim D: the reduced MLA's 24/16
# and deepseek-v2's 192/128
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,S,D,Dv,kb", [
    (2, 4, 4, 70, 24, 16, 32),
    (1, 4, 4, 40, 192, 128, 16),
    (2, 4, 2, 33, 192, 128, 16),           # GQA at Dv != D
])
def test_attention_plain_takes_dv_like_pallas_and_ref(dtype, B, H, K, S, D,
                                                      Dv, kb):
    """Flash (causal prompt) and decode (a cache masked at valid_len) with
    v (…, Dv): the port's wrappers against the Pallas kernels in interpret
    mode and the jnp references, output (…, Dv)."""
    rng = np.random.default_rng(4)
    scale = 1.0 / np.sqrt(D)
    (jq, tq), (jk, tk) = (
        _pair(rng.standard_normal((B, S, n, D)).astype(np.float32), dtype)
        for n in (H, K))
    jv, tv = _pair(rng.standard_normal((B, S, K, Dv)).astype(np.float32),
                   dtype)
    out = flash_attention(tq, tk, tv, scale=scale)
    assert out.dtype == tq.dtype and out.shape == (B, S, H, Dv)
    pallas = j_flash(jq, jk, jv, scale=scale, q_block=kb, kv_block=kb,
                     interpret=True)
    ref = attention_ref(*(t.transpose(0, 2, 1, 3) for t in (jq, jk, jv)),
                        scale=scale).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])

    lens = np.array([max(1, S - 11 * i) for i in range(B)], np.int32)
    out = decode_attention(tq[:, 0], tk, tv, torch.from_numpy(lens))
    assert out.dtype == tq.dtype and out.shape == (B, H, Dv)
    pallas = j_decode(jq[:, 0], jk, jv, jnp.asarray(lens), kv_block=kb,
                      interpret=True)
    ref = decode_attention_ref(jq[:, 0], jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOLS[dtype])
    np.testing.assert_allclose(_f32(out), _f32(ref), **TOLS[dtype])


# a prompt at a cache offset (chunked prefill): query row i at key
# position q_offset + i, against the reference's chunked online-softmax
# attention, which its ``attention(q_offset=...)`` runs (there is no
# Pallas kernel for it)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K,D,Dv", [(4, 2, 32, 32), (4, 4, 24, 16)])
@pytest.mark.parametrize("win", [None, 16])
@pytest.mark.parametrize("offset", [0, 1, 7, "Sk - Sq"])
def test_flash_plain_at_a_q_offset_matches_the_reference(dtype, H, K, D, Dv,
                                                         win, offset):
    B, Sq, Sk = 2, 20, 45
    off = Sk - Sq if offset == "Sk - Sq" else offset
    rng = np.random.default_rng(5)
    scale = 1.0 / np.sqrt(D)
    jq, tq = _pair(rng.standard_normal((B, Sq, H, D)).astype(np.float32),
                   dtype)
    jk, tk = _pair(rng.standard_normal((B, Sk, K, D)).astype(np.float32),
                   dtype)
    jv, tv = _pair(rng.standard_normal((B, Sk, K, Dv)).astype(np.float32),
                   dtype)
    out, lse = flash_attention(tq, tk, tv, window=win, scale=scale,
                               q_offset=off, with_lse=True)
    assert out.dtype == tq.dtype and out.shape == (B, Sq, H, Dv)
    ref, ref_lse = jl._chunk_scan_attn(jq, jk, jv, causal=True, q_offset=off,
                                       window=win, q_block=8, kv_block=16,
                                       scale=scale, with_lse=True)
    np.testing.assert_allclose(_f32(out), _f32(ref.astype(jq.dtype)),
                               **TOLS[dtype])
    # the reference's (B, K, G, padded Sq) against the port's (B, H, Sq)
    ref_lse = np.asarray(ref_lse)[..., :Sq].reshape(B, H, Sq)
    np.testing.assert_allclose(_f32(lse), ref_lse, **TOLS[dtype])
    whole = jl.attention(jq, jk, jv, q_offset=off, window=win, scale=scale)
    np.testing.assert_allclose(_f32(out), _f32(whole), **TOLS[dtype])


def test_wrappers_reject_a_value_cache_of_another_length():
    """k and v must agree but for their last dimension."""
    q = torch.zeros((1, 4, 4, 24))
    k = torch.zeros((1, 4, 4, 24))
    with pytest.raises(ValueError):
        flash_attention(q, k, torch.zeros((1, 5, 4, 16)))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], k, torch.zeros((1, 4, 2, 16)),
                         torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], torch.zeros((1, 4, 4, 16)),
                         torch.zeros((1, 4, 4, 16)),
                         torch.ones((1,), dtype=torch.int32))


def test_decode_valid_len_zero_follows_the_pallas_kernel():
    """valid_len 0: the Pallas kernel's additive -1e30 mask averages V over
    the cache; the jnp reference's -inf mask gives NaN.  The port follows
    the kernel (cache of one kv block, so no padded rows enter the mean)."""
    rng = np.random.default_rng(2)
    B, H, K, S, D = 2, 4, 2, 64, 32
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2))
    lens = np.array([0, 5], np.int32)
    out = decode_attention(*(torch.from_numpy(a) for a in (q, k, v, lens)))
    pallas = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(lens), kv_block=S, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas),
                               **TOLS["float32"])
    mean_v = np.repeat(v[0].mean(0), H // K, axis=0)
    np.testing.assert_allclose(out[0].numpy(), mean_v, **TOLS["float32"])
    ref = decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lens))
    assert np.isnan(np.asarray(ref)[0]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,dr,ch,db", [
    (2, 64, 128, 32, 64),
    (1, 100, 96, 16, 96),                   # ragged time
    (2, 37, 32, 8, 32),
])
def test_rglru_scan_plain_matches_pallas_and_ref(dtype, B, S, dr, ch, db):
    """The sweep of tests/test_kernels.py, at its tolerances."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((B, S, dr)).astype(np.float32), dtype)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, dr))))
    ja, ta = _pair(a.astype(np.float32), dtype)
    h0 = rng.standard_normal((B, dr)).astype(np.float32)
    out = rglru_scan(tx, ta, torch.from_numpy(h0))
    assert out.dtype == tx.dtype and out.shape == (B, S, dr)
    pallas = j_rglru(jx, ja, jnp.asarray(h0), chunk=ch, channel_block=db,
                     interpret=True)
    ref = rglru_scan_ref(jx, ja, jnp.asarray(h0))
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=1e-1, atol=1e-1))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **tol)
    np.testing.assert_allclose(_f32(out), _f32(ref), **tol)


def _gating_close(got, want):
    """eids, slots and keep exact; gates as tests/test_kernels.py."""
    for g, w, name in zip(got, want, ["eids", "gates", "slots", "keep"]):
        g, w = _f32(g), _f32(w)
        if name == "gates":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("T,E,k,C,tb", [
    (128, 16, 2, 24, 32),
    (100, 8, 1, 16, 32),                    # ragged tokens
    (256, 32, 4, 40, 64),
    (64, 4, 2, 8, 16),                      # heavy capacity drops
])
def test_moe_gating_plain_matches_pallas_and_ref(T, E, k, C, tb):
    logits = np.random.default_rng(T).standard_normal((T, E)).astype(np.float32)
    got = moe_gating(torch.from_numpy(logits), top_k=k, capacity=C)
    assert [t.dtype for t in got] == [torch.int32, torch.float32,
                                      torch.int32, torch.bool]
    _gating_close(got, j_gating(jnp.asarray(logits), top_k=k, capacity=C,
                                token_block=tb, interpret=True))
    _gating_close(got, moe_gating_ref(jnp.asarray(logits), top_k=k,
                                      capacity=C))


def test_moe_gating_ties_take_the_lower_expert_first():
    """Logits of a few distinct values tie often: lax.top_k's order (the
    lower expert first) decides the experts and so every slot."""
    rng = np.random.default_rng(5)
    T, E, k, C = 96, 16, 3, 16
    logits = rng.integers(0, 3, (T, E)).astype(np.float32)
    got = moe_gating(torch.from_numpy(logits), top_k=k, capacity=C)
    _gating_close(got, j_gating(jnp.asarray(logits), top_k=k, capacity=C,
                                token_block=32, interpret=True))
    for row, ids in zip(logits[:8], got[0][:8].tolist()):
        assert ids == sorted(range(E), key=lambda e: -row[e])[:k]


def test_moe_gating_capacity_invariant():
    """No expert slot is ever assigned twice among kept entries."""
    T, E, k, C = 512, 8, 2, 32
    logits = np.random.default_rng(9).standard_normal((T, E)) * 4
    eids, gates, slots, keep = moe_gating(
        torch.from_numpy(logits.astype(np.float32)), top_k=k, capacity=C)
    kept = slots.reshape(-1)[keep.reshape(-1)].tolist()
    assert len(kept) == len(set(kept)) and not bool(keep.all())
    assert bool((gates >= 0).all())
    assert bool((slots // C == eids).all())


def test_cpu_wrappers_compute_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    before = [f.launches for f in (flash_attention, decode_attention,
                                   rglru_scan, moe_gating)]
    torch.testing.assert_close(flash_attention(q, kv, kv),
                               flash_attention_plain(q, kv, kv))
    vl = torch.tensor([4], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, 0], kv, kv, vl),
                               decode_attention_plain(q[:, 0], kv, kv, vl))
    a = torch.sigmoid(q[..., 0])
    torch.testing.assert_close(rglru_scan(q[..., 0], a, q[:, 0, :, 1]),
                               rglru_scan_plain(q[..., 0], a, q[:, 0, :, 1]))
    for g, p in zip(moe_gating(q[0, :, 0], top_k=2, capacity=8),
                    moe_gating_plain(q[0, :, 0], top_k=2, capacity=8)):
        torch.testing.assert_close(g, p)
    assert [f.launches for f in (flash_attention, decode_attention,
                                 rglru_scan, moe_gating)] == before


def test_wrappers_reject_mismatched_shapes():
    q = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 4, 3, 16)), torch.zeros((1, 4, 3, 16)))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], torch.zeros((1, 4, 2, 16)),
                         torch.zeros((1, 4, 2, 16)),
                         torch.zeros((2,), dtype=torch.int32))
    x = torch.zeros((2, 5, 8))
    with pytest.raises(ValueError):
        rglru_scan(x, torch.zeros((2, 4, 8)), torch.zeros((2, 8)))
    with pytest.raises(ValueError):
        rglru_scan(x, x, torch.zeros((1, 8)))
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((4, 8)), top_k=9, capacity=8)
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((4, 8)), top_k=1, capacity=0)
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((4, 2, 8)), top_k=1, capacity=8)


# ---------------------------------------------------------------------------
# the numerical designs of the CUDA kernels, emulated in plain torch (the
# kernels themselves run only on the card: tests/test_torch_cuda.py)
# ---------------------------------------------------------------------------
def _flash_tensor_core_emulation(q, k, v, *, window=None, split_p=True,
                                 kv_tile=64):
    """The bf16 flash kernel's arithmetic: bf16 Q·K products summed in f32,
    logits in log2 units with the additive -1e30 masks, an online softmax
    over kv tiles (exp2), P split into bf16 hi and lo parts (or rounded to
    bf16 once) multiplied with bf16 V and summed in f32, normalised last.
    q: (B, Sq, H, D), k: (B, Sk, K, D), v: (B, Sk, K, Dv), bf16 values;
    returns f32 (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    c = (1.0 / np.sqrt(D)) * np.log2(np.e)
    qf = q.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    neg = torch.tensor(-1e30)
    m = torch.full((B, K, G, Sq), -1e30)
    l = torch.zeros((B, K, G, Sq))
    acc = torch.zeros((B, K, G, Sq, Dv))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, kv_tile):
        kt, vt = kf[:, k0:k0 + kv_tile], vf[:, k0:k0 + kv_tile]
        k_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        x = torch.einsum("bqkgd,bskd->bkgqs", qf, kt) * c
        x = x + neg * (q_pos < k_pos)
        if window is not None:
            x = x + neg * (q_pos - k_pos >= window)
        mn = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn[..., None])
        l = l * alpha + p.sum(-1)
        if split_p:
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            pv = (torch.einsum("bkgqs,bskd->bkgqd", hi, vt)
                  + torch.einsum("bkgqs,bskd->bkgqd", lo, vt))
        else:
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), vt)
        acc = acc * alpha[..., None] + pv
        m = mn
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)


@pytest.mark.parametrize("B,H,K,S,D,win", [
    (1, 4, 4, 150, 96, None),              # phi3-mini's head dim 96
    (1, 4, 2, 200, 96, 70),                # a window across kv tiles
    (1, 5, 1, 130, 128, None),             # llama4's D, G 5
    (1, 2, 1, 260, 256, 64),               # recurrentgemma's D, window
])
def test_flash_tensor_core_design_holds_the_card_tolerance(B, H, K, S, D,
                                                           win):
    """Splitting P into bf16 hi + lo keeps the bf16 output within the card
    check (2e-5 + 2^-8·|ref|) of the plain version, and the f32 result
    within 2e-5 + 2e-5·|ref|; rounding P to bf16 once does not."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, D))
                                .astype(np.float32)).bfloat16().float()
               for n in (H, K, K))
    ref = flash_attention_plain(q, k, v, window=win)
    emu = _flash_tensor_core_emulation(q, k, v, window=win)
    bound = 2e-5 + 2.0 ** -8 * ref.abs()
    assert bool(((emu.bfloat16().float() - ref).abs() <= bound).all())
    assert bool(((emu - ref).abs() <= 2e-5 + 2e-5 * ref.abs()).all())
    once = _flash_tensor_core_emulation(q, k, v, window=win, split_p=False)
    assert not bool(((once - ref).abs() <= 2e-5 + 2e-5 * ref.abs()).all())


@pytest.mark.parametrize("S", [150, 300])
def test_flash_tensor_core_design_holds_the_card_tolerance_at_mla_dims(S):
    """deepseek-v2's MLA heads, q/k 192 wide and v 128, at its scale
    1/sqrt(192): the split P keeps the bf16 output within the card check
    of the plain version."""
    rng = np.random.default_rng(22)
    H, D, Dv = 4, 192, 128
    q, k = (torch.from_numpy(rng.standard_normal((1, S, H, D))
                             .astype(np.float32)).bfloat16().float()
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, S, H, Dv)).astype(
        np.float32)).bfloat16().float()
    ref = flash_attention_plain(q, k, v)
    emu = _flash_tensor_core_emulation(q, k, v)
    assert emu.shape == (1, S, H, Dv)
    bound = 2e-5 + 2.0 ** -8 * ref.abs()
    assert bool(((emu.bfloat16().float() - ref).abs() <= bound).all())
    assert bool(((emu - ref).abs() <= 2e-5 + 2e-5 * ref.abs()).all())


def _flash_bwd_tensor_core_emulation(q, k, v, out, dout, lse, *,
                                     window=None, split=True):
    """The bf16 backward kernels' arithmetic: bf16 products summed in f32,
    P = exp2(S·scale·log2 e − lse·log2 e) and 0 where masked, dS = P ⊙
    (dP − D)·scale, and P, dS split into bf16 hi and lo parts (or rounded
    to bf16 once) before they multiply dO, Q and K.  Inputs hold bf16
    values; returns f32 dq, dk, dv."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    log2e = np.log2(np.e)
    qf = q.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, Sq, K, G, Dv)
    delta = (do * out.float().reshape(B, Sq, K, G, Dv)).sum(-1)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    hidden = q_pos < k_pos
    if window is not None:
        hidden = hidden | (q_pos - k_pos >= window)
    p = torch.exp2(s * (scale * log2e)
                   - (lse * log2e).reshape(B, K, G, Sq, 1))
    p = torch.where(hidden, torch.zeros(()), p)
    dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    dv = sum(torch.einsum("bkgqs,bqkgd->bskd", x, do) for x in parts(p))
    dk = sum(torch.einsum("bkgqs,bqkgd->bskd", x, qf) for x in parts(ds))
    dq = sum(torch.einsum("bkgqs,bskd->bqkgd", x, kf) for x in parts(ds))
    return dq.reshape(B, Sq, H, D), dk, dv


@pytest.mark.parametrize("B,H,K,S,D,Dv,win", [
    (1, 4, 4, 150, 64, 64, None),          # minicpm's D 64
    (1, 4, 2, 200, 96, 96, 70),            # phi3's D 96, a window, GQA
    (1, 2, 1, 260, 256, 256, 64),          # recurrentgemma's D, window
    (1, 2, 2, 130, 192, 128, None),        # MLA's q/k 192, v 128
])
def test_flash_bwd_tensor_core_design_holds_the_card_tolerance(B, H, K, S, D,
                                                               Dv, win):
    """Splitting P and dS into bf16 hi + lo keeps the bf16 gradients within
    the card check (2e-5 + 2^-8·|ref|) of the plain version on f32 copies,
    and the f32 results within 2e-5 + 2e-5·|ref|; rounding P and dS to
    bf16 once does not."""
    rng = np.random.default_rng(23)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16().float()

    q, k, v = bf16(B, S, H, D), bf16(B, S, K, D), bf16(B, S, K, Dv)
    dout = bf16(B, S, H, Dv)
    out, lse = flash_attention_plain(q, k, v, window=win, with_lse=True)
    out = out.bfloat16().float()
    ref = flash_attention_bwd_plain(q, k, v, out, dout, lse, window=win)
    emu = _flash_bwd_tensor_core_emulation(q, k, v, out, dout, lse,
                                           window=win)
    once = _flash_bwd_tensor_core_emulation(q, k, v, out, dout, lse,
                                            window=win, split=False)
    for e, r in zip(emu, ref):
        assert bool(((e.bfloat16().float() - r).abs()
                     <= 2e-5 + 2.0 ** -8 * r.abs()).all())
        assert bool(((e - r).abs() <= 2e-5 + 2e-5 * r.abs()).all())
    assert not all(bool(((e - r).abs() <= 2e-5 + 2e-5 * r.abs()).all())
                   for e, r in zip(once, ref))


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    value with 10 mantissa bits, ties away from zero (half a unit of the 13
    dropped bits added to the f32 bits, which are then masked off)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(spec, a, b, split=True):
    """``einsum(spec, a, b)`` as the f32 kernels take it on the tensor
    cores: each operand split into TF32 big = tf32(x) and small = tf32(x -
    big), and big·big + big·small + small·big summed in f32; or, without
    ``split``, one TF32 rounding of each operand."""
    if not split:
        return torch.einsum(spec, _tf32(a), _tf32(b))
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (torch.einsum(spec, a_s, bb) + torch.einsum(spec, ab, b_s)
            + torch.einsum(spec, ab, bb))


def test_tf32_rounding_keeps_ten_bits_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e38,
                      1.0 + 2.0 ** -10])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0, float(_tf32(
                             torch.tensor([3.0e38]))[0]), 1.0 + 2.0 ** -10])
    got = _tf32(x)
    assert torch.equal(got, want)
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(
        10000).astype(np.float32))
    big = _tf32(r)
    assert float(((r - big).abs() / r.abs()).max()) <= 2.0 ** -11
    small = _tf32(r - big)
    assert float(((r - big - small).abs() / r.abs()).max()) <= 2.0 ** -21


def _flash_f32_emulation(q, k, v, *, window=None, split=True, kv_tile=32):
    """The f32 flash kernel's arithmetic: Q·Kᵀ and P·V as three TF32
    products each (``_mm3``; or one rounding each), logits in log2 units
    with the additive -1e30 masks, an online softmax over kv tiles of 32
    rows in the kernel's order (exp2), normalised last.  q: (B, Sq, H, D),
    k: (B, Sk, K, D), v: (B, Sk, K, Dv), f32; returns (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    c = (1.0 / np.sqrt(D)) * np.log2(np.e)
    qf = q.reshape(B, Sq, K, G, D)
    neg = torch.tensor(-1e30)
    m = torch.full((B, K, G, Sq), -1e30)
    l = torch.zeros((B, K, G, Sq))
    acc = torch.zeros((B, K, G, Sq, Dv))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, kv_tile):
        kt, vt = k[:, k0:k0 + kv_tile], v[:, k0:k0 + kv_tile]
        k_pos = torch.arange(k0, k0 + kt.shape[1])[None, :]
        x = _mm3("bqkgd,bskd->bkgqs", qf, kt, split) * c
        x = x + neg * (q_pos < k_pos)
        if window is not None:
            x = x + neg * (q_pos - k_pos >= window)
        mn = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(x - mn[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm3("bkgqs,bskd->bkgqd", p, vt, split)
        m = mn
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)


def _full_f32(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


#: the f32 routes' families: phi3's D 96 with a window under GQA, MLA's
#: 192/128, recurrentgemma's 256 with a window, minicpm's 64
F32_FAMILIES = [
    (1, 4, 2, 200, 96, 96, 70),
    (1, 2, 2, 130, 192, 128, None),
    (1, 2, 1, 260, 256, 256, 64),
    (1, 4, 4, 150, 64, 64, None),
]


@pytest.mark.parametrize("B,H,K,S,D,Dv,win", F32_FAMILIES)
def test_flash_f32_tensor_core_design_holds_the_card_tolerance(B, H, K, S, D,
                                                               Dv, win):
    """Three TF32 products per product keep the f32 forward within the
    card check (2e-5 + 2e-5·|ref|) of the plain version on full f32
    inputs; one TF32 rounding of each operand does not."""
    rng = np.random.default_rng(24)
    q, k, v = (_full_f32(rng, B, S, H, D), _full_f32(rng, B, S, K, D),
               _full_f32(rng, B, S, K, Dv))
    ref = flash_attention_plain(q, k, v, window=win)
    bound = 2e-5 + 2e-5 * ref.abs()
    emu = _flash_f32_emulation(q, k, v, window=win)
    assert bool(((emu - ref).abs() <= bound).all())
    once = _flash_f32_emulation(q, k, v, window=win, split=False)
    assert not bool(((once - ref).abs() <= bound).all())


def _flash_bwd_f32_emulation(q, k, v, out, dout, lse, *, window=None,
                             split=True):
    """The f32 backward kernels' arithmetic: S, dP and the products with
    P and dS (dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K) as three TF32 products
    each (``_mm3``; or one rounding each), P = exp2(S·scale·log2 e −
    lse·log2 e) and 0 where masked, D = rowsum(dO ⊙ O) and dS = P ⊙ (dP −
    D)·scale in f32.  Returns dq, dk, dv."""
    B, Sq, H, D = q.shape
    Sk, K, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    log2e = np.log2(np.e)
    qf = q.reshape(B, Sq, K, G, D)
    do = dout.reshape(B, Sq, K, G, Dv)
    delta = (do * out.reshape(B, Sq, K, G, Dv)).sum(-1)
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Sk)[None, :]
    hidden = q_pos < k_pos
    if window is not None:
        hidden = hidden | (q_pos - k_pos >= window)
    s = _mm3("bqkgd,bskd->bkgqs", qf, k, split)
    p = torch.exp2(s * (scale * log2e)
                   - (lse * log2e).reshape(B, K, G, Sq, 1))
    p = torch.where(hidden, torch.zeros(()), p)
    dp = _mm3("bqkgd,bskd->bkgqs", do, v, split)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * scale
    dv = _mm3("bkgqs,bqkgd->bskd", p, do, split)
    dk = _mm3("bkgqs,bqkgd->bskd", ds, qf, split)
    dq = _mm3("bkgqs,bskd->bqkgd", ds, k, split)
    return dq.reshape(B, Sq, H, D), dk, dv


@pytest.mark.parametrize("B,H,K,S,D,Dv,win", F32_FAMILIES)
def test_flash_bwd_f32_tensor_core_design_holds_the_card_tolerance(
        B, H, K, S, D, Dv, win):
    """Three TF32 products per product keep the f32 gradients within the
    card check (2e-5 + 2e-5·|ref|) of the plain version on full f32
    inputs; one TF32 rounding of each operand does not."""
    rng = np.random.default_rng(25)
    q, k, v = (_full_f32(rng, B, S, H, D), _full_f32(rng, B, S, K, D),
               _full_f32(rng, B, S, K, Dv))
    dout = _full_f32(rng, B, S, H, Dv)
    out, lse = flash_attention_plain(q, k, v, window=win, with_lse=True)
    ref = flash_attention_bwd_plain(q, k, v, out, dout, lse, window=win)
    emu = _flash_bwd_f32_emulation(q, k, v, out, dout, lse, window=win)
    once = _flash_bwd_f32_emulation(q, k, v, out, dout, lse, window=win,
                                    split=False)
    for e, r in zip(emu, ref):
        assert bool(((e - r).abs() <= 2e-5 + 2e-5 * r.abs()).all())
    assert not all(bool(((e - r).abs() <= 2e-5 + 2e-5 * r.abs()).all())
                   for e, r in zip(once, ref))


def _mma_m16n8k8(d, a, b):
    """One warp's ``mma.sync.m16n8k8`` on per-lane fragments (32 x 4, 32 x
    4, 32 x 2; lane = 4g + t): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
    (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t, 2t +
    1), d2, d3 (g + 8, the same columns)."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    A, Bm, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for i, (r, c) in enumerate([(g, t), (g + 8, t), (g, t + 4),
                                (g + 8, t + 4)]):
        A[r, c] = a[:, i]
    Bm[t, g], Bm[t + 4, g] = b[:, 0], b[:, 1]
    for i, (r, c) in enumerate([(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                (g + 8, 2 * t + 1)]):
        C[r, c] = d[:, i]
    C = C + A @ Bm
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                     C[g + 8, 2 * t + 1]], axis=1)


def test_f32_kernel_fragments_give_the_products():
    """The f32 kernels' fragment reads (``csrc/hopper.cuh``) on one warp:
    ``frag_a`` and ``frag_b_rows`` give S = Q Kᵀ in C layout;
    ``frag_a_acc`` (the C tile's columns 2t, 2t + 1 as k = t, t + 4) with
    ``frag_b_cols`` (rows 2t, 2t + 1, 16 bytes of a 32-column group) gives
    O = S V, which ``store_group`` writes to the right columns; a row
    stride of 4 mod 32 floats makes every read conflict-free."""
    rng = np.random.default_rng(26)
    D, BK, Dv = 24, 32, 64
    Q, Kt, V = (rng.standard_normal(s) for s in ((16, D), (BK, D),
                                                  (BK, Dv)))
    g, t = np.arange(32) // 4, np.arange(32) % 4
    sc = np.zeros((BK // 8, 32, 4))
    for kk in range(0, D, 8):
        a = np.stack([Q[g, kk + t], Q[g + 8, kk + t], Q[g, kk + t + 4],
                      Q[g + 8, kk + t + 4]], axis=1)
        for j in range(BK // 8):
            b = np.stack([Kt[8 * j + g, kk + t], Kt[8 * j + g, kk + t + 4]],
                         axis=1)
            sc[j] = _mma_m16n8k8(sc[j], a, b)
    S = Q @ Kt.T
    for j in range(BK // 8):
        for e in range(2):
            np.testing.assert_allclose(sc[j][:, e], S[g, 8 * j + 2 * t + e])
            np.testing.assert_allclose(sc[j][:, 2 + e],
                                       S[g + 8, 8 * j + 2 * t + e])
    o = np.zeros((Dv // 32, 4, 32, 4))
    for j in range(BK // 8):
        a = sc[j][:, [0, 2, 1, 3]]                       # frag_a_acc
        for c in range(Dv // 32):
            for i in range(4):                           # frag_b_cols
                b = np.stack([V[8 * j + 2 * t, 32 * c + 4 * g + i],
                              V[8 * j + 2 * t + 1, 32 * c + 4 * g + i]],
                             axis=1)
                o[c][i] = _mma_m16n8k8(o[c][i], a, b)
    out = np.full((16, Dv), np.nan)
    for c in range(Dv // 32):                            # store_group
        for half in range(2):
            for i in range(4):
                out[g + 8 * half, 32 * c + 8 * t + i] = o[c][i][:, 2 * half]
                out[g + 8 * half, 32 * c + 8 * t + 4 + i] = \
                    o[c][i][:, 2 * half + 1]
    np.testing.assert_allclose(out, S @ V, rtol=1e-12, atol=1e-12)
    ld = 32 * 3 + 4                                      # tile_ld(96)
    assert len(set((g * ld + t) % 32)) == 32              # scalar reads
    for quarter in range(4):                             # 16-byte reads
        lanes = np.arange(8 * quarter, 8 * quarter + 8)
        slots = (2 * t[lanes] * ld + 4 * g[lanes]) % 32 // 4
        assert len(set(slots)) == 8


def test_graph_launches_replay_the_f32_routes_apart():
    """A graph that holds f32 flash launches adds them to the f32 routes'
    counters at each replay, beside the wrappers' own; ``per_replay``
    keeps the watched wrappers only."""
    from repro_torch import kernels

    class FakeGraph:
        def replay(self):
            pass

    names = ("flash_attention", "flash_attention_bwd")
    start = kernels.launch_counts(names + kernels.F32_ROUTES)
    counts = kernels.GraphLaunches(names)
    with counts.capture():
        kernels.flash_attention.launches += 3
        kernels.flash_attention.f32_launches += 2
        kernels.flash_attention_bwd.launches += 1
        kernels.flash_attention_bwd.f32_launches += 1
    assert kernels.launch_counts(names + kernels.F32_ROUTES) == start
    assert counts.per_replay == {"flash_attention": 3,
                                 "flash_attention_bwd": 1}
    assert counts.f32_per_replay == {"flash_attention_f32": 2,
                                     "flash_attention_bwd_f32": 1}
    counts.replay(FakeGraph())
    counts.replay(FakeGraph())
    got = kernels.launch_counts(names + kernels.F32_ROUTES)
    assert got == {k: start[k] + 2 * n for k, n in
                   (counts.per_replay | counts.f32_per_replay).items()}
    assert kernels.GraphLaunches(["decode_attention"]).routes == ()
    kernels.flash_attention.launches = start["flash_attention"]
    kernels.flash_attention_bwd.launches = start["flash_attention_bwd"]
    kernels.flash_attention.f32_launches = start["flash_attention_f32"]
    kernels.flash_attention_bwd.f32_launches = start[
        "flash_attention_bwd_f32"]


def _decode_split_emulation(q, k, v, valid_len, splits):
    """The decode kernel's split-and-merge: each row's min(valid_len, S)
    rows (S rows, logits 0, for valid_len 0) cut into `splits` even
    chunks; a partial (m, l, acc) per chunk in f32, an empty chunk
    (-1e30, 0, 0); the partials merged in split order."""
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / np.sqrt(D)
    out = torch.empty((B, H, D))
    for b in range(B):
        vl = int(valid_len[b])
        n = S if vl <= 0 else min(vl, S)
        chunk = -(-n // splits)
        qb = q[b].reshape(K, G, D)
        parts = []
        for sp in range(splits):
            r0 = min(n, sp * chunk)
            r1 = min(n, r0 + chunk)
            if r0 == r1:
                parts.append((torch.full((K, G), -1e30), torch.zeros((K, G)),
                              torch.zeros((K, G, D))))
                continue
            s = torch.einsum("kgd,skd->kgs", qb, k[b, r0:r1]) * scale
            if vl <= 0:
                s = torch.zeros_like(s)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgs,skd->kgd", p, v[b, r0:r1])))
        mt = parts[0][0]
        for m, _, _ in parts[1:]:
            mt = torch.maximum(mt, m)
        lt = torch.zeros((K, G))
        at = torch.zeros((K, G, D))
        for m, lp, ap in parts:
            w = torch.exp(m - mt)
            lt = lt + lp * w
            at = at + ap * w[..., None]
        out[b] = (at / torch.clamp(lt, min=1e-30)[..., None]).reshape(H, D)
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_decode_split_merge_design_equals_the_plain_version(splits):
    """valid_len 0 (mean of V), 1, lengths at and around each split
    boundary, S and past S; chunks past a row's length merge with weight
    0."""
    rng = np.random.default_rng(21)
    S, H, K, D = 48, 6, 2, 32
    lens = sorted({0, 1, 2, S - 1, S, S + 5}
                  | {j * -(-n // splits) + e for n in (S, 17, 9)
                     for j in range(1, splits) for e in (-1, 0, 1)})
    lens = [n for n in lens if n >= 0]
    B = len(lens)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, K, D))
                             .astype(np.float32)) for _ in range(2))
    vl = torch.tensor(lens, dtype=torch.int32)
    torch.testing.assert_close(_decode_split_emulation(q, k, v, vl, splits),
                               decode_attention_plain(q, k, v, vl),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the launch shapes the wrappers pick for csrc/rglru_scan.cu and
# csrc/moe_gating.cu, and the gating kernel's split of the ranking over
# the blocks of a cluster
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,dr,itemsize,sms", [
    (1, 3000, 2560, 4, 132),                # recurrentgemma's long prefill
    (1, 3000, 2560, 2, 132),
    (1, 512, 2560, 4, 132),
    (1, 64, 2560, 4, 132),                  # a short prompt: one tile
    (4, 3000, 2560, 4, 132),                # 320 blocks, 3 an SM
    (4, 37, 2560, 4, 132),
    (1, 1, 96, 4, 132),                     # too few channels: cb 8
    (1, 3000, 1024, 4, 132),                # cb 8 keeps half the SMs busy
    (2, 1541, 2568, 2, 114),
    (4, 3000, 2560, 2, 132),
    (64, 3000, 2560, 4, 132),               # more blocks than fit at once
])
def test_scan_launch_shape_fills_the_card_and_fits(B, S, dr, itemsize, sms):
    sh = scan_launch_shape(B, S, dr, itemsize, sms)
    assert sh.route == "tma"
    assert sh.cb in (8, 16, 32) and sh.cb * itemsize % 16 == 0
    assert sh.blocks == B * -(-dr // sh.cb)
    assert 2 * sh.blocks >= sms or sh.cb == 8     # half the SMs busy
    assert sh.cb == 32 or 2 * B * -(-dr // (2 * sh.cb)) < sms   # widest
    assert sh.rows == S or sh.rows in (128, 64, 32, 16)
    assert sh.rows <= min(S, 128)
    n_tiles = -(-S // sh.rows)
    assert sh.stages == min(3, n_tiles)
    slot = -(-sh.rows * sh.cb * itemsize // 128) * 128
    per_block = (2 * 3 + 2) * slot + 128 + 256 + 1024
    per_sm = -(-sh.blocks // sms)
    assert per_block <= 227 * 1024
    if sh.rows > 16:                      # every block resident at once
        assert per_sm * per_block <= 228 * 1024
        if sh.rows < min(S, 128):        # ... and the longest tile that is
            wider = -(-2 * sh.rows * sh.cb * itemsize // 128) * 128
            assert per_sm * ((2 * 3 + 2) * wider + 1408) > 228 * 1024
    if (B, S, dr, itemsize) == (1, 3000, 2560, 4):
        assert (sh.cb, sh.blocks, sh.rows, sh.stages) == (32, 80, 128, 3)


@pytest.mark.parametrize("dr,itemsize,aligned,route", [
    (2561, 4, True, "simt"),                # row stride 10244 B
    (100, 2, True, "simt"),                 # 200 B
    (37, 4, True, "simt"),
    (2560, 4, False, "simt"),               # an unaligned base
    (1004, 4, True, "tma"),
    (1004, 2, True, "simt"),
    (8, 2, True, "tma"),
])
def test_scan_launch_shape_routes_what_tma_cannot_read(dr, itemsize,
                                                       aligned, route):
    sh = scan_launch_shape(2, 300, dr, itemsize, 132, aligned=aligned)
    assert sh.route == route
    if route == "simt":
        assert (sh.cb, sh.rows, sh.stages) == (0, 0, 0)
        assert sh.blocks == 2 * -(-dr // 64)


@pytest.mark.parametrize("D,Dv,boxes", [
    (16, 16, (1, 1)), (64, 64, (1, 1)),    # the reduced configs; minicpm
    (96, 96, (2, 2)), (128, 128, (2, 2)),  # phi3; llama4, qwen2-vl
    (256, 256, (4, 4)),                    # recurrentgemma
    (192, 128, (3, 2)),                    # deepseek-v2's MLA
])
def test_bwd_launch_shape_fits_every_ported_head_dim(D, Dv, boxes):
    """Every (D, Dv) a ported config trains or serves with has a bf16
    instantiation whose two passes fit a block's 227 KB with a ring of at
    least two stages."""
    sh = bwd_launch_shape(D, Dv, torch.bfloat16)
    assert sh.route == "tc" and sh.boxes == boxes
    box = 64 * 128
    kv, dq = sh.dkdv, sh.dq
    assert (kv.rows, kv.tile, kv.warpgroups) == (64, 64, 3)
    assert 2 <= kv.stages <= 4
    # slack and barriers, K, V and the Pᵀ hand-over; a stage: Q, dO, stats
    kv_fixed, kv_stage = 2048 + sum(boxes) * box + 64 * 64 * 4, \
        sum(boxes) * box + 64 * 8
    assert kv.smem == kv_fixed + kv.stages * kv_stage
    assert dq.tile == 64 and dq.rows == 64 * (dq.warpgroups - 1)
    assert 2 <= dq.stages <= 4
    # slack and barriers, Q and dO; a stage: K, V
    dq_fixed, dq_stage = 2048 + sum(boxes) * dq.rows * 128, sum(boxes) * box
    assert dq.smem == dq_fixed + dq.stages * dq_stage
    for ps, fixed, stage in ((kv, kv_fixed, kv_stage),
                             (dq, dq_fixed, dq_stage)):
        assert ps.smem <= 227 * 1024
        # the ring is as deep as fits, up to 4
        assert ps.stages == 4 or fixed + (ps.stages + 1) * stage > 227 * 1024
    # two dQ warpgroups wherever their 128-row tiles leave two stages
    assert (dq.warpgroups == 3) == (boxes != (4, 4))


@pytest.mark.parametrize("D,Dv", [(64, 128), (128, 64), (256, 128),
                                  (256, 192), (64, 192)])
def test_bwd_launch_shape_refuses_pairs_not_built(D, Dv):
    with pytest.raises(ValueError, match="not built"):
        bwd_launch_shape(D, Dv, torch.bfloat16)
    with pytest.raises(ValueError, match="not built"):
        bwd_launch_shape(64, 64, torch.float16)
    assert bwd_launch_shape(D, Dv, torch.float32).route == "tf32x3"


@pytest.mark.parametrize("D,Dv", [
    (16, 16), (64, 64), (96, 96), (128, 128),   # the ported head dims
    (256, 256), (192, 128),
    (8, 8), (24, 16), (40, 200), (256, 8),      # any multiple of 8 to 256
    (200, 256), (256, 192), (192, 192),
])
def test_bwd_launch_shape_of_the_f32_route(D, Dv):
    """Every (D, Dv) the f32 route takes fits a block's 227 KB in both
    passes, with two stages: dK/dV on 8 kv rows a warp and 32-row q
    tiles, four warps where two such blocks share an SM, else the eight
    that fit; dQ on 16 q rows a warp, four warps and kv tiles of 64 rows,
    else 32, where two such blocks share an SM, else the most warps and
    rows that fit."""
    sh = bwd_launch_shape(D, Dv, torch.float32)
    assert sh.route == "tf32x3"
    ld = [-(-w // 32) * 32 + 4 for w in (D, Dv)]
    assert all(x % 32 == 4 and x >= w for x, w in zip(ld, (D, Dv)))
    w = sum(ld)
    kv, dq = sh.dkdv, sh.dq

    def two_fit(smem):     # two blocks an SM of 228 KB, 1 KB a block
        return 2 * (smem + 1024) <= 228 * 1024

    def kv_smem(rows):     # K, V; a stage: Q, dO, two stats a row; Pᵀ
        return 4 * (rows * w + 2 * (32 * w + 64) + rows * 32)

    def dq_smem(rows, tile):  # Q, dO; a stage: K, V
        return 4 * (rows + 2 * tile) * w

    assert (kv.tile, kv.stages) == (32, 2)
    assert kv.warpgroups in (1, 2) and kv.rows == 32 * kv.warpgroups
    assert kv.smem == kv_smem(kv.rows) <= 227 * 1024
    assert (kv.rows == 64) == (not two_fit(kv_smem(32))
                               and kv_smem(64) <= 227 * 1024)
    assert dq.stages == 2 and dq.tile in (64, 32, 24, 16)
    assert dq.warpgroups in (1, 2) and dq.rows == 64 * dq.warpgroups
    assert dq.smem == dq_smem(dq.rows, dq.tile) <= 227 * 1024
    shared = [(64, 64), (64, 32)]               # two blocks an SM
    order = [(128, 32), (128, 24), (128, 16), (64, 32), (64, 16)]
    if any(two_fit(dq_smem(*s)) for s in shared):
        assert (dq.rows, dq.tile) == next(s for s in shared
                                          if two_fit(dq_smem(*s)))
    else:
        first = order.index((dq.rows, dq.tile))
        assert all(dq_smem(*s) > 227 * 1024 for s in order[:first])
    # 64-row tiles are built for max(D, Dv) up to 96, 24-row past 128
    assert dq.tile != 64 or max(D, Dv) <= 96
    assert dq.tile != 24 or max(D, Dv) > 128
    if (D, Dv) == (192, 128):                   # MLA: both passes at 8 warps
        assert (kv.rows, dq.rows, dq.tile) == (64, 128, 24)
    if (D, Dv) == (64, 64):                     # minicpm: two blocks of 4
        assert (kv.rows, dq.rows, dq.tile) == (32, 64, 64)


@pytest.mark.parametrize("max_blocks", [8, 16])
@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 64, 100, 255, 256, 257,
                               512, 513, 1023, 1024, 1025, 4096, 100000])
def test_gating_launch_shape(T, max_blocks):
    nb, threads = gating_launch_shape(T, max_blocks)
    assert 1 <= nb <= max_blocks and threads % 32 == 0
    assert 32 <= threads <= 1024
    Tb = -(-T // nb)
    if T <= 32:
        assert (nb, threads) == (1, 32 * T)       # a warp per token
    else:
        assert nb == min(max_blocks, -(-T // 32))
        assert threads // 32 == min(32, Tb)
    assert all(r * Tb < T for r in range(nb))     # no block without tokens
    if T <= max_blocks * 32:
        assert threads // 32 >= Tb                # one token per warp


def _gating_cluster_emulation(logits, k, C, nb, threads):
    """The gating kernel's ranking: block r owns tokens [r·Tb, (r+1)·Tb);
    each block counts its entries per expert; a block's offsets are the
    counts of the lower-ranked blocks added in rank order; then it walks
    its own entries in tiles of `threads`, an entry's position being the
    offset plus the earlier entries of its expert in the block."""
    T, E = logits.shape
    eids, gates, _, _ = moe_gating_plain(logits, top_k=k, capacity=C)
    Tb = -(-T // nb)
    flat = eids.reshape(-1).tolist()
    hists = []
    for r in range(nb):
        h = [0] * E
        for e in flat[min(T, r * Tb) * k:min(T, (r + 1) * Tb) * k]:
            h[e] += 1
        hists.append(h)
    slots, keep = [0] * len(flat), [False] * len(flat)
    for r in range(nb):
        running = [sum(hists[q][e] for q in range(r)) for e in range(E)]
        n0, n1 = min(T, r * Tb) * k, min(T, (r + 1) * Tb) * k
        for t0 in range(n0, n1, threads):
            tile = flat[t0:min(n1, t0 + threads)]
            for i, e in enumerate(tile):
                pos = running[e] + tile[:i].count(e)
                keep[t0 + i] = pos < C
                slots[t0 + i] = e * C + (pos if pos < C else 0)
            for e in tile:
                running[e] += 1
    return (eids, gates, torch.tensor(slots, dtype=torch.int32).reshape(T, k),
            torch.tensor(keep).reshape(T, k))


@pytest.mark.parametrize("max_blocks", [8, 16])
@pytest.mark.parametrize("T,E,k,C,tied", [
    (1, 128, 1, 8, False),                  # a decode step: one block
    (33, 16, 2, 8, False),                  # two blocks
    (512, 128, 1, 8, False),                # llama4's prefill
    (600, 8, 2, 150, False),                # experts span every block
    (512, 4, 1, 64, False),                 # C = whole blocks of tokens
    (700, 16, 4, 24, True),                 # ties across blocks
    (2500, 8, 2, 300, False),               # several tiles per block
])
def test_gating_cluster_ranking_equals_the_plain_version(T, E, k, C, tied,
                                                         max_blocks):
    rng = np.random.default_rng(T + E)
    if tied:
        logits = rng.integers(0, 3, (T, E)).astype(np.float32)
    else:
        logits = (rng.standard_normal((T, E)) * 3).astype(np.float32)
    logits = torch.from_numpy(logits)
    nb, threads = gating_launch_shape(T, max_blocks)
    got = _gating_cluster_emulation(logits, k, C, nb, threads)
    want = moe_gating_plain(logits, top_k=k, capacity=C)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
