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
from repro_torch.kernels import (decode_attention, decode_attention_plain,  # noqa: E402
                                 flash_attention, flash_attention_plain,
                                 moe_gating, moe_gating_plain, rglru_scan,
                                 rglru_scan_plain)

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
    q: (B, Sq, H, D), k/v: (B, Sk, K, D), bf16 values; returns f32."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    c = (1.0 / np.sqrt(D)) * np.log2(np.e)
    qf = q.float().reshape(B, Sq, K, G, D)
    kf, vf = k.float(), v.float()
    neg = torch.tensor(-1e30)
    m = torch.full((B, K, G, Sq), -1e30)
    l = torch.zeros((B, K, G, Sq))
    acc = torch.zeros((B, K, G, Sq, D))
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
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


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
