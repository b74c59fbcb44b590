"""The port's attention kernels, as they run on the CPU (their plain
PyTorch versions), against the JAX package's Pallas kernels in interpret
mode and their pure-jnp references, on the same numpy inputs."""
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
from repro.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels import (decode_attention, decode_attention_plain,  # noqa: E402
                                 flash_attention, flash_attention_plain)

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


def test_cpu_wrappers_compute_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(np.float32))
    f0, d0 = flash_attention.launches, decode_attention.launches
    torch.testing.assert_close(flash_attention(q, kv, kv),
                               flash_attention_plain(q, kv, kv))
    vl = torch.tensor([4], dtype=torch.int32)
    torch.testing.assert_close(decode_attention(q[:, 0], kv, kv, vl),
                               decode_attention_plain(q[:, 0], kv, kv, vl))
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)


def test_wrappers_reject_mismatched_shapes():
    q = torch.zeros((1, 4, 4, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 4, 3, 16)), torch.zeros((1, 4, 3, 16)))
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], torch.zeros((1, 4, 2, 16)),
                         torch.zeros((1, 4, 2, 16)),
                         torch.zeros((2,), dtype=torch.int32))
