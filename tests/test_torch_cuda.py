"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the decision is made inside the ``cuda`` fixture, never at import.
Run them on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (decode_attention, decode_attention_plain,  # noqa: E402
                                 flash_attention, flash_attention_bwd,
                                 flash_attention_bwd_plain,
                                 flash_attention_plain, moe_gating,
                                 moe_gating_plain, rglru_scan, rglru_scan_bwd,
                                 rglru_scan_bwd_plain, rglru_scan_plain)
from repro_torch.kernels.moe_gating.ops import (  # noqa: E402
    gating_launch_shape, max_cluster_blocks)
from repro_torch.kernels.rglru_scan.ops import (TILE_ROWS,  # noqa: E402
                                                scan_launch_shape)

pytestmark = pytest.mark.cuda

#: kernel vs the plain version on f32 copies of the same inputs, keyed by
#: the kernel's output type: f32 sums in another order (2e-5, as the JAX
#: package's kernel sweeps), and for a bf16 output one rounding to nearest,
#: at most 2^-8 of the value
TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-5),
        torch.bfloat16: dict(rtol=2.0 ** -8, atol=2e-5)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(rng, shape, dtype, device):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=device).to(dtype)


def _close(out, ref, dtype):
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


def _f32(*ts):
    return [t.float() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,win", [
    (2, 4, 2, 256, 64, None),
    (1, 4, 1, 100, 32, None),        # MQA + ragged seq
    (2, 2, 2, 128, 16, 48),          # sliding window
    (1, 8, 8, 64, 128, None),        # MHA, head dim 128
    (1, 32, 32, 300, 96, None),      # phi3-mini heads, ragged prompt
    (1, 32, 8, 200, 128, None),      # GQA
    (1, 40, 8, 512, 128, None),      # llama4's prefill: G 5
    (1, 10, 1, 300, 256, 128),       # recurrentgemma: MQA, D 256, window
    (2, 10, 1, 150, 256, None),
    (1, 4, 2, 70, 200, None),        # D between 128 and 256
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, K, S, D, win):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, S, H, D), dtype, cuda)
    k = _randn(rng, (B, S, K, D), dtype, cuda)
    v = _randn(rng, (B, S, K, D), dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(out, flash_attention_plain(*_f32(q, k, v), window=win), dtype)


# the last three families' shapes: deepseek-v2's MLA (q/k 192, v 128, at
# its scale 1/sqrt(192)), qwen2-vl's GQA (G 7) and musicgen's MHA at D 64
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,Dv", [
    (1, 128, 128, 300, 192, 128),     # deepseek-v2 prefill
    (1, 8, 8, 129, 192, 128),         # one row past a q tile
    (2, 8, 2, 200, 192, 128),         # GQA at Dv != D
    (1, 4, 4, 70, 24, 16),            # the reduced MLA
    (1, 28, 4, 333, 128, 128),        # qwen2-vl
    (1, 32, 32, 260, 64, 64),         # musicgen
])
def test_flash_kernel_takes_the_late_families_shapes(cuda, dtype, B, H, K, S,
                                                     D, Dv):
    rng = np.random.default_rng(14)
    q, k = (_randn(rng, (B, S, n, D), dtype, cuda) for n in (H, K))
    v = _randn(rng, (B, S, K, Dv), dtype, cuda)
    scale = 1.0 / np.sqrt(D)
    before = flash_attention.launches
    out = flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.shape == (B, S, H, Dv)
    _close(out, flash_attention_plain(*_f32(q, k, v), scale=scale), dtype)


def test_flash_kernel_refuses_a_box_pair_it_is_not_built_for(cuda):
    """bf16 is instantiated for the served (D, Dv) box pairs only: D = Dv
    = 192 (three boxes each) is refused before launch; f32 takes it."""
    q = torch.zeros((1, 64, 2, 192), device=cuda)
    v = torch.zeros((1, 64, 2, 192), device=cuda)
    assert flash_attention(q, q, v).shape == (1, 64, 2, 192)
    with pytest.raises(ValueError, match="not built"):
        flash_attention(q.bfloat16(), q.bfloat16(), v.bfloat16())


def test_flash_kernel_reads_a_cache_slice_in_place(cuda):
    """Prefill reads k/v as a strided slice of the (B, max_seq, K, D)
    cache; the kernel must honor the strides."""
    rng = np.random.default_rng(1)
    S, max_seq = 77, 256
    q = _randn(rng, (1, S, 32, 96), torch.bfloat16, cuda)
    kc = _randn(rng, (1, max_seq, 32, 96), torch.bfloat16, cuda)
    vc = _randn(rng, (1, max_seq, 32, 96), torch.bfloat16, cuda)
    out = flash_attention(q, kc[:, :S], vc[:, :S])
    ref = flash_attention_plain(*_f32(q, kc[:, :S], vc[:, :S]))
    _close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D", [
    (2, 8, 2, 256, 64),
    (1, 4, 4, 100, 32),
    (3, 2, 1, 64, 16),
    (1, 32, 32, 1024, 96),           # phi3-mini decode
    (2, 24, 4, 200, 128),            # 6 query heads per kv head
    (1, 10, 1, 2048, 256),           # recurrentgemma: G 10, D 256
    (3, 20, 2, 300, 256),
    (2, 40, 8, 500, 128),            # llama4: G 5
    (1, 36, 2, 100, 200),            # G 18, D 200
    (16, 10, 1, 256, 256),           # 5 heads a block (MAXG 8), D 256
    (3, 24, 4, 300, 128),            # 3 heads a block (MAXG 4)
    (4, 40, 8, 500, 128),            # llama4 at batch 4: 5 heads a block
])
def test_decode_kernel_matches_plain(cuda, dtype, B, H, K, S, D):
    rng = np.random.default_rng(2)
    q = _randn(rng, (B, H, D), dtype, cuda)
    k = _randn(rng, (B, S, K, D), dtype, cuda)
    v = _randn(rng, (B, S, K, D), dtype, cuda)
    vl = torch.tensor([max(1, S - 7 * i) for i in range(B)],
                      dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _close(out, decode_attention_plain(*_f32(q, k, v), vl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,Dv,lens", [
    (1, 128, 128, 1024, 192, 128, [517]),          # deepseek-v2 decode
    (1, 128, 128, 1024, 192, 128, [1]),
    (4, 16, 4, 300, 192, 128, [300, 100, 33, 0]),  # GQA, valid_len 0
    (2, 4, 4, 64, 24, 16, [64, 9]),                # the reduced MLA
    (1, 28, 4, 1024, 128, 128, [517]),             # qwen2-vl: G 7
    (1, 32, 32, 1024, 64, 64, [517]),              # musicgen
    (2, 8, 2, 200, 64, 136, [200, 51]),            # Dv > D: a whole warp
])
def test_decode_kernel_takes_the_late_families_shapes(cuda, dtype, B, H, K,
                                                      S, D, Dv, lens):
    rng = np.random.default_rng(15)
    q = _randn(rng, (B, H, D), dtype, cuda)
    k = _randn(rng, (B, S, K, D), dtype, cuda)
    v = _randn(rng, (B, S, K, Dv), dtype, cuda)
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    scale = 1.0 / np.sqrt(D)
    before = decode_attention.launches
    out = decode_attention(q, k, v, vl, scale=scale)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.shape == (B, H, Dv)
    _close(out, decode_attention_plain(*_f32(q, k, v), vl, scale=scale),
           dtype)


def test_decode_kernel_valid_len_edges(cuda):
    """valid_len 0 averages V over the cache (the TPU kernel's -1e30 mask);
    valid_len past the cache clamps to it; 1 reads row 0 alone."""
    rng = np.random.default_rng(3)
    B, H, K, S, D = 4, 8, 4, 64, 32
    q = _randn(rng, (B, H, D), torch.float32, cuda)
    k = _randn(rng, (B, S, K, D), torch.float32, cuda)
    v = _randn(rng, (B, S, K, D), torch.float32, cuda)
    vl = torch.tensor([0, 1, S, S + 9], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, vl)
    _close(out, decode_attention_plain(q, k, v, vl), torch.float32)
    mean_v = v[0].mean(0).repeat_interleave(H // K, dim=0)
    _close(out[0], mean_v, torch.float32)
    _close(out[1], v[1, 0].repeat_interleave(H // K, dim=0), torch.float32)


# the bf16 flash kernel's tile edges: q tiles of 128 rows, kv tiles of 64,
# boxes of 64 columns that TMA zero-fills past D
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,D,win,causal", [
    (1, 4, 2, 129, 64, None, True),     # one row past a q tile
    (2, 4, 4, 200, 128, None, True),    # a half-filled last q tile
    (1, 2, 1, 1, 64, None, True),       # a single query row
    (1, 4, 1, 300, 64, 64, True),       # window edge on a kv-tile boundary
    (1, 2, 2, 256, 128, 128, True),     # ... and on a q-tile boundary
    (1, 2, 1, 333, 96, 65, True),       # window one past a tile
    (1, 4, 2, 150, 8, None, True),      # D 8: one box, 56 zero columns
    (1, 8, 8, 190, 96, 100, True),      # D 96: 64 + 32 zero-filled
    (1, 4, 4, 130, 200, 64, True),      # D 200: four boxes, the last 8 wide
    (2, 4, 2, 140, 64, None, False),    # no causal mask
    (1, 5, 1, 260, 256, None, False),
])
def test_flash_kernel_tile_edges(cuda, dtype, B, H, K, Sq, D, win, causal):
    rng = np.random.default_rng(7)
    q = _randn(rng, (B, Sq, H, D), dtype, cuda)
    k = _randn(rng, (B, Sq, K, D), dtype, cuda)
    v = _randn(rng, (B, Sq, K, D), dtype, cuda)
    out = flash_attention(q, k, v, window=win, causal=causal)
    ref = flash_attention_plain(*_f32(q, k, v), window=win, causal=causal)
    _close(out, ref, dtype)


# a prompt at a cache offset (chunked prefill): query row i sits at key
# position q_offset + i; k and v are the cache's first rows, read in place
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Sk,off,D,Dv,win", [
    (1, 32, 32, 312, 512, 200, 96, 96, None),    # phi3: chunk 2 of 200 + 312
    (2, 4, 2, 100, 230, 130, 64, 64, None),      # Sk not a multiple of 64
    (2, 4, 2, 100, 230, 7, 64, 64, None),        # keys past the last row
    (1, 8, 8, 129, 300, 171, 192, 128, None),    # MLA dims, a row past a tile
    (1, 4, 1, 70, 333, 263, 256, 256, 100),      # window inside the keys
    (1, 2, 2, 150, 190, 40, 128, 128, 64),       # window across q tiles
    (1, 4, 2, 2, 65, 63, 64, 64, None),          # two rows at the end
    (1, 4, 2, 64, 64, 0, 64, 64, None),          # offset 0
])
def test_flash_kernel_at_a_q_offset_matches_plain(cuda, dtype, B, H, K, Sq,
                                                  Sk, off, D, Dv, win):
    rng = np.random.default_rng(15)
    q = _randn(rng, (B, Sq, H, D), dtype, cuda)
    kc = _randn(rng, (B, Sk + 40, K, D), dtype, cuda)      # a longer cache
    vc = _randn(rng, (B, Sk + 40, K, Dv), dtype, cuda)
    k, v = kc[:, :Sk], vc[:, :Sk]
    scale = 1.0 / np.sqrt(D)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, window=win, scale=scale, q_offset=off,
                               with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_plain(*_f32(q, k, v), window=win,
                                         scale=scale, q_offset=off,
                                         with_lse=True)
    _close(out, ref, dtype)
    _close(lse, ref_lse, torch.float32)
    assert torch.equal(flash_attention(q, k, v, window=win, scale=scale,
                                       q_offset=off), out)


def test_flash_kernel_at_a_q_offset_has_no_backward(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, requires_grad=True)
    kv = torch.zeros((1, 12, 2, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="q offset"):
        flash_attention(q, kv, kv, q_offset=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_heads(cuda, dtype):
    """q, k and v as views of one fused projection (row stride (H + 2K)·D,
    not H·D) and k/v as a slice of a larger cache: the TMA maps take the
    strides as they are."""
    rng = np.random.default_rng(8)
    B, S, H, K, D = 2, 150, 8, 2, 96
    qkv = _randn(rng, (B, S, (H + 2 * K) * D), dtype, cuda)
    q = qkv[..., :H * D].unflatten(-1, (H, D))
    k = qkv[..., H * D:(H + K) * D].unflatten(-1, (K, D))
    v = qkv[..., (H + K) * D:].unflatten(-1, (K, D))
    assert q.stride(1) == (H + 2 * K) * D
    _close(flash_attention(q, k, v, window=70),
           flash_attention_plain(*_f32(q, k, v), window=70), dtype)
    kc = _randn(rng, (B, 512, 2 * K, D), dtype, cuda)[:, :S, 1:1 + K]
    vc = _randn(rng, (B, 512, 2 * K, D), dtype, cuda)[:, :S, 1:1 + K]
    _close(flash_attention(q, kc, vc), flash_attention_plain(
        *_f32(q, kc, vc)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", [0.3, -0.2])
def test_flash_kernel_takes_any_scale(cuda, dtype, scale):
    """The bf16 kernel folds a positive scale into its exp2 after the
    max; another scale goes through the explicitly scaled path."""
    rng = np.random.default_rng(13)
    q = _randn(rng, (1, 200, 4, 64), dtype, cuda)
    k = _randn(rng, (1, 200, 2, 64), dtype, cuda)
    v = _randn(rng, (1, 200, 2, 64), dtype, cuda)
    _close(flash_attention(q, k, v, scale=scale),
           flash_attention_plain(*_f32(q, k, v), scale=scale), dtype)


def test_flash_kernel_rejects_what_tma_cannot_read(cuda):
    """bf16 goes through TMA: a stride that is not a multiple of 8
    elements is refused before launch (f32 takes it)."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 16, 4, 12), dtype=dtype, device=cuda)[..., :8]
        assert q.stride(2) == 12
        if dtype == torch.float32:
            assert flash_attention(q, q, q).shape == (1, 16, 4, 8)
        else:
            with pytest.raises(ValueError):
                flash_attention(q, q, q)


def test_flash_kernel_repeats_bit_identically(cuda):
    rng = np.random.default_rng(9)
    q = _randn(rng, (1, 300, 10, 256), torch.bfloat16, cuda)
    k = _randn(rng, (1, 300, 1, 256), torch.bfloat16, cuda)
    v = _randn(rng, (1, 300, 1, 256), torch.bfloat16, cuda)
    a = flash_attention(q, k, v, window=128)
    b = flash_attention(q, k, v, window=128)
    assert torch.equal(a, b)


@pytest.mark.parametrize("Dv", [40, 96])
def test_flash_f32_kernel_reads_rows_not_on_16_bytes(cuda, Dv):
    """The f32 kernel copies 16 bytes at a time where every row of q, k
    and v starts on 16 bytes, else 4 at a time (the same kernel's other
    instance): a head stride of 2 mod 4 floats, and a base one float past
    an aligned one, give the plain version's result; both count as f32
    route launches."""
    rng = np.random.default_rng(30)
    B, S, H, K, D = 2, 140, 6, 2, 40
    q = _randn(rng, (B, S, H, D + 2), torch.float32, cuda)[..., :D]
    assert q.stride(2) % 4 == 2
    k = _randn(rng, (B * S * K * D + 1,), torch.float32, cuda)[1:].view(
        B, S, K, D)
    assert k.data_ptr() % 16 == 4
    v = _randn(rng, (B, S, K, Dv), torch.float32, cuda)
    before = (flash_attention.launches, flash_attention.f32_launches)
    for win in (None, 50):
        _close(flash_attention(q, k, v, window=win),
               flash_attention_plain(q, k, v, window=win), torch.float32)
    assert (flash_attention.launches, flash_attention.f32_launches) == (
        before[0] + 2, before[1] + 2)


def test_f32_route_rounds_to_tf32_as_cvt_rna_does(cuda):
    """The f32 flash kernels round to TF32 with two integer instructions
    (csrc/hopper.cuh ``to_tf32``): over all 2^32 f32 bit patterns, every
    finite one rounds as ``cvt.rna.tf32.f32`` rounds it."""
    import ctypes

    from repro_torch.kernels._build import function
    fn = function("flash_attention", "flash_attention_tf32_mismatches",
                  [ctypes.c_void_p, ctypes.c_void_p])
    n = torch.zeros(1, dtype=torch.int64, device=cuda)
    assert fn(n.data_ptr(), torch.cuda.current_stream(cuda).cuda_stream) == 0
    torch.cuda.synchronize()
    assert int(n) == 0


def test_flash_f32_backward_repeats_bit_identically(cuda):
    """The f32 backward (three passes, the GQA partials summed in head
    order, no atomics) gives the same bits every time."""
    rng = np.random.default_rng(31)
    B, H, K, S, D = 2, 12, 3, 300, 64
    q = _randn(rng, (B, S, H, D), torch.float32, cuda)
    k, v = (_randn(rng, (B, S, K, D), torch.float32, cuda) for _ in "kv")
    dout = _randn(rng, (B, S, H, D), torch.float32, cuda)
    out, lse = flash_attention(q, k, v, window=100, with_lse=True)
    before = flash_attention_bwd.f32_launches
    first = flash_attention_bwd(q, k, v, out, dout, lse, window=100)
    for _ in range(3):
        again = flash_attention_bwd(q, k, v, out, dout, lse, window=100)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert flash_attention_bwd.f32_launches == before + 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens", [
    # 2 splits of the rows: every valid_len from 0 to past S
    (64, list(range(0, 66))),
    # 8 splits: 0, 1, S and the lengths around each split boundary
    (256, [0, 1, 2, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128,
           129, 223, 224, 225, 255, 256]),
])
def test_decode_kernel_valid_len_at_split_boundaries(cuda, dtype, S, lens):
    rng = np.random.default_rng(10)
    B, H, K, D = len(lens), 4, 1, 64
    q = _randn(rng, (B, H, D), dtype, cuda)
    k = _randn(rng, (B, S, K, D), dtype, cuda)
    v = _randn(rng, (B, S, K, D), dtype, cuda)
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    _close(decode_attention(q, k, v, vl),
           decode_attention_plain(*_f32(q, k, v), vl), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,S,D", [
    (32, 32, 1024, 96),              # phi3-mini
    (10, 1, 2048, 256),              # recurrentgemma's ring
    (40, 8, 1024, 128),              # llama4
])
def test_decode_kernel_mixed_batch(cuda, dtype, H, K, S, D):
    """Rows of one batch end in different splits; rows past each one's
    valid_len are never read (NaN there would show)."""
    rng = np.random.default_rng(11)
    lens = [S, 517, 64, 1]
    q = _randn(rng, (4, H, D), dtype, cuda)
    k = _randn(rng, (4, S, K, D), dtype, cuda)
    v = _randn(rng, (4, S, K, D), dtype, cuda)
    for i, n in enumerate(lens):
        k[i, n:] = float("nan")
        v[i, n:] = float("nan")
    vl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, vl)
    ref = decode_attention_plain(*_f32(q, k.nan_to_num(), v.nan_to_num()),
                                 vl)
    _close(out, ref, dtype)


def test_decode_kernel_repeats_bit_identically(cuda):
    """The splits merge in a fixed order: the same bits every launch, and
    on two streams at once."""
    rng = np.random.default_rng(12)
    q = _randn(rng, (1, 10, 256), torch.bfloat16, cuda)
    k = _randn(rng, (1, 2048, 1, 256), torch.bfloat16, cuda)
    v = _randn(rng, (1, 2048, 1, 256), torch.bfloat16, cuda)
    vl = torch.tensor([1999], dtype=torch.int32, device=cuda)
    first = decode_attention(q, k, v, vl)
    assert torch.equal(first, decode_attention(q, k, v, vl))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append([decode_attention(q, k, v, vl) for _ in range(4)])
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for run in outs for o in run)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,dr", [
    (1, 512, 2560),                  # recurrentgemma prefill
    (4, 37, 96),                     # ragged time and channels
    (2, 100, 64),
])
def test_rglru_scan_kernel_matches_plain(cuda, dtype, B, S, dr):
    """The kernel rounds each step as the plain version does: f32 is
    exact, bf16 one rounding of the same f32 value."""
    rng = np.random.default_rng(5)
    x = _randn(rng, (B, S, dr), dtype, cuda)
    a = torch.sigmoid(_randn(rng, (B, S, dr), torch.float32, cuda)).to(dtype)
    h0 = _randn(rng, (B, dr), torch.float32, cuda)
    before = rglru_scan.launches
    out = rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out, rglru_scan_plain(x, a, h0), rtol=0,
                               atol=0)


@pytest.mark.parametrize("T,E,k,C", [
    (1, 128, 1, 8),                  # llama4 decode
    (512, 128, 1, 8),                # llama4 prefill
    (4096, 160, 6, 64),              # deepseek-v2 routing, drops
    (1, 160, 6, 8),                  # deepseek-v2 decode
    (512, 160, 6, 24),               # deepseek-v2 prefill
    (100, 8, 2, 16),
    (3000, 4, 2, 8),                 # many tiles of entries per expert
])
def test_moe_gating_kernel_matches_plain(cuda, T, E, k, C):
    rng = np.random.default_rng(T)
    logits = _randn(rng, (T, E), torch.float32, cuda) * 3
    before = moe_gating.launches
    got = moe_gating(logits, top_k=k, capacity=C)
    torch.cuda.synchronize()
    assert moe_gating.launches == before + 1
    _gating_equal(got, moe_gating_plain(logits, top_k=k, capacity=C))


def test_moe_gating_kernel_ties_take_the_lower_expert(cuda):
    rng = np.random.default_rng(6)
    logits = torch.tensor(rng.integers(0, 3, (700, 64)), dtype=torch.float32,
                          device=cuda)
    _gating_equal(moe_gating(logits, top_k=4, capacity=24),
                  moe_gating_plain(logits, top_k=4, capacity=24))


# the scan's time tiles (TILE_ROWS steps) and its ring of stages
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,dr,route", [
    (1, 1, 2560, "tma"),                     # one step
    (1, TILE_ROWS - 1, 2560, "tma"),         # one tile, one short
    (1, TILE_ROWS, 2560, "tma"),             # exactly one tile
    (1, TILE_ROWS + 1, 2560, "tma"),         # a second tile of one step
    (1, 12 * TILE_ROWS + 5, 2560, "tma"),    # 13 tiles: the ring wraps
    (1, 3000, 2560, "tma"),                  # recurrentgemma's prefill
    (1, 300, 2568, "tma"),                   # dr not a multiple of cb
    (2, 77, 1004, "tma"),                    # ... at cb 16
    (4, 300, 2560, "tma"),                   # blocks share SMs: 64 steps
    (1, 200, 2561, "simt"),              # row stride not 16-byte aligned
    (3, 50, 37, "simt"),
])
def test_rglru_scan_kernel_tile_edges(cuda, dtype, B, S, dr, route):
    """Bit for bit the plain version (f32 exact, bf16 one rounding of the
    same value) on both routes, at the tile and ring edges."""
    shape = scan_launch_shape(B, S, dr, dtype.itemsize, _sms(cuda))
    assert shape.route == ("tma" if dr * dtype.itemsize % 16 == 0
                           else "simt")
    assert dtype == torch.bfloat16 or shape.route == route
    if S == 12 * TILE_ROWS + 5:
        assert 13 >= 2 * shape.stages + 1
    rng = np.random.default_rng(S + dr)
    x = _randn(rng, (B, S, dr), dtype, cuda)
    a = torch.sigmoid(_randn(rng, (B, S, dr), torch.float32, cuda)).to(dtype)
    h0 = _randn(rng, (B, dr), torch.float32, cuda)
    out = rglru_scan(x, a, h0)
    torch.testing.assert_close(out, rglru_scan_plain(x, a, h0), rtol=0,
                               atol=0)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_kernel_takes_an_unaligned_base(cuda, dtype):
    """x and a one element into their buffers: not 16-byte aligned, so
    the thread-per-channel kernel reads them; the result is the same
    bits."""
    rng = np.random.default_rng(17)
    B, S, dr = 2, 130, 256
    n = B * S * dr
    x = _randn(rng, (n + 1,), dtype, cuda)[1:].view(B, S, dr)
    a = torch.sigmoid(_randn(rng, (n + 1,), torch.float32, cuda)).to(
        dtype)[1:].view(B, S, dr)
    assert x.data_ptr() % 16 and x.is_contiguous()
    h0 = _randn(rng, (B, dr), torch.float32, cuda)
    torch.testing.assert_close(rglru_scan(x, a, h0),
                               rglru_scan_plain(x, a, h0), rtol=0, atol=0)


def test_rglru_scan_kernel_repeats_bit_identically(cuda):
    """The same bits every launch, and on two streams at once."""
    rng = np.random.default_rng(18)
    x = _randn(rng, (1, 1000, 2560), torch.bfloat16, cuda)
    a = torch.sigmoid(_randn(rng, (1, 1000, 2560), torch.float32,
                             cuda)).to(torch.bfloat16)
    h0 = _randn(rng, (1, 2560), torch.float32, cuda)
    first = rglru_scan(x, a, h0)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append([rglru_scan(x, a, h0) for _ in range(4)])
    torch.cuda.synchronize()
    assert all(torch.equal(first, o) for run in outs for o in run)


# the gating kernel's launch edges: one block up to 32 tokens, then a
# cluster of up to 8 or 16 blocks of up to 32 warps (a warp per token up
# to 256 or 512 tokens)
@pytest.mark.parametrize("T", [1, 31, 32, 33, 256, 257, 512, 513, 1023, 1024,
                               1025])
@pytest.mark.parametrize("E,k,C", [(128, 1, 8), (64, 3, 40)])
def test_moe_gating_kernel_launch_edges(cuda, T, E, k, C):
    rng = np.random.default_rng(T + E)
    logits = _randn(rng, (T, E), torch.float32, cuda) * 3
    _gating_equal(moe_gating(logits, top_k=k, capacity=C),
                  moe_gating_plain(logits, top_k=k, capacity=C))


def test_moe_gating_kernel_expert_spans_blocks(cuda):
    """One expert wins tokens 50-400, over several blocks' ranges: its
    positions run on across the blocks, and the capacity cuts it in a
    block in the middle."""
    T, E, k = 600, 32, 2
    nb, _ = gating_launch_shape(T, max_cluster_blocks())
    assert nb >= 8 and -(-T // nb) < 350
    rng = np.random.default_rng(19)
    logits = _randn(rng, (T, E), torch.float32, cuda)
    logits[50:400, 3] += 10.0
    for C in (40, 200, 400):
        got = moe_gating(logits, top_k=k, capacity=C)
        _gating_equal(got, moe_gating_plain(logits, top_k=k, capacity=C))
    assert int(got[3][:, 0].sum()) == T    # C 400: every first entry kept


@pytest.mark.parametrize("blocks_kept", [1, 2, 7])
def test_moe_gating_kernel_capacity_on_a_block_boundary(cuda, blocks_kept):
    """Every token routes to expert 0 first; C is a whole number of
    blocks' tokens, so the last kept entry is a block's last."""
    T, E, k = 512, 16, 1
    nb, _ = gating_launch_shape(T, max_cluster_blocks())
    Tb = -(-T // nb)
    rng = np.random.default_rng(20)
    logits = _randn(rng, (T, E), torch.float32, cuda)
    logits[:, 0] += 20.0
    C = blocks_kept * Tb
    got = moe_gating(logits, top_k=k, capacity=C)
    _gating_equal(got, moe_gating_plain(logits, top_k=k, capacity=C))
    assert got[3][:, 0].tolist() == [t < C for t in range(T)]


def test_moe_gating_kernel_ties_across_blocks(cuda):
    """Logits of three values: ties everywhere, ranked over 8 or 16
    blocks."""
    rng = np.random.default_rng(21)
    logits = torch.tensor(rng.integers(0, 3, (1500, 64)), dtype=torch.float32,
                          device=cuda)
    assert gating_launch_shape(1500, max_cluster_blocks())[0] >= 8
    for k, C in ((4, 24), (8, 200)):
        _gating_equal(moe_gating(logits, top_k=k, capacity=C),
                      moe_gating_plain(logits, top_k=k, capacity=C))


def test_moe_gating_kernel_repeats_bit_identically(cuda):
    """The same bits every launch, and on two streams at once."""
    rng = np.random.default_rng(22)
    logits = _randn(rng, (4096, 160), torch.float32, cuda) * 3
    first = moe_gating(logits, top_k=6, capacity=64)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in range(2)]
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append([moe_gating(logits, top_k=6, capacity=64)
                         for _ in range(4)])
    torch.cuda.synchronize()
    for run in outs:
        for got in run:
            assert all(torch.equal(f, g) for f, g in zip(first, got))


def _gating_equal(got, want):
    eids, gates, slots, keep = got
    torch.testing.assert_close(eids, want[0], rtol=0, atol=0)
    torch.testing.assert_close(slots, want[2], rtol=0, atol=0)
    torch.testing.assert_close(keep, want[3], rtol=0, atol=0)
    torch.testing.assert_close(gates, want[1], rtol=0, atol=1e-6)


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 4, 2, 12), device=cuda)       # head dim 12
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    q16 = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q16, q16.bfloat16(), q16)     # mixed dtypes
    with pytest.raises(ValueError):
        decode_attention(q16[:, 0], q16, q16,
                         torch.ones(1, dtype=torch.int64, device=cuda))
    x = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        rglru_scan(x, x, torch.zeros((1, 8), device=cuda).bfloat16())
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((4, 300), device=cuda), top_k=1, capacity=8)
    with pytest.raises(ValueError):
        moe_gating(torch.zeros((4, 8), device=cuda).bfloat16(), top_k=1,
                   capacity=8)


# ---------------------------------------------------------------------------
# the runtime on the card: pinned pulls on the copy stream, kernels on the
# compute stream after their inputs' events, pushes and spills after the
# producer's event
# ---------------------------------------------------------------------------
def test_executor_saxpy_repeats_on_cuda_streams(cuda):
    from repro_torch.core import Executor, Heteroflow
    N = 1 << 22
    x = np.zeros(N, np.float32)
    y = np.zeros(N, np.float32)
    G = Heteroflow("saxpy")
    hx = G.host(lambda: x.__setitem__(slice(None), 1.0))
    hy = G.host(lambda: y.__setitem__(slice(None), 2.0))
    px, py = G.pull(x), G.pull(y)
    k = G.kernel(lambda a, xs, ys: a * xs + ys, 2.0, px, py, writes=(py,))
    push = G.push(py, y)
    hx.precede(px)
    hy.precede(py)
    k.succeed(px, py).precede(push)
    with Executor(num_workers=4, devices=[cuda]) as ex:
        assert ex.run_n(G, 3).result(timeout=120) == 3
        (lane,) = ex.lanes.lanes()
        assert lane.copy_stream is not None and lane.compute_stream is not None
        assert lane.copy_stream != lane.compute_stream
    np.testing.assert_array_equal(y, 4.0)


def test_executor_chains_kernels_across_two_bins_on_one_card(cuda):
    """Two bins on one card are two stream pairs: a kernel on one bin that
    reads a kernel's output from the other waits on its event."""
    from repro_torch.core import Executor, Heteroflow
    from repro_torch.sched import DeviceBin
    N = 1 << 22
    src = np.arange(N, dtype=np.float32) % 97
    out = np.zeros(N, np.float32)
    G = Heteroflow("chain")
    p1 = G.pull(src, name="p1")
    # a sort first keeps k1 busy (exactly: finite values times 0 are 0), so
    # a k2 that did not wait on k1's event would read an unwritten buffer
    k1 = G.kernel(lambda a: (torch.sort(a).values * 0 + a) * 3, p1,
                  name="k1")
    k1.succeed(p1)
    p2 = G.pull(out, name="p2")
    k2 = G.kernel(lambda o, r: r + 1, p2, k1, writes=(p2,), name="k2")
    k2.succeed(p2, k1)
    G.push(p2, out, name="push").succeed(k2)
    bins = [DeviceBin(cuda, label="a"), DeviceBin(cuda, label="b")]
    with Executor(num_workers=3, devices=bins,
                  scheduler="round_robin") as ex:
        assert ex.run_n(G, 4).result(timeout=120) == 4
    assert k1._node.bin_key != k2._node.bin_key
    np.testing.assert_array_equal(out, src * 3 + 1)


def test_executor_spills_to_host_on_cuda(cuda):
    from repro_torch.core import Executor, Heteroflow
    from repro_torch.sched import DeviceBin
    dev = DeviceBin(cuda, memory_bytes=16384)            # 2 of 4 pulls fit
    G = Heteroflow("spill")
    ks = []
    for i in range(4):
        p = G.pull(np.full(8192, i, np.uint8), name=f"p{i}")
        k = G.kernel(lambda a: a.sum(dtype=torch.int64), p, name=f"k{i}")
        k.succeed(p)
        ks.append(k)
    with Executor(num_workers=1, devices=[dev]) as ex:
        ex.run(G).result(timeout=120)
        stats = ex.stats()
    assert [int(k.result()) for k in ks] == [i * 8192 for i in range(4)]
    assert stats["spills"] >= 2
    assert all(p <= 16384 for p in stats["arena_peak_bytes"].values())


def test_engine_on_cuda_matches_cpu(cuda):
    """Reduced phi3-mini at f32: the engine under the executor on the card
    (kernels) gives the CPU engine's (plain versions) greedy tokens."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import Executor
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(reduced(get_config("phi3-mini-3.8b")),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    # greedy top-2 margins of these prompts on the CPU are all > 0.03, far
    # above the ~1e-5 the card's f32 sums differ by
    prompts = [np.arange(5 + 3 * i) * 29 % 256 for i in range(5)]
    runs = []
    for device in (torch.device("cpu"), cuda):
        p = _to(params, device)
        with Executor(num_workers=2, devices=[device]) as ex:
            eng = ServingEngine(cfg, p, max_slots=2, max_seq=64,
                                executor=ex, device=device)
            for prompt in prompts:
                eng.submit(prompt, max_new_tokens=6)
            runs.append({r.id: r.generated for r in eng.run()})
    assert runs[0] == runs[1]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# the engine's decode step captured in CUDA graphs
# ---------------------------------------------------------------------------
#: the reduced families at f32 compute; xLSTM on the reference's canary
#: stack (one mLSTM and one sLSTM block, twice), as in the CPU parity
#: tests; deepseek-v2 (MLA) and qwen2-vl (M-RoPE) decode from positions
#: made on the device as the others do
GRAPH_ARCHS = ["phi3-mini-3.8b", "recurrentgemma-2b",
               "llama4-maverick-400b-a17b", "xlstm-1.3b",
               "deepseek-v2-236b", "qwen2-vl-7b"]


def _reduced_f32(arch):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import LayerGroup
    kw = {}
    if arch == "xlstm-1.3b":
        kw["groups"] = (LayerGroup(pattern=("mlstm", "slstm"), count=2,
                                   ffn="none"),)
    return dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32", **kw)


def _graph_rig(cuda, arch):
    from repro_torch.models import cast_params, init_params
    cfg = _reduced_f32(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    return cfg, _to(cast_params(cfg, params), cuda)


def _launch_counts():
    from repro_torch.serving.graphs import COUNTED
    import repro_torch.kernels as K
    return {n: getattr(K, n).launches for n in COUNTED}


def _kernel_layers(cfg):
    """(attention sub-layers, MoE sub-layers) of ``cfg``: the decode and
    gating launches one step makes."""
    attn = moe = 0
    for g in cfg.groups:
        for i, mixer in enumerate(g.pattern):
            attn += g.count * (mixer in ("attn", "attn_local", "mla"))
            moe += g.count * (g.ffn_of(i) == "moe")
    return attn, moe


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_graphed_decode_equals_eager_decode(cuda, arch):
    """A slot's captured decode step, replayed on a side stream (as the
    executor's compute stream) after an eager prefill, gives the eager
    step's logits bit for bit for 40 steps (recurrentgemma's ring of 32
    rows wraps at step 13), and each replay advances the launch counters
    by what the graph holds: one decode launch per attention layer and
    one gating launch per MoE layer."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.transformer import reset_cache
    from repro_torch.serving.graphs import DecodeGraphs
    cfg, p = _graph_rig(cuda, arch)
    caches = init_cache(cfg, 1, 64, dtype=torch.float32, device=cuda)
    graphs = DecodeGraphs(cfg, p, [caches], cuda)
    attn, moe = _kernel_layers(cfg)
    assert graphs.slots[0].launches == {
        "flash_attention": 0, "decode_attention": attn, "rglru_scan": 0,
        "moe_gating": moe}
    reset_cache(cfg, caches)
    eager = init_cache(cfg, 1, 64, dtype=torch.float32, device=cuda)
    prompt = (torch.arange(3, 23, device=cuda) * 7 % cfg.vocab_size)[None]
    logits, caches = prefill(cfg, p, prompt, caches)
    _, eager = prefill(cfg, p, prompt, eager)
    tok = int(logits[0].argmax())
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        for n in range(40):
            before = _launch_counts()
            glog = graphs.step(0, tok, prompt.shape[1] + n)
            after = _launch_counts()
            assert {k: after[k] - before[k] for k in after} \
                == graphs.slots[0].launches
            elog, eager = decode_step(cfg, p, torch.tensor([tok],
                                                           device=cuda),
                                      eager)
            torch.testing.assert_close(glog, elog, rtol=0, atol=0)
            tok = int(glog[0].argmax())
    assert graphs.replays == 40


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_engine_graphs_under_the_executor_match_eager_steps(cuda, arch):
    """The engine under the executor (each tick on the bin's compute
    stream; more requests than slots, so slots are reset and their
    graphs replayed for new occupants) gives the tokens of eager
    prefill and decode steps on fresh caches, and its launch counts
    are the graphs' per replay plus the warm-up step and the prefills."""
    from repro_torch.core import Executor
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.serving import ServingEngine
    cfg, p = _graph_rig(cuda, arch)
    prompts = [np.arange(3 + 9 * i) * 7 % cfg.vocab_size for i in range(4)]
    want = []
    for prompt in prompts:
        caches = init_cache(cfg, 1, 48, device=cuda)
        logits, caches = prefill(cfg, p, torch.as_tensor(
            prompt[None], dtype=torch.long, device=cuda), caches)
        toks = [int(logits[0].argmax())]
        for _ in range(5):
            logits, caches = decode_step(cfg, p, torch.tensor(
                [toks[-1]], device=cuda), caches)
            toks.append(int(logits[0].argmax()))
        want.append(toks)
    before = _launch_counts()
    with Executor(num_workers=2, devices=[cuda]) as ex:
        eng = ServingEngine(cfg, p, max_slots=2, max_seq=48, executor=ex,
                            device=cuda)
        for prompt in prompts:
            eng.submit(prompt, max_new_tokens=6)
        got = {r.id: r.generated for r in eng.run()}
    torch.cuda.synchronize()
    after = _launch_counts()
    assert [got[i] for i in range(4)] == want
    graphs = eng.decode_graphs
    assert len(graphs.slots) == 2 and graphs.replays == 4 * 5
    attn, moe = _kernel_layers(cfg)
    # every prefill is graphed: a ladder family's (whose one-token chunks
    # replay the decode graphs too) or the others' buckets (after one
    # eager warm-up pass of each bucket)
    from repro_torch.serving.graphs import BucketPrefillGraphs, PrefillGraphs
    pre = eng.prefill_graphs
    ladder = arch in LADDER_ARCHS
    assert isinstance(pre, PrefillGraphs if ladder else BucketPrefillGraphs)
    assert pre.prefills == 4
    ones = pre.decode_chunks if ladder else 0
    warm = 0 if ladder else pre.warmups
    steps = graphs.replays + graphs.warmup_steps + ones
    assert after["decode_attention"] - before["decode_attention"] \
        == attn * steps
    assert after["moe_gating"] - before["moe_gating"] \
        == moe * (steps + 4 + warm)


def test_a_capture_keeps_the_cyclic_gc_out(cuda):
    """A dead reference cycle that holds a captured graph (as a served
    engine and its executor's closures do) is not collected inside a
    later capture: the allocations of the capture's Python code would
    trigger an automatic collection, the old graph's reset would run
    inside the capture, and CUDA would invalidate it."""
    import gc

    from repro_torch.kernels import GraphLaunches

    class Holder:
        pass

    x = torch.zeros(4, device=cuda)
    gc.collect()
    old = Holder()
    old.self, old.graph = old, torch.cuda.CUDAGraph()
    with torch.cuda.graph(old.graph, capture_error_mode="thread_local"):
        old.out = x + 1
    del old                 # only the cyclic collector frees it now
    graph = torch.cuda.CUDAGraph()
    with GraphLaunches(()).capture(), torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        out = x * 2
        junk = [[i] for i in range(50_000)]   # past gen 0's threshold
    assert gc.isenabled() and len(junk) == 50_000
    x.fill_(3.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.full_like(x, 6.0))
    gc.collect()


# ---------------------------------------------------------------------------
# the ladder prefill: chunks captured in CUDA graphs at a device offset
# ---------------------------------------------------------------------------
#: the reduced families the ladder serves (xLSTM on its canary stack)
LADDER_ARCHS = ["phi3-mini-3.8b", "qwen2-vl-7b", "musicgen-large",
                "xlstm-1.3b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,K,D", [(32, 32, 96), (28, 4, 128)])
@pytest.mark.parametrize("Sq", [2, 64, 512])
@pytest.mark.parametrize("off", [0, 1, 200, 511])
def test_flash_kernel_at_a_device_offset_matches_plain(cuda, dtype, H, K, D,
                                                       Sq, off):
    """phi3's and qwen2-vl's heads: a chunk of Sq rows at a device q offset
    over a whole 1024-row cache (zero past the chunk, as after a reset)
    against the plain version at the same device offset, and bit for bit
    against the kernel at the int offset over the cache's first off + Sq
    rows (the rows past them are masked in both)."""
    rng = np.random.default_rng(25)
    q = _randn(rng, (1, Sq, H, D), dtype, cuda)
    kc = torch.zeros((1, 1024, K, D), dtype=dtype, device=cuda)
    vc = torch.zeros((1, 1024, K, D), dtype=dtype, device=cuda)
    kc[:, :off + Sq] = _randn(rng, (1, off + Sq, K, D), dtype, cuda)
    vc[:, :off + Sq] = _randn(rng, (1, off + Sq, K, D), dtype, cuda)
    at = torch.full((1,), off, dtype=torch.long, device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, kc, vc, q_offset=at)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _close(out, flash_attention_plain(*_f32(q, kc, vc), q_offset=at), dtype)
    sliced = flash_attention(q, kc[:, :off + Sq], vc[:, :off + Sq],
                             q_offset=off)
    assert torch.equal(out, sliced)


def _ladder_rig(cuda, arch, max_seq=48):
    """A reduced family at f32 with one slot's f32 caches, its decode
    graph and its ladder (top rung 32 at 48 rows)."""
    from repro_torch.models import init_cache
    from repro_torch.serving.graphs import DecodeGraphs, PrefillGraphs
    cfg, p = _graph_rig(cuda, arch)
    caches = init_cache(cfg, 1, max_seq, dtype=torch.float32, device=cuda)
    dec = DecodeGraphs(cfg, p, [caches], cuda)
    return cfg, p, [caches], dec, PrefillGraphs(cfg, p, [caches], dec,
                                                max_seq, cuda)


@pytest.fixture(scope="module", params=LADDER_ARCHS)
def ladder(request, cuda):
    return _ladder_rig(cuda, request.param)


@pytest.mark.parametrize("L", [1, 2, 7, 21, 37])
def test_graphed_ladder_prefill_equals_the_eager_ladder(cuda, ladder, L):
    """The ladder replayed on a side stream (as the executor's compute
    stream) gives the eager ``prefill(..., pos=)`` of the same plan bit
    for bit, logits and every cache, and the slot's decode graph after it
    the eager decode steps' tokens and logits; each chunk's replay adds
    what its graph holds to the launch counters: one flash launch per
    attention layer for a chunk of two tokens or more, one decode launch
    for a chunk of one."""
    from repro_torch.models import decode_step, init_cache, reset_cache
    from repro_torch.serving.graphs import eager_ladder
    cfg, p, slot_caches, dec, pre = ladder
    attn, _ = _kernel_layers(cfg)
    for r, g in pre.slots[0].items():
        assert g.launches == {"flash_attention": attn, "decode_attention": 0,
                              "rglru_scan": 0, "moe_gating": 0}, r
    prompt = torch.as_tensor(np.arange(3, 3 + L) * 7 % cfg.vocab_size,
                             device=cuda)[None]
    reset_cache(cfg, slot_caches[0])
    chunks = pre.plan(L)
    n_big, n_one = sum(r > 1 for r in chunks), chunks.count(1)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        before = _launch_counts()
        glog = pre.prefill(0, prompt).clone()
        after = _launch_counts()
    torch.cuda.current_stream(cuda).wait_stream(stream)
    assert after["flash_attention"] - before["flash_attention"] \
        == attn * n_big
    assert after["decode_attention"] - before["decode_attention"] \
        == attn * n_one
    eager = init_cache(cfg, 1, 48, dtype=torch.float32, device=cuda)
    elog, eager = eager_ladder(cfg, p, prompt, eager, pre.top)
    torch.testing.assert_close(glog, elog, rtol=0, atol=0)
    for got, want in zip(_cache_tensors(slot_caches[0]),
                         _cache_tensors(eager), strict=True):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    tok = int(glog[0].argmax())
    for n in range(4):
        glog = dec.step(0, tok, L + n)
        elog, eager = decode_step(cfg, p, torch.tensor([tok], device=cuda),
                                  eager)
        torch.testing.assert_close(glog, elog, rtol=0, atol=0)
        tok = int(glog[0].argmax())


def _cache_tensors(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_tensors(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _cache_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def test_ladder_refuses_a_prompt_past_the_caches(cuda, ladder):
    _, _, _, _, pre = ladder
    with pytest.raises(ValueError, match="prompt of 49 tokens"):
        pre.prefill(0, np.zeros(49, np.int64))


# ---------------------------------------------------------------------------
# the bucketed prefill: one graphed pass padded to a bucket at offset 0
# ---------------------------------------------------------------------------
#: the reduced families the buckets serve
BUCKET_ARCHS = ["recurrentgemma-2b", "llama4-maverick-400b-a17b",
                "deepseek-v2-236b"]
#: two runs at f32 compute that should give the same logits (as
#: chip_smoke.py holds the card against the CPU)
LOGIT_ATOL = 1e-3
#: prompts across the buckets 16, 32 and 48 of 48-row caches: shorter
#: than, equal to and longer than the reduced 32-row ring
BUCKET_PROMPTS = [1, 7, 16, 21, 32, 37, 48]


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "xlstm-1.3b",
                                  "musicgen-large", "minicpm-2b"]
                         + BUCKET_ARCHS)
def test_the_engine_builds_buckets_for_exactly_ring_mla_and_moe(cuda, arch):
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.graphs import BucketPrefillGraphs, PrefillGraphs
    cfg, p = _graph_rig(cuda, arch)
    eng = ServingEngine(cfg, p, max_slots=1, max_seq=32, device=cuda)
    want = BucketPrefillGraphs if arch in BUCKET_ARCHS else PrefillGraphs
    assert type(eng.prefill_graphs) is want
    if want is BucketPrefillGraphs:
        assert eng.prefill_graphs.sizes == [16, 32]


def _bucket_rig(cuda, arch, served: bool):
    """A reduced family (at its served bf16 compute with bf16 caches, or
    at f32 with f32 caches), one slot's caches of 48 rows, its decode
    graph and its bucket graphs (16, 32, 48)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import cast_params, init_cache, init_params
    from repro_torch.serving.graphs import BucketPrefillGraphs, DecodeGraphs
    if served:
        cfg, dtype = reduced(get_config(arch)), torch.bfloat16
    else:
        cfg, dtype = _reduced_f32(arch), torch.float32
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    p = _to(cast_params(cfg, params), cuda)
    caches = init_cache(cfg, 1, 48, dtype=dtype, device=cuda)
    dec = DecodeGraphs(cfg, p, [caches], cuda)
    return cfg, p, [caches], dec, BucketPrefillGraphs(cfg, p, [caches], dec,
                                                      48, cuda), dtype


@pytest.fixture(scope="module", params=BUCKET_ARCHS)
def buckets_served(request, cuda):
    return _bucket_rig(cuda, request.param, served=True)


@pytest.fixture(scope="module", params=BUCKET_ARCHS)
def buckets_f32(request, cuda):
    return _bucket_rig(cuda, request.param, served=False)


def _prompt_on(cfg, L, cuda):
    return torch.as_tensor(np.arange(3, 3 + L) * 7 % cfg.vocab_size,
                           device=cuda)[None]


@pytest.mark.parametrize("L", BUCKET_PROMPTS)
def test_graphed_bucket_equals_the_eager_padded_prefill(cuda, buckets_served,
                                                        L):
    """A bucket replayed on a side stream (as the executor's compute
    stream) gives the eager padded prefill of the same bucket
    (``eager_bucket``) bit for bit at the served dtype, logits and every
    cache; each replay adds its graph's launches: a flash launch per
    attention layer, a scan per RG-LRU layer, a gating per MoE layer."""
    from repro_torch.models import init_cache, reset_cache
    from repro_torch.serving.graphs import eager_bucket
    cfg, p, slot_caches, _, pre, dtype = buckets_served
    attn, moe = _kernel_layers(cfg)
    scans = sum(g.count * g.pattern.count("rglru") for g in cfg.groups)
    per = {"flash_attention": attn, "decode_attention": 0,
           "rglru_scan": scans, "moe_gating": moe}
    for b, g in pre.slots[0].items():
        assert g.launches == per, b
    prompt = _prompt_on(cfg, L, cuda)
    reset_cache(cfg, slot_caches[0])
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        before = _launch_counts()
        glog = pre.prefill(0, prompt).clone()
        after = _launch_counts()
    torch.cuda.current_stream(cuda).wait_stream(stream)
    assert {k: after[k] - before[k] for k in after} == per
    eager = init_cache(cfg, 1, 48, dtype=dtype, device=cuda)
    elog, eager = eager_bucket(cfg, p, prompt, eager, pre.bucket(L))
    torch.testing.assert_close(glog, elog, rtol=0, atol=0)
    for got, want in zip(_cache_tensors(slot_caches[0]),
                         _cache_tensors(eager), strict=True):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert all(sub.get("length", L) == L for grp in slot_caches[0]
               for sub in grp.values())


@pytest.mark.parametrize("L", [7, 21, 37])
def test_graphed_bucket_at_f32_matches_the_one_shot_prefill(cuda,
                                                            buckets_f32, L):
    """At f32 compute and f32 caches, the graphed bucket and 8 steps of
    the slot's decode graph after it are within LOGIT_ATOL of the eager
    one-shot prefill of the real tokens alone and its 8 eager steps, with
    the same greedy tokens."""
    from repro_torch.models import (decode_step, init_cache, prefill,
                                    reset_cache)
    cfg, p, slot_caches, dec, pre, dtype = buckets_f32
    prompt = _prompt_on(cfg, L, cuda)
    reset_cache(cfg, slot_caches[0])
    logits = pre.prefill(0, prompt).clone()
    gt, gl = [int(logits[0].argmax())], [logits]
    for n in range(8):
        logits = dec.step(0, gt[-1], L + n).clone()
        gt.append(int(logits[0].argmax()))
        gl.append(logits)
    caches = init_cache(cfg, 1, 48, dtype=dtype, device=cuda)
    logits, caches = prefill(cfg, p, prompt, caches)
    et, el = [int(logits[0].argmax())], [logits]
    for _ in range(8):
        logits, caches = decode_step(cfg, p, torch.tensor([et[-1]],
                                                          device=cuda),
                                     caches)
        et.append(int(logits[0].argmax()))
        el.append(logits)
    assert gt == et
    torch.testing.assert_close(torch.cat(gl), torch.cat(el), rtol=0,
                               atol=LOGIT_ATOL)


def test_buckets_refuse_a_prompt_past_the_caches(cuda, buckets_served):
    _, _, _, _, pre, _ = buckets_served
    with pytest.raises(ValueError, match="prompt of 49 tokens"):
        pre.prefill(0, np.zeros(49, np.int64))


# ---------------------------------------------------------------------------
# training: the LSE output, the backward kernels, autograd, snapshots
# ---------------------------------------------------------------------------
BWD_SHAPES = [
    # B, H, K, S, D, Dv, window
    (2, 4, 2, 130, 64, 64, None),     # GQA, ragged S
    (1, 36, 36, 256, 64, 64, None),   # minicpm's heads
    (1, 10, 1, 300, 256, 256, 128),   # recurrentgemma: MQA, D 256, window
    (2, 4, 4, 97, 128, 128, None),    # D 128
    (1, 8, 2, 70, 192, 128, None),    # Dv != D
    (1, 4, 2, 33, 16, 16, 5),         # the reduced configs' D 16
    (1, 4, 4, 77, 96, 96, None),      # phi3's D 96 (two boxes), ragged S
    (1, 4, 2, 1000, 64, 64, 256),     # the window's edge inside tiles
    (1, 128, 128, 2048, 192, 128, None),  # deepseek-v2's MLA train shape
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,Dv,win", BWD_SHAPES)
def test_flash_lse_matches_plain(cuda, dtype, B, H, K, S, D, Dv, win):
    rng = np.random.default_rng(20)
    q, k = (_randn(rng, (B, S, n, D), dtype, cuda) for n in (H, K))
    v = _randn(rng, (B, S, K, Dv), dtype, cuda)
    out, lse = flash_attention(q, k, v, window=win, with_lse=True)
    ref, ref_lse = flash_attention_plain(*_f32(q, k, v), window=win,
                                         with_lse=True)
    _close(out, ref, dtype)
    _close(lse, ref_lse, torch.float32)
    # serving's call (no lse) writes the same out
    assert torch.equal(flash_attention(q, k, v, window=win), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,S,D,Dv,win", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, B, H, K, S, D, Dv, win):
    rng = np.random.default_rng(21)
    q, k = (_randn(rng, (B, S, n, D), dtype, cuda) for n in (H, K))
    v = _randn(rng, (B, S, K, Dv), dtype, cuda)
    dout = _randn(rng, (B, S, H, Dv), dtype, cuda)
    out, lse = flash_attention_plain(*_f32(q, k, v), window=win,
                                     with_lse=True)
    out = out.to(dtype)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, dout, lse, window=win)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(*_f32(q, k, v, out, dout), lse,
                                     window=win)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        _close(g, w, dtype)
    # deterministic: no atomics
    again = flash_attention_bwd(q, k, v, out, dout, lse, window=win)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,H,K,S,D,win", [(2, 4, 2, 100, 64, None),
                                           (1, 10, 1, 200, 256, 64)])
def test_flash_autograd_matches_autograd_of_plain(cuda, B, H, K, S, D, win):
    rng = np.random.default_rng(22)
    ins = [_randn(rng, (B, S, n, D), torch.float32, cuda) for n in (H, K, K)]
    dout = _randn(rng, (B, S, H, D), torch.float32, cuda)
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        ts = [t.clone().requires_grad_(True) for t in ins]
        fn(*ts, window=win).backward(dout)
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        _close(g, w, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,dr", [
    (1, 3072, 2560),                  # recurrentgemma's train shape
    (2, 300, 64),                     # a ragged last tile
    (1, 1, 256),                      # one step: h_{-1} = h0 only
    (3, 37, 100),                     # dr·4 not 16-byte: thread per channel
])
def test_rglru_scan_bwd_kernel_matches_plain(cuda, dtype, B, S, dr):
    rng = np.random.default_rng(23)
    dy = _randn(rng, (B, S, dr), dtype, cuda)
    a = torch.sigmoid(_randn(rng, (B, S, dr), torch.float32, cuda)).to(dtype)
    h = _randn(rng, (B, S, dr), dtype, cuda)
    h0 = _randn(rng, (B, dr), torch.float32, cuda)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd(dy, a, h, h0)
    torch.cuda.synchronize()
    assert rglru_scan_bwd.launches == before + 1
    want = rglru_scan_bwd_plain(dy, a, h, h0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # each step rounds apart, as the plain version: bit for bit
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_rglru_scan_autograd_matches_autograd_of_plain(cuda):
    rng = np.random.default_rng(24)
    x = _randn(rng, (2, 500, 256), torch.float32, cuda)
    a = torch.sigmoid(_randn(rng, (2, 500, 256), torch.float32, cuda))
    h0 = _randn(rng, (2, 256), torch.float32, cuda)
    dy = _randn(rng, (2, 500, 256), torch.float32, cuda)
    grads = []
    for fn in (rglru_scan, rglru_scan_plain):
        ts = [t.clone().requires_grad_(True) for t in (x, a, h0)]
        fn(*ts).backward(dy)
        grads.append([t.grad for t in ts])
    for g, w in zip(*grads):
        _close(g, w, torch.float32)


def test_async_save_snapshot_survives_the_next_in_place_step(cuda,
                                                              tmp_path):
    """The snapshot's copies are enqueued before the next step's in-place
    update on the same stream, so the files hold the state as it was."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import Executor
    from repro_torch.training import checkpoint, init_train_state

    cfg = reduced(get_config("minicpm-2b"))
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    flat = checkpoint._flatten(state)
    want = {k: t.detach().cpu().clone() for k, t in flat.items()}
    with Executor(num_workers=2, devices=[cuda]) as ex:
        fut = checkpoint.async_save(ex, str(tmp_path), 1, state)
        with torch.no_grad():
            for t in flat.values():
                if t.is_floating_point():
                    t.mul_(-3.0).add_(1.0)
        fut.result(timeout=120)
    restored, step = checkpoint.restore(str(tmp_path), state)
    assert step == 1
    for k, t in checkpoint._flatten(restored).items():
        assert t.device == flat[k].device
        assert torch.equal(t.cpu(), want[k]), k


@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b"])
def test_remat_policies_give_the_same_grads_on_the_card(cuda, arch):
    """The forward and backward kernels under every remat policy (a
    recomputed block launches its forward kernels again; "dots" runs them
    under selective checkpointing): the same loss and gradients."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticSource
    from repro_torch.models import init_params, loss_fn
    from repro_torch.training.checkpoint import _flatten, _unflatten

    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    b = SyntheticSource(cfg.vocab_size).batch(0, 2, 40)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}
    runs = []
    for remat in ("none", "full", "dots"):
        ps = {k: t.detach().clone().requires_grad_(True)
              for k, t in _flatten(params).items()}
        tree = _unflatten(params, ps)
        loss, _ = loss_fn(cfg, tree, batch, remat_policy=remat)
        loss.backward()
        runs.append((loss.detach(), {k: t.grad for k, t in ps.items()}))
    (l0, g0) = runs[0]
    for loss, grads in runs[1:]:
        _close(loss, l0, torch.float32)
        for k in g0:
            _close(grads[k], g0[k], torch.float32)


# ---------------------------------------------------------------------------
# the train step captured in a CUDA graph (training/graphs.py)
# ---------------------------------------------------------------------------
def _train_batches(cfg, n, device, B=4, S=16):
    """``n`` SyntheticSource batches (seeds 0..n-1) on ``device``; for the
    vision stub each also carries patch embeddings drawn from its seed."""
    from repro_torch.data import SyntheticSource
    from repro_torch.models.frontends import make_patch_embeds
    out = []
    for i in range(n):
        b = {k: torch.from_numpy(v).to(device) for k, v in
             SyntheticSource(cfg.vocab_size, seed=i).batch(0, B, S).items()}
        if cfg.frontend == "vision_stub":
            b["extra_embeds"] = make_patch_embeds(
                torch.Generator().manual_seed(i), B, cfg.n_visual_tokens,
                cfg.d_model, dtype=torch.float32).to(device)
        out.append(b)
    return out


def _same_state(a, b):
    from repro_torch.training.checkpoint import _flatten
    fa, fb = _flatten(a), _flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


#: the reduced families the CPU tests train against the reference
TRAIN_ARCHS = ["minicpm-2b", "recurrentgemma-2b", "llama4-maverick-400b-a17b",
               "deepseek-v2-236b", "xlstm-1.3b", "qwen2-vl-7b"]


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_graphed_train_step_equals_eager_step(cuda, arch, accum, remat):
    """Four steps of each reduced trained family (f32 compute; xLSTM's
    canary stack; qwen2-vl with patch embeddings) from one state: eager,
    and through a TrainStepGraph replayed on a side stream (as the
    executor's compute stream) after its eager first step.  Losses,
    metrics, params, m, v and step are bit-identical, and each replay
    advances the six launch counters by the launches of one eager step."""
    import repro_torch.kernels as K
    from repro_torch.training import (AdamWConfig, TrainStepGraph,
                                      init_train_state, make_train_step,
                                      wsd_schedule)
    cfg = _reduced_f32(arch)
    state0 = init_train_state(cfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    opt = AdamWConfig(schedule=wsd_schedule(1e-3, 1, 10, 5))
    batches = _train_batches(cfg, 4, cuda)

    def make():
        return make_train_step(cfg, opt, remat_policy=remat, accum=accum)

    eager, step, want, per_step = _to(state0, cuda), make(), [], []
    for b in batches:
        before = K.launch_counts()
        eager, m = step(eager, b)
        after = K.launch_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        want.append({k: v.clone() for k, v in m.items()})
    state = _to(state0, cuda)
    graph = TrainStepGraph(make(), state)
    got = []
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        for i, b in enumerate(batches):
            before = K.launch_counts()
            out, m = graph(state, b)
            after = K.launch_counts()
            assert out is state
            assert {k: after[k] - before[k] for k in after} == per_step[i]
            got.append({k: v.clone() for k, v in m.items()})
    torch.cuda.synchronize(cuda)
    assert graph.replays == 3 and graph.counts.per_replay == per_step[0]
    assert graph.capture_seconds > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), (i, k)
    _same_state(state, eager)
    assert int(state["opt"]["step"]) == 4


def test_graphed_train_step_refuses_another_batch_shape_or_state(cuda):
    """No retrace and no fallback: a batch of another shape, or another
    state than the graph was built on, raises."""
    from repro_torch.training import (AdamWConfig, TrainStepGraph,
                                      cosine_schedule, init_train_state,
                                      make_train_step)
    cfg = _reduced_f32("minicpm-2b")
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    graph = TrainStepGraph(make_train_step(cfg, AdamWConfig(
        schedule=cosine_schedule(1e-3, 1, 10)), remat_policy="none"), state)
    (b,) = _train_batches(cfg, 1, cuda)
    graph(state, b)
    graph(state, b)
    with pytest.raises(ValueError, match="batch"):
        graph(state, {k: v[:2] for k, v in b.items()})
    with pytest.raises(ValueError, match="another state"):
        graph(dict(state), b)
    assert graph.replays == 1


def test_train_launcher_graphs_resume_like_an_uninterrupted_run(cuda,
                                                                 tmp_path):
    """``launch.train.train`` on the card (a TrainStepGraph under the
    Executor): 2 steps with a checkpoint at step 2, then a resumed run of
    2 more, whose graph is captured over the restored tensors.  The
    losses and the final state equal an uninterrupted eager run of 4
    steps over the batches the two runs read (the launcher's pipeline
    starts at batch 0 again after a resume, as the reference's does)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticSource
    from repro_torch.launch.train import train
    from repro_torch.training import (AdamWConfig, checkpoint,
                                      init_train_state, make_train_step,
                                      wsd_schedule)
    cfg = reduced(get_config("minicpm-2b"))
    ck = str(tmp_path / "ck")
    kw = dict(batch=2, seq=16, device=cuda, remat="none", ckpt_dir=ck,
              ckpt_every=2)
    first = train(cfg, steps=2, **kw)
    assert checkpoint.latest_step(ck) == 2
    resumed = train(cfg, steps=2, resume=True, **kw)
    assert first["capture_seconds"] and resumed["capture_seconds"]
    assert checkpoint.latest_step(ck) == 4

    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
    step = make_train_step(cfg, AdamWConfig(
        schedule=wsd_schedule(3e-4, 100, 100, 100)), remat_policy="none")
    losses = []
    for i in (0, 1, 0, 1):
        b = SyntheticSource(cfg.vocab_size, seed=0).batch(i, 2, 16)
        state, m = step(state, {k: torch.from_numpy(v).to(cuda)
                                for k, v in b.items()})
        losses.append(float(m["total_loss"]))
    assert first["losses"] + resumed["losses"] == losses
    _same_state(resumed["state"], state)



# ---------------------------------------------------------------------------
# the distributed layer at world size 1: a one-rank NCCL group and the 1x1
# smoke mesh on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nccl_mesh(cuda):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    mesh = make_smoke_mesh(cuda)
    assert dist.get_backend() == "nccl"
    yield mesh
    if dist.is_initialized():      # a dry-run test takes it down itself
        dist.destroy_process_group()


def test_mesh_bin_pulls_and_runs_on_the_card(cuda, nccl_mesh):
    """A tree pulled onto a live 1x1 MeshBin lands on cuda:0 as replicated
    DTensors; a kernel there launches the flash kernel on their local
    tensors; a DeviceBin downstream reads the result as a plain tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import Executor, Heteroflow
    from repro_torch.sched import DeviceBin, MeshBin

    (mb,) = MeshBin.from_mesh(nccl_mesh)
    assert mb.device == cuda and "cuda" in mb.capabilities
    rng = np.random.default_rng(0)
    qkv = {n: rng.standard_normal((1, 64, 4, 64)).astype(np.float32)
           for n in ("q", "k", "v")}
    seen = {}

    def attend(t):
        seen["q"] = t["q"]
        return flash_attention(t["q"], t["k"], t["v"])

    def read(o):
        seen["o"] = o
        return o * 2

    G = Heteroflow()
    p = G.pull(qkv, name="qkv")
    k1 = G.kernel(attend, p, requires=("mesh",), name="attend")
    k1.succeed(p)
    k2 = G.kernel(read, k1, name="read")
    k2.succeed(k1)
    before = flash_attention.launches
    with Executor(num_workers=2, devices=[mb, DeviceBin(cuda)]) as ex:
        ex.run(G).result(timeout=120)
    assert flash_attention.launches == before + 1
    assert isinstance(seen["q"], DTensor) and seen["q"].device == cuda
    assert not isinstance(seen["o"], DTensor) and seen["o"].device == cuda
    want = flash_attention_plain(*(torch.from_numpy(qkv[n])
                                   for n in ("q", "k", "v")))
    _close(torch.from_numpy(k2.host_result()) / 2, want, torch.float32)


def test_pipeline_over_device_and_mesh_stage_bins(cuda, nccl_mesh):
    """Reduced phi3 (bf16 compute) in two stages over stage slots of
    three DeviceBins and one MeshBin: each microbatch's logits are the
    sequential forward's, and the flash kernel ran for every block."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core import Executor
    from repro_torch.core.graph import map_tree
    from repro_torch.distributed.pipeline import build_pipeline_graph
    from repro_torch.models import cast_params, forward, init_params
    from repro_torch.models.transformer import pipeline_stages
    from repro_torch.sched import DeviceBin, MeshBin, stage_bins

    cfg = reduced(get_config("phi3-mini-3.8b"))
    cfg = dataclasses.replace(cfg, groups=(
        dataclasses.replace(cfg.groups[0], count=4),))
    params = cast_params(cfg, init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda))
    stages = pipeline_stages(cfg, params, 2)
    for st in stages:
        st.params = map_tree(lambda t: t.cpu(), st.params)
    (mb,) = MeshBin.from_mesh(nccl_mesh)
    pool = stage_bins([mb, DeviceBin(cuda), DeviceBin(cuda),
                       DeviceBin(cuda)])
    rng = np.random.default_rng(0)
    mbs = [rng.integers(0, cfg.vocab_size, size=(1, 64)) for _ in range(3)]
    out = []
    G = build_pipeline_graph(stages, mbs, collect=out)
    before = flash_attention.launches
    with Executor(num_workers=3, devices=pool) as ex:
        ex.run(G).result(timeout=120)
    assert flash_attention.launches == before + 4 * len(mbs)
    assert any(n.device.member is mb for n in G.nodes
               if n.name.startswith("f["))
    for got, tokens in zip(out, mbs):
        want, _ = forward(cfg, params, torch.as_tensor(tokens, device=cuda))
        _close(torch.from_numpy(got), want.cpu(), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_world_size_one_matches_the_decode_kernel(
        cuda, nccl_mesh, dtype):
    from repro_torch.distributed.flash_decode import flash_decode_update

    rng = np.random.default_rng(0)
    B, H, K, D, S, length = 2, 8, 4, 96, 256, 117
    q = _randn(rng, (B, 1, H, D), dtype, cuda)
    kn, vn = (_randn(rng, (B, 1, K, D), dtype, cuda) for _ in range(2))
    kc, vc = (_randn(rng, (B, S, K, D), dtype, cuda) for _ in range(2))
    kw, vw = kc.clone(), vc.clone()
    kw[:, length], vw[:, length] = kn[:, 0], vn[:, 0]
    want = decode_attention(q[:, 0], kw, vw, torch.full(
        (B,), length + 1, dtype=torch.int32, device=cuda))
    out, _, _ = flash_decode_update(q, kn, vn, kc, vc,
                                    torch.tensor([length], device=cuda),
                                    mesh=nccl_mesh, baxes=("data",),
                                    maxis="model")
    _close(out[:, 0], want, dtype)
    assert torch.equal(kc, kw) and torch.equal(vc, vw)


def test_moe_shard_map_at_world_size_one_matches_moe_local(cuda, nccl_mesh):
    """Reduced deepseek-v2's MoE (bf16): _moe_shard_map on one rank is
    _moe_local plus the shared experts, bit for bit, through the gating
    kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import moe as M
    from repro_torch.models.layers import ffn_forward

    cfg = reduced(get_config("deepseek-v2-236b"))
    p = M.init_moe(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict)
             else v[0]) for k, v in p.items()}
    x = _randn(np.random.default_rng(1), (2, 64, cfg.d_model),
               torch.bfloat16, cuda)
    before = moe_gating.launches
    got, _ = M._moe_shard_map(cfg, p, x, torch.bfloat16, nccl_mesh,
                              ("data",), "model")
    assert moe_gating.launches == before + 1
    want, _ = M._moe_local(cfg, p, x, torch.bfloat16)
    want = want + ffn_forward(cfg, p["shared"], x)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernels' custom ops and the dry-run's FLOP count on the card
# ---------------------------------------------------------------------------
def _op_cases(dev):
    """(custom op name, the module's launch function, arguments, the
    wrapper whose counter the launch adds to) for each kernel."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gating import ops as gops
    from repro_torch.kernels.rglru_scan import ops as sops

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    q, dout = (_randn(rng, (1, 128, 4, 64), bf, dev) for _ in range(2))
    k, v = (_randn(rng, (1, 128, 2, 64), bf, dev) for _ in range(2))
    out, lse = flash_attention(q, k, v, with_lse=True)
    x, dy, h = (_randn(rng, (1, 64, 256), torch.float32, dev)
                for _ in range(3))
    a = torch.sigmoid(_randn(rng, (1, 64, 256), torch.float32, dev))
    h0 = _randn(rng, (1, 256), torch.float32, dev)
    kc, vc = (_randn(rng, (2, 256, 2, 64), bf, dev) for _ in range(2))
    vl = torch.tensor([17, 256], dtype=torch.int32, device=dev)
    return {
        "flash_attention": (fops._fwd_launch, (q, k, v, 0, 0, True, True,
                                               0.125), flash_attention),
        "flash_attention_bwd": (fops._bwd_launch,
                                (q, k, v, out, dout, lse, 0, True, 0.125),
                                flash_attention_bwd),
        "decode_attention": (dops._decode_launch,
                             (q[:, 0].contiguous(), kc, vc, vl, 0.125),
                             decode_attention),
        "rglru_scan": (sops._scan_launch, (x, a, h0), rglru_scan),
        "rglru_scan_bwd": (sops._scan_bwd_launch, (dy, a, h, h0),
                           rglru_scan_bwd),
        "moe_gating": (gops._gating_launch,
                       (_randn(rng, (64, 16), torch.float32, dev), 2, 8),
                       moe_gating),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd",
                                    "decode_attention", "rglru_scan",
                                    "rglru_scan_bwd", "moe_gating"])
def test_custom_op_launch_equals_the_direct_launch(cuda, kernel):
    """The custom op on CUDA tensors is the kernel's launch: bit for bit
    the launch function called directly, one count each."""
    launch, args, wrapper = _op_cases(cuda)[kernel]
    before = wrapper.launches
    direct = launch(*args)
    through = getattr(torch.ops.repro_torch, kernel)(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    direct = direct if isinstance(direct, tuple) else (direct,)
    through = through if isinstance(through, tuple) else (through,)
    assert len(direct) == len(through)
    for d, t in zip(direct, through):
        assert torch.equal(d, t)


@pytest.mark.parametrize("arch,kind", [("minicpm-2b", "train"),
                                       ("phi3-mini-3.8b", "decode"),
                                       ("xlstm-1.3b", "train")])
def test_flop_counter_on_a_real_step_equals_the_dry_run(cuda, arch, kind):
    """``FlopCounterMode`` over a reduced step run on the card counts
    what the dry-run counts tracing the same step on fake tensors over a
    1x1 fake mesh (the kernels by their formulas in both; xLSTM's time
    loops step by step on the card, as one op counting its steps in the
    trace)."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    import repro_torch.configs as tconfigs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.training import init_train_state

    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    shape = ShapeConfig("cell", 64, 2, kind)
    rec = dryrun.run_cell(cfg, shape, mesh_shape=(1, 1),
                          extra_overrides={"accum": 1})
    gen = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                           device=cuda, dtype=torch.int32)
    fn = dryrun.step_fn(cfg, shape, accum=1)
    if kind == "train":
        args = (init_train_state(cfg, gen, cuda),
                {"tokens": tokens, "labels": tokens})
    else:
        args = (init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                            gen, cuda), {"token": tokens[:, 0]},
                dryrun.serve_caches(cfg, shape, device=cuda))
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    assert counter.get_total_flops() == int(rec["roofline"]["flops_per_chip"])


@pytest.mark.parametrize("workers", [1, 4])
def test_propagation_dag_on_the_card_equals_the_plain_longest_path(
        cuda, workers):
    """The timing-analysis twin's 10³-cell propagation DAG on ``cuda:0``
    (each pull on the bin's copy stream, each arrival kernel on its
    compute stream after its inputs' events): every arrival equals the
    plain longest path over the graph's own edges, bit for bit."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import longest_path
    from examples_torch import timing_analysis

    run = timing_analysis.main(["--views", "10", "--cells-per-view", "100",
                                "--workers", str(workers)])[0]
    assert run["arrivals"].shape == (1000,)
    np.testing.assert_array_equal(run["arrivals"], longest_path(run["graph"]))
