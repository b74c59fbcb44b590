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
                                 flash_attention, flash_attention_plain,
                                 moe_gating, moe_gating_plain, rglru_scan,
                                 rglru_scan_plain)

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
    (1, 36, 2, 100, 200),            # G 18 in three blocks, D 200
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
