"""The rank side of ``tests/test_torch_distributed.py``'s collectives:
inputs made from seeds with numpy, the single-device paths each
collective is held against, and one spawned gloo rank's checks.  It
imports torch, numpy and the port only, so a spawned rank starts in a
few seconds without JAX."""
import dataclasses

import numpy as np
import torch

import repro_torch.configs as tconfigs
from repro_torch import sched as tsched
from repro_torch.distributed.flash_decode import flash_decode_update
from repro_torch.kernels import decode_attention, flash_attention
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr

CPU = torch.device("cpu")
#: a collective path against its single-device path at f32: the same
#: products, summed in another order across ranks
COLL_TOL = dict(rtol=2e-5, atol=2e-5)


def decode_inputs(B=2, S=64, H=4, K=2, hd=16, length=37, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(B, 1, H, hd), f(B, 1, K, hd), f(B, 1, K, hd), f(B, S, K, hd),
            f(B, S, K, hd), length)


def decode_want(q, kn, vn, kc, vc, length):
    """The single-device path: the new row written, decode attention
    over rows <= length."""
    kc, vc = kc.copy(), vc.copy()
    kc[:, length], vc[:, length] = kn[:, 0], vn[:, 0]
    B = q.shape[0]
    out = decode_attention(torch.from_numpy(q[:, 0]), torch.from_numpy(kc),
                           torch.from_numpy(vc),
                           torch.full((B,), length + 1, dtype=torch.int32))
    return out.numpy()[:, None], kc, vc


def moe_case(capacity_factor=8.0):
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-v2-236b"))
    cfg = dataclasses.replace(cfg, compute_dtype="float32", moe=dataclasses
                              .replace(cfg.moe, capacity_factor=capacity_factor))
    p = tmoe.init_moe(cfg, torch.Generator().manual_seed(0), CPU, count=1)
    p = {k: ({n: t[0] for n, t in v.items()} if isinstance(v, dict)
             else v[0]) for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    return cfg, p, x


def moe_want(cfg, p, x):
    out, aux = tmoe._moe_local(cfg, p, x, torch.float32, aux=True)
    return out + tmoe.ffn_forward(cfg, p["shared"], x), aux


def rank_main(rank: int, world: int, store: str) -> None:
    """One spawned gloo rank: flash-decode over a (1, 2) mesh, the
    expert-parallel MoE over (1, 2) and (2, 1) meshes (and its gradient
    to this rank's tokens), each against its single-device path on this
    rank's share; a head-sharded DTensor run
    per rank by a kernel's sharding rule; mesh bins of a tiled mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mp = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    dp = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
    # flash-decode: rank r holds cache rows [32 r, 32 r + 32)
    for length in (37, 3, 63):
        ins = decode_inputs(length=length)
        want, kc_want, vc_want = decode_want(*ins)
        q, kn, vn = (torch.from_numpy(a) for a in ins[:3])
        kc, vc = (torch.from_numpy(a[:, 32 * rank:32 * rank + 32].copy())
                  for a in ins[3:5])
        out, _, _ = flash_decode_update(q, kn, vn, kc, vc,
                                        torch.tensor([length]), mesh=mp,
                                        baxes=("data",), maxis="model")
        np.testing.assert_allclose(out.numpy(), want, **COLL_TOL)
        np.testing.assert_array_equal(
            kc.numpy(), kc_want[:, 32 * rank:32 * rank + 32])
        np.testing.assert_array_equal(
            vc.numpy(), vc_want[:, 32 * rank:32 * rank + 32])
    # the hook: a decode step of an attention layer under the rules over
    # (1, 2), on this rank's rows of the cache, takes flash-decode and
    # gives the single-device layer's output
    from repro_torch.distributed.context import use_sharding_rules
    from repro_torch.models import layers as L
    cfg = tconfigs.reduced(tconfigs.get_config("phi3-mini-3.8b"))
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    p = {k: t[0] for k, t in L.init_attn(
        cfg, torch.Generator().manual_seed(0), CPU).items()}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    shape = (2, 64, cfg.n_kv_heads, cfg.head_dim_)
    full = {"k": torch.randn(shape, generator=g),
            "v": torch.randn(shape, generator=g), "length": 37}
    pos = torch.tensor([37])
    want, _ = L.attn_forward(cfg, p, x, pos.expand(2, 1),
                             {**full, "k": full["k"].clone(),
                              "v": full["v"].clone()},
                             step=ttr._decode_steps([{"s": {"k": full[
                                 "k"][None]}}], pos, 2)[64])
    local = {"k": full["k"][:, 32 * rank:32 * rank + 32].clone(),
             "v": full["v"][:, 32 * rank:32 * rank + 32].clone(),
             "length": 37}
    with use_sharding_rules(mesh=mp):
        got, _ = L.attn_forward(cfg, p, x, pos.expand(2, 1), local,
                                step=ttr._decode_steps(
                                    [{"s": {"k": local["k"][None]}}],
                                    pos, 2)[32])
    np.testing.assert_allclose(got.numpy(), want.numpy(), **COLL_TOL)
    # expert-parallel MoE: this rank's tokens, its experts (model) or its
    # slice of each expert's d (data)
    for capacity_factor in (8.0, 0.5):
        cfg, p, x = moe_case(capacity_factor)
        E, d = cfg.moe.n_experts, cfg.d_model
        w = p["experts"]
        for mesh, (x_blk, blk) in (
                (mp, (x[:, 4 * rank:4 * rank + 4],
                      lambda t, dim: t[E // 2 * rank:E // 2 * (rank + 1)])),
                (dp, (x[rank:rank + 1],
                      lambda t, dim: t.narrow(dim, d // 2 * rank, d // 2)))):
            local = dict(p, experts={"w_gate": blk(w["w_gate"], 1),
                                     "w_up": blk(w["w_up"], 1),
                                     "w_down": blk(w["w_down"], 2)})
            got, aux = tmoe._moe_shard_map(cfg, local, x_blk, torch.float32,
                                           mesh, ("data",), "model",
                                           aux=True)
            want, want_aux = moe_want(cfg, p, x_blk)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **COLL_TOL)
            auxes = [torch.zeros(()) for _ in range(world)]
            dist.all_gather(auxes, want_aux)
            np.testing.assert_allclose(float(aux), float(sum(auxes)) / world,
                                       **COLL_TOL)
            # the exchanges are differentiable: this rank's tokens get the
            # single-device path's gradient
            xg = [x_blk.clone().requires_grad_(True) for _ in range(2)]
            tmoe._moe_shard_map(cfg, local, xg[0], torch.float32, mesh,
                                ("data",), "model")[0].sum().backward()
            moe_want(cfg, p, xg[1])[0].sum().backward()
            np.testing.assert_allclose(xg[0].grad.numpy(),
                                       xg[1].grad.numpy(), **COLL_TOL)
    # a kernel never runs one shard as the whole operand: a head-sharded
    # call runs per rank under the kernel's sharding rule
    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 8, 4, 16, generator=g) for _ in range(3)]
    sharded = DTensor.from_local(qkv[0][:, :, 2 * rank:2 * rank + 2], mp,
                                 [Shard(0), Shard(2)], run_check=False)
    got = flash_attention(sharded, sharded, sharded)
    assert isinstance(got, DTensor) and got.to_local().shape[2] == 2
    np.testing.assert_allclose(
        got.full_tensor().numpy(),
        flash_attention(qkv[0], qkv[0], qkv[0]).numpy(), **COLL_TOL)
    bins = tsched.MeshBin.from_mesh(mp, {"model": 1})
    assert [b.label for b in bins] == ["mesh:1x1[0]", "mesh:1x1[1]"]
    dist.destroy_process_group()


def kernel_routes_main(rank: int, world: int, store: str) -> None:
    """One spawned gloo rank over a (1, 2) ("data", "model") mesh: each
    kernel wrapper on DTensors sharded as the dry-run shards them gives
    the whole call's result (the plain versions on these CPU tensors,
    run per rank by the custom ops' sharding rules):

    * flash attention with 4 q heads sharded over the model axis and one
      kv head replicated (MQA; fewer kv heads than ranks, llama4's case
      at 16): each rank reads the kv head its q heads map to, forward and
      gradients (the kv gradient summed over the ranks);
    * decode attention likewise (q heads sharded, the cache replicated);
    * the RG-LRU scan with its channels sharded, and its backward;
    * MoE gating on token-sharded logits: taken whole, never a shard."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.kernels import moe_gating, rglru_scan

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(7)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    def dt(t, *places):
        return distribute_tensor(t, mesh, list(places))

    R, S0 = Replicate(), Shard(0)
    # flash: q (B, S, H 4, D), k/v (B, S, K 1, D)
    q, k, v, dout = f(2, 12, 4, 8), f(2, 12, 1, 8), f(2, 12, 1, 8), \
        f(2, 12, 4, 8)
    want = flash_attention(q, k, v)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves).backward(dout)
    dq, dk, dv = (t.grad for t in leaves)
    dleaves = [dt(q, S0, Shard(2)).requires_grad_(True),
               dt(k, S0, R).requires_grad_(True),
               dt(v, S0, R).requires_grad_(True)]
    with torch.no_grad():
        got = flash_attention(*dleaves)
    assert got.to_local().shape[2] == 2, got.placements
    np.testing.assert_allclose(got.full_tensor().numpy(), want.numpy(),
                               **COLL_TOL)
    out = flash_attention(*dleaves)
    out.backward(dt(dout, S0, Shard(2)))
    for name, g_, w in zip("qkv", (t.grad for t in dleaves), (dq, dk, dv)):
        np.testing.assert_allclose(g_.full_tensor().numpy(), w.numpy(),
                                   err_msg=f"d{name}", **COLL_TOL)
    # decode: q (B, H 4, D), cache (B, S, K 1, D), rows below valid_len
    qd, kc, vc = f(2, 4, 8), f(2, 16, 1, 8), f(2, 16, 1, 8)
    vl = torch.tensor([5, 16], dtype=torch.int32)
    got = decode_attention(dt(qd, S0, Shard(1)), dt(kc, S0, R),
                           dt(vc, S0, R), dt(vl, S0, R))
    assert got.to_local().shape[1] == 2, got.placements
    np.testing.assert_allclose(got.full_tensor().numpy(),
                               decode_attention(qd, kc, vc, vl).numpy(),
                               **COLL_TOL)
    # the scan over channels, and its backward
    x, a, h0, dy = f(2, 6, 8), torch.sigmoid(f(2, 6, 8)), f(2, 8), f(2, 6, 8)
    C = Shard(2)
    got = rglru_scan(dt(x, S0, C), dt(a, S0, C), dt(h0, S0, Shard(1)))
    assert got.to_local().shape[2] == 4, got.placements
    np.testing.assert_array_equal(got.full_tensor().numpy(),
                                  rglru_scan(x, a, h0).numpy())
    leaves = [t.clone().requires_grad_(True) for t in (x, a, h0)]
    rglru_scan(*leaves).backward(dy)
    dleaves = [dt(x, S0, C).requires_grad_(True),
               dt(a, S0, C).requires_grad_(True),
               dt(h0, S0, Shard(1)).requires_grad_(True)]
    rglru_scan(*dleaves).backward(dt(dy, S0, C))
    for g_, t in zip(dleaves, leaves):
        np.testing.assert_allclose(g_.grad.full_tensor().numpy(),
                                   t.grad.numpy(), **COLL_TOL)
    # gating: tokens sharded over the model axis; the capacity slots run
    # over all 8 tokens, so the call is taken whole
    logits = f(8, 4)
    got = moe_gating(dt(logits, R, S0), top_k=2, capacity=2)
    for g_, w in zip(got, moe_gating(logits, top_k=2, capacity=2)):
        assert isinstance(g_, DTensor) and g_.to_local().shape[0] == 8
        np.testing.assert_array_equal(g_.full_tensor().numpy(), w.numpy())
    dist.destroy_process_group()
