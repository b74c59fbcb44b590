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
    expert-parallel MoE over (1, 2) and (2, 1) meshes, each against its
    single-device path on this rank's share; a sharded DTensor refused
    by a kernel wrapper; mesh bins of a tiled mesh."""
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
    # a kernel never runs one shard as the whole operand
    g = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 8, 4, 16, generator=g) for _ in range(3)]
    sharded = DTensor.from_local(qkv[0][:, :, 2 * rank:2 * rank + 2], mp,
                                 [Shard(0), Shard(2)], run_check=False)
    try:
        flash_attention(sharded, sharded, sharded)
    except ValueError as e:
        assert "not a shard" in str(e)
    else:
        raise AssertionError("a sharded DTensor reached the kernel")
    bins = tsched.MeshBin.from_mesh(mp, {"model": 1})
    assert [b.label for b in bins] == ["mesh:1x1[0]", "mesh:1x1[1]"]
    dist.destroy_process_group()
