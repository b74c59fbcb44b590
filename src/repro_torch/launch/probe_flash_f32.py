"""Launch-shape choices of the f32 flash kernels (three TF32 products per
product), timed on CUDA against the shapes the package picks.

    PYTHONPATH=src python -m repro_torch.launch.probe_flash_f32 \
        [--variants fwd_bk32,fwd_4x64,fwd_8x48,kv_w8,dq_w8,dq_8x24,...]

Copies of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
with one choice changed, built beside the package's libraries (one nvcc
each, together, into ``build/probe/``) and timed in turns (base, the
variants, the variants reversed, base; median of 15 launches each, L2
flushed, CUDA events), each checked first against the plain version at
the card's tolerance (2e-5 + 2e-5·|ref|):

- ``fwd_bk32``: the forward never takes eight warps with kv tiles of 64
  rows: four warps (64 q rows) and 32-row tiles where two such blocks
  share an SM, else eight and 32 where they fit;
- ``fwd_4x64``: the forward takes four warps and 64-row kv tiles where
  they fit, before eight and 64;
- ``kv_w8``: the backward's dK/dV blocks take eight warps (64 kv rows)
  wherever they fit;
- ``dq_w8``: the backward's dQ blocks take the first of (8, 32), (8, 16),
  (4, 32), (4, 16) warps and kv rows that fits, even where two blocks of
  (4, 32) share an SM;
- ``fwd_8x48``: the forward takes eight warps and 48-row kv tiles where
  they fit and 64-row ones do not (MLA), before eight and 32;
- ``dq_8x24``: the dQ blocks take eight warps and kv tiles of 24 rows
  where 32 do not fit and 24 do (MLA), before eight and 16;
- ``kv_bq64``: the dK/dV blocks stream q tiles of 64 rows, not 32;
- ``dq_bk64``: the dQ blocks take kv tiles of 64 rows at four warps where
  two such blocks share an SM.

Forward shapes: phi3-mini's (H = K = 32, S 512, D 96) and deepseek-v2's
MLA heads (H = K = 128, S 512, D 192, Dv 128); backward: H 8, K 2, S
512, D 64, minicpm-2b's (B 4, H = K = 36, S 1024, D 64) and MLA's at S
2048.  The copies are patched from the sources' text, so a patch whose
anchor is gone raises.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import torch

from ..kernels import _build, flash_attention_bwd_plain, flash_attention_plain
from ..kernels.flash_attention import ops
from .probe_flash_bwd import _build_copies, _device_ms, _sub

__all__ = ["main"]

#: variant -> (source, [(old, new), ...])
_VARIANTS = {
    "fwd_bk32": ("flash_attention", [(
        "if (groups32(Dv) <= 4 && fits(8, 64, D, Dv)) return;",
        "if (false) return;")]),
    "fwd_4x64": ("flash_attention", [(
        "*warps = 8;\n  *bk = 64;\n  if (groups32(Dv) <= 4 && fits(8, 64, D, "
        "Dv)) return;",
        "*warps = 4;\n  *bk = 64;\n  if (groups32(Dv) <= 4 && fits(4, 64, D, "
        "Dv)) return;\n  *warps = 8;")]),
    "fwd_8x48": ("flash_attention", [
        ("  *bk = 32;\n  if (2 * (smem_bytes(4, 32, D, Dv) + 1024) > SM_SMEM",
         "  *bk = 48;\n  if (groups32(Dv) <= 4 && fits(8, 48, D, Dv)) return;"
         "\n  *bk = 32;\n  if (2 * (smem_bytes(4, 32, D, Dv) + 1024) > SM_SMEM"),
        ("  if (bk == 32) return launch<NV, VEC, 32>(p, B, warps, stream);",
         "  if (bk == 32) return launch<NV, VEC, 32>(p, B, warps, stream);\n"
         "  if constexpr (NV <= 4)\n    if (bk == 48) return launch<NV, VEC, "
         "48>(p, B, warps, stream);")]),
    "kv_w8": ("flash_attention_bwd", [(
        "return !two_fit(kv_smem(4, D, Dv)) &&", "return true &&")]),
    "dq_w8": ("flash_attention_bwd", [(
        "if (two_fit(dq_smem(4, D, Dv, 32))) return;", "")]),
    "kv_bq64": ("flash_attention_bwd", [(
        "constexpr int BQ = 32;  // q rows of each tile a dK/dV block streams",
        "constexpr int BQ = 64;  // q rows of each tile a dK/dV block streams"
    )]),
    "dq_8x24": ("flash_attention_bwd", [
        ("  for (int w = 8; w >= 4; w /= 2)\n    for (int k = 32; k >= 16; "
         "k /= 2)",
         "  if (dq_smem(8, D, Dv, 32) > size_t(BLOCK_SMEM) &&\n"
         "      dq_smem(8, D, Dv, 24) <= size_t(BLOCK_SMEM)) {\n"
         "    *warps = 8;\n    *bk = 24;\n    return;\n  }\n"
         "  for (int w = 8; w >= 4; w /= 2)\n    for (int k = 32; k >= 16; "
         "k /= 2)"),
        ("return bk == 32 ? launch<N, 32>(p, kvw, dqw, stream)",
         "return bk == 24 ? launch<N, 24>(p, kvw, dqw, stream) : "
         "bk == 32 ? launch<N, 32>(p, kvw, dqw, stream)")]),
    "dq_bk64": ("flash_attention_bwd", [
        ("*bk = 32;\n  if (two_fit(dq_smem(4, D, Dv, 32))) return;",
         "*bk = 64;\n  if (two_fit(dq_smem(4, D, Dv, 64))) return;\n"
         "  *bk = 32;\n  if (two_fit(dq_smem(4, D, Dv, 32))) return;"),
        ("return bk == 32 ? launch<N, 32>(p, kvw, dqw, stream)",
         "return bk == 64 ? launch<N, 64>(p, kvw, dqw, stream) : "
         "bk == 32 ? launch<N, 32>(p, kvw, dqw, stream)")]),
}
#: (name, B, H, K, S, D, Dv)
_FWD = [("phi3", 1, 32, 32, 512, 96, 96), ("MLA", 1, 128, 128, 512, 192, 128)]
_BWD = [("small", 1, 8, 2, 512, 64, 64), ("minicpm", 4, 36, 36, 1024, 64, 64),
        ("MLA", 1, 128, 128, 2048, 192, 128)]


def _close(name, got, want) -> float:
    err = (got - want).abs()
    if bool((err > 2e-5 + 2e-5 * want.abs()).any()):
        raise AssertionError(f"probe: {name} disagrees with the plain "
                             f"version, max {float(err.max())}")
    return float(err.max())


def _fwd_call(lib, q, k, v, out):
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, 0, B,
        H, K, S, S, D, Dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        1, 0, 0, None, D ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: {err}")


def _bwd_call(lib, q, k, v, out, dout, lse, scratch, grads):
    B, S, H, D = q.shape
    K, Dv = k.shape[2], v.shape[3]
    delta, dk_ws, dv_ws = scratch
    err = lib.flash_attention_bwd(
        *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, *grads)),
        None if dk_ws is None else dk_ws.data_ptr(),
        None if dv_ws is None else dv_ws.data_ptr(),
        0, B, H, K, S, S, D, Dv, 1, 0, D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: {err}")


def _turns(libs, fn, flush) -> dict:
    """The ms of ``fn(lib)`` for each library in its two turns (base, the
    variants, the variants reversed, base)."""
    order = list(libs) + list(libs)[::-1]
    times = {n: [] for n in libs}
    for n in order:
        times[n].append(_device_ms(lambda: fn(libs[n]), flush))
    return times


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variants", default=",".join(_VARIANTS),
                   help=f"comma-separated, of {', '.join(_VARIANTS)}")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_f32 needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    names = [n for n in args.variants.split(",") if n]
    print(f"{torch.cuda.get_device_name(0)}; variants {names}")
    for src, symbol, argtypes, shapes in [
            ("flash_attention", "flash_attention_fwd", ops._ARGTYPES, _FWD),
            ("flash_attention_bwd", "flash_attention_bwd", ops._BWD_ARGTYPES,
             _BWD)]:
        base = (_build._CSRC / f"{src}.cu").read_text()
        texts = {f"{src}_base": base}
        for n in names:
            if _VARIANTS[n][0] != src:
                continue
            text = base
            for old, new in _VARIANTS[n][1]:
                text = _sub(text, old, new)
            texts[f"{src}_{n}"] = text
        if len(texts) == 1:
            continue
        libs = _build_copies(texts, symbol, argtypes)
        for name, B, H, K, S, D, Dv in shapes:
            def randn(*sh):
                return torch.randn(sh, generator=gen, device=dev)
            q, k, v = randn(B, S, H, D), randn(B, S, K, D), randn(B, S, K, Dv)
            if src == "flash_attention":
                out = torch.empty((B, S, H, Dv), device=dev)
                want = flash_attention_plain(q, k, v, scale=D ** -0.5)

                def fn(lib):
                    _fwd_call(lib, q, k, v, out)
                errs = {}
                for n, lib in libs.items():
                    fn(lib)
                    torch.cuda.synchronize()
                    errs[n] = _close(n, out, want)
                del want
            else:
                dout = randn(B, S, H, Dv)
                out, lse = (t.contiguous() for t in flash_attention_plain(
                    q, k, v, scale=D ** -0.5, with_lse=True))
                want = flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                                 scale=D ** -0.5)
                grads = [torch.empty_like(t) for t in (q, k, v)]
                scratch = (torch.empty((B, H, S), device=dev),
                           *(torch.empty((B, S, H, w), device=dev)
                             if H > K else None for w in (D, Dv)))

                def fn(lib):
                    _bwd_call(lib, q, k, v, out, dout, lse, scratch, grads)
                errs = {}
                for n, lib in libs.items():
                    fn(lib)
                    torch.cuda.synchronize()
                    errs[n] = max(_close(n, g, w) for g, w in zip(grads, want))
                del want
            print(f"  {name} B={B} H={H} K={K} S={S} D={D} Dv={Dv}: max err "
                  f"{errs}; ms in two turns each "
                  f"{_turns(libs, fn, flush)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
