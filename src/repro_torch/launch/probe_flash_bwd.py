"""Where the bf16 flash backward's time goes, on CUDA.

    PYTHONPATH=src python -m repro_torch.launch.probe_flash_bwd \
        [--passes] [--stamps] [--variants no_exp2,no_convert,...]

``--passes``: each pass's device time (``torch.profiler``) at minicpm-2b's
heads (B 4, H = K = 36, D 64) for S 512, 1024 and 2048, and at
recurrentgemma-2b's train shape.  ``--stamps``: a copy of
``csrc/flash_attention_bwd.cu`` with ``clock64`` sums per phase of the
tensor-core passes (warp 0 of each consumer warpgroup), built beside the
package's library and run at the two train shapes; prints cycles a tile.
``--variants``: copies with one kind of work changed, timed in turns
(base, variants, variants reversed, base; median of 15 launches each, L2
flushed) at minicpm's shape:

- ``no_exp2``: ``ex2`` returns its argument (timing only);
- ``no_convert``: the bf16 hi/lo split by truncation, no conversions
  (timing only);
- ``no_reg_products``: no dV, dK, dQ products (timing only);
- ``no_smem_products``: no S and dP products (timing only);
- ``dq_three_warpgroups``: three dQ consumer warpgroups of 64 rows at D
  64, 160 registers each (checked against the plain version).

The copies are patched from the source's text, so a patch whose anchor
is gone raises.  Builds go to ``build/probe/``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess

import torch

from ..kernels import _build, flash_attention, flash_attention_bwd_plain
from ..kernels.flash_attention import ops

__all__ = ["main", "pass_ms"]

_SRC = _build._CSRC / "flash_attention_bwd.cu"
_OUT = _build._BUILD_DIR.parent / "probe"
#: (B, H, K, S, D, window) of minicpm-2b's and recurrentgemma-2b's training
MINICPM = (4, 36, 36, 1024, 64, None)
RECURRENTGEMMA = (1, 10, 1, 3072, 256, 2048)


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"probe_flash_bwd: the source no longer has "
                           f"{old[:60]!r}")
    return text.replace(old, new, 1)


_STAMP_MACROS = """
__device__ unsigned long long g_st[2][2048][2][8];
#define STAMP_DECL unsigned long long st_acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}; \\
  unsigned long long st_last = clock64();
#define STAMP(i) { const unsigned long long t_ = clock64(); \\
  st_acc[i] += t_ - st_last; st_last = t_; }
#define STAMP_SAVE(k, w) { const int blk_ = blockIdx.x + gridDim.x * \\
  (blockIdx.y + gridDim.y * blockIdx.z); \\
  if (threadIdx.x % 128 == 0 && blk_ < 2048) \\
    for (int i_ = 0; i_ < 8; ++i_) g_st[k][blk_][w][i_] = st_acc[i_]; }
"""
#: phase names of the stamps: (pass, warpgroup) -> phases 0..n-1; the
#: eighth sum counts tiles
_PHASES = {("dK/dV", 0): ["wait", "S", "P (exp2, masks)", "wait Pt empty",
                          "Pt out, split", "dV"],
           ("dK/dV", 1): ["wait", "dP", "wait Pt full", "dS, split", "dK"],
           ("dQ", 0): ["wait", "S, dP", "dS, split", "dQ", "arrive"]}
_PHASES[("dQ", 1)] = _PHASES[("dQ", 0)]


def _stamped(s: str) -> str:
    s = _sub(s, "namespace tc {\n\nusing namespace hopper;\n",
             "namespace tc {\n\nusing namespace hopper;\n" + _STAMP_MACROS)
    for old, new in [
            # dQ
            ("  mbar_wait(q_full, 0);\n  for (int i = 0; i < n_tiles; ++i) {",
             "  mbar_wait(q_full, 0);\n  STAMP_DECL\n"
             "  for (int i = 0; i < n_tiles; ++i) {"),
            ("    mbar_wait(full + 8 * s, (i / ST) & 1);\n    if (!skip) {",
             "    mbar_wait(full + 8 * s, (i / ST) & 1);\n    STAMP(0)\n"
             "    if (!skip) {"),
            ("      fence_regs(x);\n      fence_regs(dp);\n",
             "      fence_regs(x);\n      fence_regs(dp);\n      STAMP(1)\n"),
            ("      split_frags(x, hi, lo);\n"
             "      product_rs<NC>(dq, hi, lo, ks);\n    }\n",
             "      split_frags(x, hi, lo);\n      STAMP(2)\n"
             "      product_rs<NC>(dq, hi, lo, ks);\n      STAMP(3)\n    }\n"),
            ("    if (lane == 0) mbar_arrive(empty + 8 * s);\n  }\n  if (live)",
             "    if (lane == 0) mbar_arrive(empty + 8 * s);\n    STAMP(4)\n"
             "    st_acc[7] += 1;\n  }\n  STAMP_SAVE(1, wg)\n  if (live)"),
            # dK/dV, warpgroup 0
            ("    float dv[NCV][32];\n    zero(dv);\n",
             "    float dv[NCV][32];\n    zero(dv);\n    STAMP_DECL\n"),
            ("      mbar_wait(full + 8 * s, (i / ST) & 1);\n      float x[32];\n"
             "      wgmma_fence();\n      product_ss<NC>(x, sk,",
             "      mbar_wait(full + 8 * s, (i / ST) & 1);\n      STAMP(0)\n"
             "      float x[32];\n      wgmma_fence();\n"
             "      product_ss<NC>(x, sk,"),
            ("      fence_regs(x);\n      // x[4j + e] is (kv row r0",
             "      fence_regs(x);\n      STAMP(1)\n"
             "      // x[4j + e] is (kv row r0"),
            ("      if (i > 0) bar_sync(BAR_P_EMPTY, 256);\n",
             "      STAMP(2)\n      if (i > 0) bar_sync(BAR_P_EMPTY, 256);\n"
             "      STAMP(3)\n"),
            ("      split_frags(x, hi, lo);\n"
             "      product_rs<NCV>(dv, hi, lo, dos);\n",
             "      split_frags(x, hi, lo);\n      STAMP(4)\n"
             "      product_rs<NCV>(dv, hi, lo, dos);\n      STAMP(5)\n"
             "      st_acc[7] += 1;\n"),
            ("    if (gqa)\n      store_rows<NCV>(dv,",
             "    STAMP_SAVE(0, 0)\n    if (gqa)\n      store_rows<NCV>(dv,"),
            # dK/dV, warpgroup 1
            ("    float dk[NC][32];\n    zero(dk);\n",
             "    float dk[NC][32];\n    zero(dk);\n    STAMP_DECL\n"),
            ("      mbar_wait(full + 8 * s, (i / ST) & 1);\n      float x[32];\n"
             "      wgmma_fence();\n      product_ss<NCV>(x, sv,",
             "      mbar_wait(full + 8 * s, (i / ST) & 1);\n      STAMP(0)\n"
             "      float x[32];\n      wgmma_fence();\n"
             "      product_ss<NCV>(x, sv,"),
            ("      bar_sync(BAR_P_FULL, 256);\n",
             "      STAMP(1)\n      bar_sync(BAR_P_FULL, 256);\n"
             "      STAMP(2)\n"),
            ("      split_frags(x, hi, lo);\n"
             "      product_rs<NC>(dk, hi, lo, qs);\n",
             "      split_frags(x, hi, lo);\n      STAMP(3)\n"
             "      product_rs<NC>(dk, hi, lo, qs);\n      STAMP(4)\n"
             "      st_acc[7] += 1;\n"),
            ("    if (gqa)\n      store_rows<NC>(dk,",
             "    STAMP_SAVE(0, 1)\n    if (gqa)\n      store_rows<NC>(dk,")]:
        s = _sub(s, old, new)
    return s + """
extern "C" int read_stamps(void* out) {
  return int(cudaMemcpyFromSymbol(out, tc::g_st, sizeof(tc::g_st)));
}
extern "C" int clear_stamps(const void* zeros) {
  return int(cudaMemcpyToSymbol(tc::g_st, zeros, sizeof(tc::g_st)));
}
"""


_SPLIT = """      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(a - __low2float(h), b - __high2float(h));"""
_TRUNCATED_SPLIT = """      const uint32_t ua = __float_as_uint(a) & 0xffff0000u;
      const uint32_t ub = __float_as_uint(b) & 0xffff0000u;
      hi[kk][r] = __byte_perm(ua, ub, 0x7632);
      lo[kk][r] = __byte_perm(__float_as_uint(a - __uint_as_float(ua)),
                              __float_as_uint(b - __uint_as_float(ub)),
                              0x7632);"""
_HEAD = "using namespace hopper;\n"
#: variant -> (patches, whether its results are checked)
_VARIANTS = {
    "no_exp2": ([(_HEAD, _HEAD + "#define ex2(x) (x)\n")], False),
    "no_convert": ([(_SPLIT, _TRUNCATED_SPLIT)], False),
    "no_reg_products": ([(
        "  wgmma_fence();\n#pragma unroll\n  for (int c = 0; c < N; ++c) {",
        "  if (hi[0][0] != 0x12345678u) return;\n  wgmma_fence();\n"
        "#pragma unroll\n  for (int c = 0; c < N; ++c) {")], False),
    "no_smem_products": ([(
        "    const uint32_t off = (kk % 4) * 32;  // 16 columns of a box\n",
        "    const uint32_t off = (kk % 4) * 32;  // 16 columns of a box\n"
        "    if (kk == 0)\n      for (int i = 0; i < 32; ++i) d[i] = 0.01f * i;"
        "\n    if (a != 0x7fffffffu) continue;\n")], False),
    "dq_three_warpgroups": ([
        ("      2048 + 4 * (NC + NCV) * BT * ROW_BYTES <= SMEM_MAX ? 2 : 1;",
         "      NC + NCV == 2 ? 3\n"
         "      : 2048 + 4 * (NC + NCV) * BT * ROW_BYTES <= SMEM_MAX ? 2 : 1;"),
        ('  if constexpr (CONS > 1)\n'
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");',
         '  if constexpr (CONS == 3)\n'
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\\n");\n'
         '  else if constexpr (CONS == 2)\n'
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");')],
        True),
}


def _build_copies(texts: dict[str, str], symbol: str = "flash_attention_bwd",
                  argtypes=None) -> dict[str, ctypes.CDLL]:
    """Compile each text as its own library (one nvcc each, together),
    with ``symbol`` bound to ``argtypes`` (the backward's by default)."""
    _OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (_OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(_SRC.parent), "-o",
             str(_OUT / f"lib{name}.so"), str(_OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str((_OUT / f"lib{name}.so").resolve()))
        fn = getattr(libs[name], symbol)
        fn.argtypes = ops._BWD_ARGTYPES if argtypes is None else argtypes
        fn.restype = ctypes.c_int
    return libs


class _Case:
    """The inputs of one backward call and its launch through a library."""

    def __init__(self, shape, gen, dev):
        B, H, K, S, D, self.win = shape
        self.shape = shape

        def randn(*sh):
            return torch.randn(sh, generator=gen, device=dev).to(
                torch.bfloat16)
        self.q, self.k, self.v = randn(B, S, H, D), randn(B, S, K, D), \
            randn(B, S, K, D)
        self.dout = randn(B, S, H, D)
        self.out, self.lse = flash_attention(self.q, self.k, self.v,
                                             window=self.win, with_lse=True)
        self.grads = [torch.empty_like(t) for t in (self.q, self.k, self.v)]
        self.delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
        self.ws = [torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
                   if H > K else None for _ in range(2)]

    def call(self, lib) -> None:
        B, H, K, S, D, win = self.shape
        err = lib.flash_attention_bwd(
            *(t.data_ptr() for t in (self.q, self.k, self.v, self.out,
                                     self.dout, self.lse, self.delta,
                                     *self.grads)),
            *(None if w is None else w.data_ptr() for w in self.ws),
            1, B, H, K, S, S, D, D, 1, win or 0, D ** -0.5,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd launch failed: {err}")

    def max_err(self) -> float:
        """The largest error against the plain version; raises past the
        card check (2e-5 + 2^-8·|ref|)."""
        want = flash_attention_bwd_plain(
            *(t.float() for t in (self.q, self.k, self.v, self.out,
                                  self.dout)), self.lse, window=self.win)
        worst = 0.0
        for g, w in zip(self.grads, want):
            err = (g.float() - w).abs()
            if bool((err > 2e-5 + 2.0 ** -8 * w.abs()).any()):
                raise AssertionError(f"probe: a variant disagrees with the "
                                     f"plain version, max {float(err.max())}")
            worst = max(worst, float(err.max()))
        return worst


def _device_ms(fn, flush, reps: int = 15) -> float:
    """Median device ms of ``fn`` over ``reps`` launches, each after an L2
    flush and a ~1 ms device sleep (CUDA events)."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def pass_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of each kernel ``fn`` launches (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {re.search(r"(\w+(?:<[^()]*>)?)\(", e.key).group(1):
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.self_device_time_total > 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--passes", action="store_true")
    p.add_argument("--stamps", action="store_true")
    p.add_argument("--variants", default="",
                   help=f"comma-separated, of {', '.join(_VARIANTS)}")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_bwd needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; sources: {_SRC}")
    if args.passes:
        for shape in [(4, 36, 36, 512, 64, None), MINICPM,
                      (4, 36, 36, 2048, 64, None), RECURRENTGEMMA]:
            c = _Case(shape, gen, dev)
            fn = lambda: ops.flash_attention_bwd(  # noqa: E731
                c.q, c.k, c.v, c.out, c.dout, c.lse, window=c.win)
            print(f"B H K S D window {shape}: {_device_ms(fn, flush)} ms; "
                  f"passes {pass_ms(fn)}")
    if args.stamps:
        lib = _build_copies({"stamped": _stamped(_SRC.read_text())})[
            "stamped"]
        lib.read_stamps.argtypes = [ctypes.c_void_p]
        lib.clear_stamps.argtypes = [ctypes.c_void_p]
        for shape in (MINICPM, RECURRENTGEMMA):
            c = _Case(shape, gen, dev)
            st = torch.zeros((2, 2048, 2, 8), dtype=torch.int64)
            lib.clear_stamps(st.data_ptr())
            c.call(lib)
            torch.cuda.synchronize()
            lib.read_stamps(st.data_ptr())
            print(f"B H K S D window {shape}: max err {c.max_err()}")
            for k, pas in enumerate(("dK/dV", "dQ")):
                for w in range(2):
                    a = st[k, :, w].double()
                    tiles = float(a[:, 7].sum())
                    if (pas, w) not in _PHASES or tiles == 0:
                        continue
                    per = (a[:, :7].sum(0) / tiles).tolist()
                    names = _PHASES[(pas, w)]
                    print(f"  {pas} warpgroup {w}, {int(tiles)} tiles of the "
                          f"first 2048 blocks, cycles a tile: "
                          + ", ".join(f"{n} {per[i]:.0f}"
                                      for i, n in enumerate(names))
                          + f"; all {sum(per[:len(names)]):.0f}")
    names = [n for n in args.variants.split(",") if n]
    if names:
        base = _SRC.read_text()
        texts = {"base": base}
        for n in names:
            text = base
            for old, new in _VARIANTS[n][0]:
                text = _sub(text, old, new)
            texts[n] = text
        libs = _build_copies(texts)
        c = _Case(MINICPM, gen, dev)
        for n, lib in libs.items():
            c.call(lib)
            torch.cuda.synchronize()
            checked = n == "base" or _VARIANTS[n][1]
            err = c.max_err() if checked else "not checked (timing only)"
            print(f"  {n}: max err {err}; passes "
                  f"{pass_ms(lambda: c.call(lib))}")
        order = list(libs) + list(libs)[::-1]
        times = {n: [] for n in libs}
        for n in order:
            times[n].append(_device_ms(lambda: c.call(libs[n]), flush))
        print(f"  ms at {MINICPM}, in turns {order}: {times}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
