"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface — no
PyTorch headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and the flags, so an edit
rebuilds and an unchanged source is compiled once.  Several sources are
compiled by one ``nvcc`` each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

__all__ = ["SOURCES", "build", "function"]

_CSRC = Path(__file__).resolve().with_name("csrc")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: every kernel source of the package, by stem
SOURCES = ("flash_attention", "decode_attention", "rglru_scan", "moe_gating",
           "flash_attention_bwd", "rglru_scan_bwd")

_lock = threading.Lock()
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def _library(name: str) -> Path:
    source = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` that has no current library.

    One ``nvcc`` per source, all started together.  Returns the
    compiler's output (``-Xptxas=-v``: registers, shared memory, spills)
    per source it compiled; raises with that output if one failed.
    """
    jobs = []
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, proc))
    logs, failed = {}, []
    for name, lib, tmp, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, lib)          # atomic: readers never see a part
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel source ``name``, built on first
    use, with its ``argtypes`` declared and an ``int`` result."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(_library(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return fn

