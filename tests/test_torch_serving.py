"""The port's serving engine against the JAX package's: the same requests
give the same greedy tokens, inline and under the port's executor; and the
port stands alone — no module of it imports JAX or the JAX package."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel worker processes, and
# torch's default of one thread per core would crowd the timing-
# sensitive runtime tests running beside these
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import Executor  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ARCH = "phi3-mini-3.8b"
CPU = torch.device("cpu")
PROMPTS = [np.arange(3 + 2 * i) * 7 % 256 for i in range(4)]


@pytest.fixture(scope="module")
def rig():
    jcfg = dataclasses.replace(reduced(get_config(ARCH)),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ARCH)),
                               compute_dtype="float32")
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def jax_tokens(rig):
    jcfg, _, jp, _ = rig
    eng = JaxEngine(jcfg, jp, max_slots=2, max_seq=32)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=4)
    return {r.id: r.generated for r in eng.run()}


def _serve(tcfg, tp, executor=None, **kw):
    eng = ServingEngine(tcfg, tp, max_slots=2, max_seq=32, executor=executor,
                        **kw)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=4)
    return eng, {r.id: r.generated for r in eng.run()}


def test_inline_engine_matches_jax_engine(rig, jax_tokens):
    _, tcfg, _, tp = rig
    eng, got = _serve(tcfg, tp)
    assert got == jax_tokens
    assert all(len(t) == 4 for t in got.values())
    assert eng.arena.pages_in_use == 0


@pytest.mark.parametrize("workers", [1, 2])
def test_engine_under_executor_matches_jax_engine(rig, jax_tokens, workers):
    _, tcfg, _, tp = rig
    with Executor(num_workers=workers, devices=[CPU]) as ex:
        eng, got = _serve(tcfg, tp, executor=ex)
        assert ex.stats()["executed"] == eng.ticks
    assert got == jax_tokens


def test_engine_greedy_determinism_and_oversize(rig):
    _, tcfg, _, tp = rig
    prompt = np.arange(6) % 256
    outs = []
    for _ in range(2):
        eng = ServingEngine(tcfg, tp, max_slots=1, max_seq=64)
        eng.submit(prompt, max_new_tokens=4)
        outs.append(eng.run()[0].generated)
    assert outs[0] == outs[1]
    eng = ServingEngine(tcfg, tp, max_slots=1, max_seq=16)
    eng.submit(np.zeros(30, np.int32), max_new_tokens=4)     # 34 > 16
    done = eng.run()
    assert len(done) == 1 and done[0].generated == []


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                       "--max-new", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("3 requests / 6 tokens")


def _port_modules():
    files = sorted(PORT.rglob("*.py"))
    assert files
    return [".".join(f.relative_to(PORT.parent).with_suffix("").parts)
            .removesuffix(".__init__") for f in files]


def test_port_imports_neither_jax_nor_the_reference():
    """Import every module of the port in a fresh interpreter: neither
    ``jax`` nor ``repro`` may be loaded."""
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                        ROOT / "chip_smoke.py"]))
def test_no_import_statement_names_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"
