"""The port's serving engine against the JAX package's: the same requests
give the same greedy tokens for phi3-mini, recurrentgemma, llama4, the
dense families, xLSTM, deepseek-v2, qwen2-vl and musicgen, inline and
under the port's executor; a slot
reused after a reset serves as a fresh one; and the port stands alone —
no module of it imports JAX or the JAX package."""
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
from repro.configs.base import LayerGroup  # noqa: E402
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


#: xLSTM's parity stack: the reference's canary (one mLSTM and one sLSTM
#: block, twice).  The reduced config's 16 blocks turn a last-bit
#: difference into logit differences past a greedy margin
#: (tests/test_torch_models.py, XLSTM_STACK and the test beside it)
XLSTM_STACK = {"groups": (LayerGroup(pattern=("mlstm", "slstm"), count=2,
                                     ffn="none"),)}


def _family_cfgs(arch):
    kw = XLSTM_STACK if arch == "xlstm-1.3b" else {}
    return (dataclasses.replace(reduced(get_config(arch)),
                                compute_dtype="float32", **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)),
                                compute_dtype="float32", **kw))


@pytest.fixture(scope="module",
                params=["recurrentgemma-2b", "llama4-maverick-400b-a17b",
                        "minicpm-2b", "deepseek-coder-33b",
                        "mistral-large-123b", "xlstm-1.3b",
                        "deepseek-v2-236b", "qwen2-vl-7b", "musicgen-large"])
def family(request):
    """A reduced recurrent, MoE, dense, xLSTM, MLA, M-RoPE or audio model
    in both packages,
    and the JAX engine's tokens for PROMPTS (max_seq 48: recurrentgemma's
    ring of 32 rows wraps on the longest request; four requests on two
    slots, so two slots are reset and reused)."""
    jcfg, tcfg = _family_cfgs(request.param)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    eng = JaxEngine(jcfg, jp, max_slots=2, max_seq=48)
    for p in FAMILY_PROMPTS:
        eng.submit(p, max_new_tokens=6)
    return tcfg, tp, {r.id: r.generated for r in eng.run()}


FAMILY_PROMPTS = [np.arange(3 + 9 * i) * 7 % 256 for i in range(4)]


@pytest.mark.parametrize("workers", [None, 1, 2])
def test_family_engine_matches_jax_engine(family, workers):
    """Each family, inline and under the executor: the JAX engine's
    greedy tokens."""
    tcfg, tp, want = family

    def run(executor=None):
        eng = ServingEngine(tcfg, tp, max_slots=2, max_seq=48,
                            executor=executor)
        for p in FAMILY_PROMPTS:
            eng.submit(p, max_new_tokens=6)
        return {r.id: r.generated for r in eng.run()}

    if workers is None:
        got = run()
    else:
        with Executor(num_workers=workers, devices=[CPU]) as ex:
            got = run(ex)
    assert got == want
    assert all(len(t) == 6 for t in got.values())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_reused_slot_serves_as_a_fresh_engine(arch):
    """A slot whose last occupant left recurrent state and k/v rows
    behind serves the next request as a fresh engine does: admission
    resets the slot's cache to what init_cache gives."""
    _, tcfg = _family_cfgs(arch)
    from repro_torch.models import init_params as tinit
    tp = tinit(tcfg, torch.Generator().manual_seed(0), CPU)
    first, second = FAMILY_PROMPTS[3], FAMILY_PROMPTS[1]
    eng = ServingEngine(tcfg, tp, max_slots=1, max_seq=48)
    eng.submit(first, max_new_tokens=6)
    eng.submit(second, max_new_tokens=6)
    reused = {r.id: r.generated for r in eng.run()}[1]
    fresh = ServingEngine(tcfg, tp, max_slots=1, max_seq=48)
    fresh.submit(second, max_new_tokens=6)
    assert fresh.run()[0].generated == reused
    assert eng.decode_graphs is None          # the CPU engine is eager


@pytest.mark.parametrize("arch", ["recurrentgemma-2b",
                                  "llama4-maverick-400b-a17b",
                                  "xlstm-1.3b", "deepseek-v2-236b",
                                  "qwen2-vl-7b", "musicgen-large"])
def test_serve_launcher_on_cpu_for_the_new_families(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch, "--reduced", "--requests", "3",
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
