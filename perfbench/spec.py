"""``BENCHMARK.json`` and the files the harness finds by name in it.

- a configuration: ``BENCHMARK.json``'s ``configs[].file``, with its
  plain reference ``reference/<config["reference"]>.py``;
- a traffic mix: ``traffic/<traffic>.json``;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` gives
  the metric's value, or None where the run has nothing to read;
- a cell's correctness limits: ``limits/<workload>.json``.

A later cell, mix or metric is a new file and a new entry; no file here
needs an edit for it.

A configuration file holds the port's architecture (``arch``), its
widths (``d_model``, ``n_layers``, ``n_heads``, ``n_kv_heads``,
``head_dim``, ``d_ff``, ``vocab_size``, ``rope_theta``, ``norm_eps``,
``tie_embeddings``), its dtypes, its reference's name and its
deployment (``serve`` or ``train``).  These keys are optional:

- ``layers``: the layer stack, a list of ``{"pattern": [mixer, ...],
  "count": n, "ffn": "dense" | "moe" | [one a mixer]}`` in the
  port's ``Mixer`` and ``FFN`` names, the groups' layers summing to
  ``n_layers``; without it, ``n_layers`` dense attention layers;
- ``moe``, ``mla``, ``rec``: laid over the port's ``MoEConfig``,
  ``MLAConfig`` and ``RecurrentConfig`` with ``dataclasses.replace``,
  so a key the port lacks raises its ``TypeError``; ``moe.experts_held``
  (the routed experts this chip holds; all where absent) is what the
  yardstick counts a token's routed work by;
- ``tiny``: the keys the CPU tests lay over the file to run it at a
  tiny size, where the tests' dense ``SMALL`` will not do.

:mod:`perfbench.program` builds the port's config from them, and
:mod:`perfbench.costs` counts the stack's FLOPs from the same keys.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One workload with everything the harness reads for it."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict = field(default_factory=dict)

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            f"perfbench.reference.{self.config['reference']}")


def load(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _in(metric: dict, workload: str, e2e_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") in e2e_names if "moves" in metric else True


def cell(bench: dict, workload: str, here: Path = HERE) -> Cell:
    """The cell ``workload`` of ``bench``, its files under ``here``;
    raises on an unknown name or a missing file."""
    try:
        w = next(x for x in bench["workloads"] if x["name"] == workload)
    except StopIteration:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{[x['name'] for x in bench['workloads']]}") from None
    cfg = next(x for x in bench["configs"] if x["name"] == w["config"])
    with open(here.parent / cfg["file"]) as f:
        config = json.load(f)
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = here / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() \
        else {}
    e2e = [m for m in bench["end_to_end"] if _in(m, workload, ())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _in(m, workload, names)]
    return Cell(workload, w["chips"], w["config"], config, w["traffic"],
                traffic, e2e, per_layer, limits)


def metric_reader(name: str, here: Path = HERE):
    """``read`` of ``metrics/<name>.py`` under ``here``."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r}: no reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
