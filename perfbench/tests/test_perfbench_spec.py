"""BENCHMARK.json against the benchmark's contract, and the harness
finding a configuration, a mix and a metric by name."""
import json
import re
import shutil

import pytest

from perfbench import spec

BENCH = spec.load()
ALLOWED_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
                "end_to_end", "per_layer"}
LINE = re.compile(r"^[^\t\n]{1,200}$")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_command_and_paths():
    assert set(BENCH) == ALLOWED_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (spec.ROOT / p).is_dir()
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield group, entry


@pytest.mark.parametrize("group,entry", list(_names()),
                         ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_names_units_and_keys_use_allowed_characters(group, entry):
    assert NAME.match(entry["name"])
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[group]
    assert set(entry) - {"workloads"} == keys
    if group in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    if group == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    if group == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert LINE.match(entry["layer"])
        if entry["name"].split(".")[0].endswith("_roofline") \
                or "mfu" in entry["name"]:
            assert entry["unit"] == "%"
    if group == "configs":
        assert len(entry["reduced"]) <= 16
        for k in entry["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(_dim|_rank|hidden|intermediate|_size|"
                                 r"heads|factor)", k)
        assert LINE.match(entry["source"])
    if group == "workloads":
        assert entry["chips"] == 1
        assert NAME.match(entry["config"])
        assert NAME.match(entry["traffic"])
    if "why" in entry:
        assert LINE.match(entry["why"])


def test_names_are_unique_and_files_are_where_the_names_say():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(cfg["source_keys"])
        assert (spec.HERE / "reference" / f"{cfg['reference']}.py").exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["per_layer"]:
        assert (spec.HERE / "metrics" / f"{m['name']}.py").exists()
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_set_up_another_metric_and_a_layer(workload):
    cell = spec.cell(BENCH, workload)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        spec.metric_reader(m["name"])
    # a kernel's roofline has a whole step's MFU beside it, moving the
    # same end-to-end metric
    for m in cell.per_layer:
        if "_roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in cell.per_layer)


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    here = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    cfg = json.loads((here / "configs" / "phi3-mini-3.8b.json").read_text())
    cfg["n_layers"] = 3
    (here / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = {"kind": "open_loop", "rate_per_s": 1.0}
    (here / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return 41.5\n")
    bench = {"configs": [{"name": "new-model",
                          "file": "perfbench/configs/new-model.json"}],
             "workloads": [{"name": "new.cell", "config": "new-model",
                            "traffic": "new_mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "new_metric.x", "unit": "%",
                            "moves": "setup_s", "workloads": ["new.cell"]}]}
    cell = spec.cell(bench, "new.cell", here=here)
    assert cell.config["n_layers"] == 3 and cell.traffic == mix
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    assert spec.metric_reader("new_metric.x", here=here)(None) == 41.5
    with pytest.raises(KeyError):
        spec.cell(bench, "no.such.cell", here=here)


def test_limits_files_hold_both_readings_and_a_limit_between():
    for w in BENCH["workloads"]:
        limits = spec.cell(BENCH, w["name"]).limits
        assert limits, w["name"]
        for name, entry in limits.items():
            assert entry["lower"] < entry["limit"] < entry["upper"], \
                (w["name"], name)
