"""BENCHMARK.json against the files it names, and the import check."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
DOC = harness.manifest()


def test_manifest_has_the_contract_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", DOC["workloads"], ids=lambda c: c["name"])
def test_every_cell_finds_its_pieces_by_name(cell):
    cfg = harness.config(cell["config"])
    mix = harness.traffic(cell["traffic"])
    assert cfg["name"] == cell["config"]
    assert callable(harness.driver(mix["driver"]).run)
    assert harness.limits(cell["name"])
    reported = harness.cell_metrics(DOC, cell["name"], "end_to_end")
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(DOC, cell["name"], "per_layer")


@pytest.mark.parametrize("entry", DOC["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(entry):
    reader = harness.metric_reader(entry["name"])
    assert reader.LAYER == entry["layer"]
    assert reader.UNIT == entry["unit"]
    assert reader.MOVES == entry["moves"]
    assert reader.read(None) is None
    assert reader.read(harness.Reading()) is None
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    for cell in entry.get("workloads", []):
        assert cell in e2e[entry["moves"]].get("workloads", [cell])


def test_a_per_layer_metric_without_workloads_goes_where_its_moves_goes():
    # The contract lets a later entry leave out ``workloads``: it is then
    # reported in every cell that reports the end-to-end metric it moves.
    doc = {"end_to_end": [{"name": "rate", "workloads": ["a"]},
                          {"name": "setup_s"}],
           "per_layer": [{"name": "listed", "moves": "rate",
                          "workloads": ["a"]},
                         {"name": "follows", "moves": "rate"},
                         {"name": "everywhere", "moves": "setup_s"}]}
    names = {cell: [m["name"] for m in harness.cell_metrics(
        doc, cell, "per_layer")] for cell in ("a", "b")}
    assert names == {"a": ["listed", "follows", "everywhere"],
                     "b": ["everywhere"]}


def test_names_units_and_bounds_keep_the_contract_form():
    entries = (DOC["configs"] + DOC["workloads"] + DOC["end_to_end"]
               + DOC["per_layer"])
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in DOC["per_layer"]}
    assert all(0 < len(layer) <= 200 and "\n" not in layer
               for layer in layers)


def test_config_files_lie_under_paths_and_reduce_nothing():
    for cfg in DOC["configs"]:
        assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
        assert cfg["reduced"] == []
        assert json.loads((harness.ROOT / cfg["file"]).read_text())


def test_the_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["kubeflow_tpu_torch", "kubeflow_tpu_torch.models", "torch",
         "numpy", "jaxtyping", "optax_like"]) == []
    assert harness.forbidden_modules(
        ["kubeflow_tpu", "kubeflow_tpu.models", "torch"]) == ["kubeflow_tpu"]
    assert harness.forbidden_modules(
        ["jax._src.core", "jaxlib", "flax.linen", "optax"]) == [
            "flax", "jax", "jaxlib", "optax"]


def test_the_harness_itself_loads_no_jax():
    import sys

    for name in ("benchmark.run", "benchmark.drivers.train_lm",
                 "benchmark.drivers.train_image",
                 "benchmark.drivers.train_image_dp", "benchmark.world",
                 "benchmark.tools.readings"):
        __import__(name)
    assert harness.forbidden_modules(
        [m for m in sys.modules if m.startswith("benchmark")]) == []


def _run(cwd):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "lm-train-2k-packed", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_run_with_only_the_benchmark_exits_non_zero(tmp_path):
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
