"""The port's bench (``kubeflow_tpu_torch/bench.py``) at
``KFT_BENCH_PRESET=cpu-mini`` on the CPU (``--device cpu``), in-process.

Each mode prints exactly one JSON line whose records pass both
packages' ``validate_record``, carry the JAX bench's metric names and
section keys, name torch (not jax) in their provenance, and have a null
``vs_baseline`` unless an anchor env var is set. The combined run
measures every section of the JAX bench (``bench.py``), in its order,
and no section fails. A failing section is recorded, not raised.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from kubeflow_tpu.obs import perfwatch as ref_perfwatch
from kubeflow_tpu_torch import bench
from kubeflow_tpu_torch.obs import perfwatch

# The JAX bench's sections after ResNet (bench.py main), in its order.
SECTIONS = [
    "lm_train_tokens_per_sec_per_chip",
    "lm_long_context_tokens_per_sec_per_chip",
    "lm_long_context_32k_tokens_per_sec_per_chip",
    "lm_sliding_window_tokens_per_sec_per_chip",
    "lm_decode_tokens_per_sec_per_chip[b1]",
    "lm_decode_tokens_per_sec_per_chip[b8]",
    "lm_moe_tokens_per_sec_per_chip",
    "lm_moe_ec_tokens_per_sec_per_chip",
    "lm_decode_tokens_per_sec_per_chip[b1-p8k]",
    "lm_decode_tokens_per_sec_per_chip[b1-p32k]",
    "lm_decode_tokens_per_sec_per_chip[b8-p8k]",
    "lm_decode_tokens_per_sec_per_chip[b8-p8k-int8]",
    "lm_decode_tokens_per_sec_per_chip[b1-p8k-w1k]",
    "lm_decode_tokens_per_sec_per_chip[b1-p32k-w1k]",
    "lm_decode_tokens_per_sec_per_chip[b1-w8]",
    "lm_decode_tokens_per_sec_per_chip[b1-p8k-w8]",
    "lm_decode_tokens_per_sec_per_chip[spec-b1]",
    "lm_decode_tokens_per_sec_per_chip[spec-b1-p8k]",
]


@pytest.fixture
def mini(monkeypatch):
    """cpu-mini, no anchors, a fresh round context; the bench's globals
    and torch's thread count restored after (the tests share the host
    with other test processes)."""
    monkeypatch.setenv("KFT_BENCH_PRESET", "cpu-mini")
    for key in [k for k in os.environ
                if k.startswith("KFT_BENCH_") and k != "KFT_BENCH_PRESET"]:
        monkeypatch.delenv(key)
    monkeypatch.setattr(bench, "_ROUND_CONTEXT", None)
    monkeypatch.setattr(bench, "_DEVICE", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield monkeypatch
    torch.set_num_threads(threads)


def _run(capsys, mode, mini, argv=("--device", "cpu")):
    mini.setenv("KFT_BENCH_MODE", mode)
    code = bench.main(list(argv))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0]), code


def _check(record):
    assert perfwatch.validate_record(record) == []
    assert ref_perfwatch.validate_record(record) == []
    prov = record["provenance"]
    assert prov["torch"] == torch.__version__ and "jax" not in prov
    assert prov["platform"] == "cpu" and prov["device"] == "cpu"
    assert prov["env"] == {"KFT_BENCH_PRESET": "cpu-mini"}
    assert record["vs_baseline"] is None
    assert record["device"] == "cpu"


@pytest.mark.parametrize("mode,metric,section", [
    ("lm", "lm_train_tokens_per_sec_per_chip", "train"),
    ("resnet", "resnet50_train_images_per_sec_per_chip", "resnet"),
])
def test_mode_prints_one_valid_record(capsys, mini, mode, metric, section):
    mini.setenv("KFT_BENCH_STEPS", "1")      # ResNet-50's 3 trials of 1 step
    record, code = _run(capsys, mode, mini)
    assert code == 0
    _check(record)
    assert record["metric"] == metric and record["section"] == section
    assert record["value"] > 0 and record["band"]["n"] == 3
    assert 0 < record["mfu"] < 1
    assert set(record["kernel_launches"]) == {
        "flash_attention", "flash_dq", "flash_dkv", "gemv", "qkv_rope",
        "decode_attention", "split3", "bn_stats", "bn_apply", "bn_grad_sums",
        "bn_dx"}
    if mode == "resnet":
        assert record["vs_measured_ref"] > 0
        assert record["unit"] == "images/sec/chip"


def test_an_anchor_env_var_sets_vs_baseline(capsys, mini):
    mini.setenv("KFT_BENCH_LM_ANCHOR", "1000")
    record, _ = _run(capsys, "lm", mini)
    assert record["vs_baseline"] == round(record["value"] / 1000, 4)


def test_telemetry_knob_observes_every_timed_step(capsys, mini):
    mini.setenv("KFT_BENCH_TELEMETRY", "1")
    mini.setenv("KFT_BENCH_SKIP_MEASURED_REF", "1")
    mini.setenv("KFT_BENCH_STEPS", "2")
    record, _ = _run(capsys, "resnet", mini)
    summary = record["step_telemetry"]
    assert summary["steps"] == 3 * record["steps"]
    assert summary["device"] == "cpu" and summary["mfu"] > 0
    # The step's own spans land in the active profiler beside the bench's.
    assert set(record["phases"]) == {"dispatch", "sync", "train.step",
                                     "train.forward", "train.backward",
                                     "train.optimizer"}


def test_combined_run_measures_every_section_of_the_jax_bench(capsys, mini):
    mini.setenv("KFT_BENCH_TIMING_REPS", "1")
    mini.setenv("KFT_BENCH_SKIP_MEASURED_REF", "1")
    record, code = _run(capsys, "all", mini)
    assert code == 0
    _check(record)
    extras = record["extra_metrics"]
    assert not [e for e in extras if e["metric"] == "bench_extra_error"]
    assert [e["metric"] for e in extras] == [s.split("[")[0]
                                             for s in SECTIONS]
    assert [e["section"] for e in extras] == [bench._section_key(s)
                                              for s in SECTIONS]
    for extra in extras:
        _check(extra)
    assert len(perfwatch.records_from_full(record)) == 1 + len(SECTIONS)


def test_a_failing_section_is_recorded_by_name(capsys, mini):
    def boom(**kw):
        raise RuntimeError("out of memory")

    mini.setattr(bench, "bench_decode_spec", boom)
    mini.setattr(bench, "bench_decode", boom)
    mini.setattr(bench, "bench_lm", boom)
    mini.setenv("KFT_BENCH_SKIP_MEASURED_REF", "1")
    record, code = _run(capsys, "all", mini)
    assert code == 3                     # the LM section is mandatory
    errors = [e for e in record["extra_metrics"]
              if e["metric"] == "bench_extra_error"]
    assert [e["section"] for e in errors] == SECTIONS
    assert errors[0]["error"] == "RuntimeError: out of memory"
