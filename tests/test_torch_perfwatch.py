"""The bench's measurement protocol: the port (``kubeflow_tpu_torch/obs/
perfwatch.py``) against the JAX package's ``kubeflow_tpu/obs/
perfwatch.py``.

The same value lists give the same nearest-rank percentiles, MAD bands,
outlier rejection and rates; the same host readings the same noise
grade; the same records and anchors the same verdicts and ledger rows.
Each package's ``validate_record`` accepts the other's records. The
provenance differs by design: the port's names torch, CUDA, the platform
and the card, and its comparability fields are those, so a port record
judged against the repo's ``PERF_ANCHORS.json`` (the JAX package's
rounds, opened read-only) reads ``incomparable`` on every section. The
port's CLI has no default paths and writes only where it is told.
"""

from __future__ import annotations

import copy
import json
import os
import pathlib
import sys

import pytest
import torch

from kubeflow_tpu.obs import perfwatch as ref
from kubeflow_tpu_torch.obs import perfwatch as port

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANCHORS = ROOT / "PERF_ANCHORS.json"

VALUE_LISTS = [
    [1.0],
    [3.0, 1.0, 2.0],
    [0.101, 0.099, 0.1, 0.1],
    [10.0, 10.5, 9.5, 10.2, 30.0],          # one straggler
    [5.0, 5.0, 5.0, 5.0, 5.0],              # zero MAD
    [2.0, 2.2, 1.8, 2.1, 1.9, 2.05, 1.95, 9.0, 0.2],
    [0.0, 1.0, 0.0, 1.0],
]


@pytest.mark.parametrize("values", VALUE_LISTS)
def test_band_math_matches_the_reference(values):
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert port.nearest_rank(values, q) == ref.nearest_rank(values, q)
    assert port.median_mad(values) == ref.median_mad(values)
    for floor in (None, 0.02, 0.5):
        assert port.noise_band(values, floor) == ref.noise_band(values, floor)
    for reject in (4.0, 1.0):
        got = port.Measurement.from_values(values, reject=reject)
        want = ref.Measurement.from_values(values, reject=reject)
        assert got.to_dict() == want.to_dict()
        if min(values) > 0:
            assert (got.as_rate(64).to_dict(ndigits=1)
                    == want.as_rate(64).to_dict(ndigits=1))


def test_timed_trials_and_noise_sentinel_match_the_reference():
    def clock_of():
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 3.1])
        return lambda: next(ticks)

    got = port.timed_trials(lambda: None, trials=4, warmup=2,
                            clock=clock_of())
    want = ref.timed_trials(lambda: None, trials=4, warmup=2,
                            clock=clock_of())
    assert got.to_dict() == want.to_dict()
    for load, cpus in ((0.1, 8), (3.0, 8), (20.0, 8), (None, 4)):
        def clock_of2():
            state = {"t": 0.0}

            def clock():
                state["t"] += 1e-6
                return state["t"]
            return clock

        def loadavg(value=load):
            if value is None:
                raise OSError("no loadavg")
            return (value, 0.0, 0.0)

        kw = dict(spin_samples=50, sleeps=3, sleep=lambda s: None,
                  loadavg=loadavg, cpu_count=lambda n=cpus: n)
        assert (port.host_noise_sentinel(clock=clock_of2(), **kw)
                == ref.host_noise_sentinel(clock=clock_of2(), **kw))
    assert port.band_floor_for(None) == ref.band_floor_for(None)
    assert port.BAND_FLOORS == ref.BAND_FLOORS


def _measurement(values=(0.2, 0.21, 0.19)):
    return port.Measurement.from_values(list(values)).as_rate(1000)


def test_provenance_names_torch_cuda_platform_and_card():
    prov = port.provenance(env={"KFT_DECODE_IMPL": "kernel",
                                "KFT_BENCH_PRESET": "cpu-mini",
                                "UNRELATED": "1"}, device="cpu")
    assert prov["torch"] == torch.__version__
    assert prov["cuda"] == torch.version.cuda
    assert prov["platform"] == "cpu" and prov["device"] == "cpu"
    assert prov["env"] == {"KFT_BENCH_PRESET": "cpu-mini",
                           "KFT_DECODE_IMPL": "kernel"}
    assert prov["git_rev"] == ref._git_rev()
    assert "jax" not in prov and "jaxlib" not in prov
    assert port.COMPARABILITY_FIELDS == ("platform", "device", "torch",
                                         "cuda")


def test_provenance_without_torch_reports_no_platform(monkeypatch):
    monkeypatch.delitem(sys.modules, "torch")
    prov = port.provenance(env={})
    assert prov["platform"] is None and prov["torch"] is None


def test_records_validate_in_both_packages():
    noise = ref.host_noise_sentinel(spin_samples=50, sleeps=1)
    mine = port.make_record("train", "lm_train_tokens_per_sec_per_chip",
                            "tokens/sec/chip", _measurement(), noise=noise,
                            extra={"vs_baseline": None})
    theirs = ref.make_record(
        "train", "lm_train_tokens_per_sec_per_chip", "tokens/sec/chip",
        ref.Measurement.from_values([0.2, 0.21, 0.19]).as_rate(1000),
        noise=noise, extra={"vs_baseline": None})
    for record in (mine, theirs):
        assert port.validate_record(record) == []
        assert ref.validate_record(record) == []
    assert mine["provenance"]["torch"] == torch.__version__
    broken = copy.deepcopy(mine)
    broken["band"]["lo"], broken["band"]["hi"] = 2.0, 1.0
    del broken["noise"]
    broken["value"] = -1
    assert port.validate_record(broken) == ref.validate_record(broken)
    assert len(port.validate_record(broken)) == 3
    assert port.validate_record([]) == ref.validate_record([])


def _anchor(value, grade="quiet", band_rel=0.01, prov=None):
    return {"value": value, "unit": "x/s", "band_rel": band_rel,
            "noise_grade": grade, "pinned_round": "r1",
            "provenance": prov if prov is not None else {"platform": "cpu"}}


def _record(value, grade="quiet", rel=0.01, prov=None, section="train"):
    return {"section": section, "value": value, "band": {"rel": rel},
            "noise": {"grade": grade},
            "provenance": prov if prov is not None else {"platform": "cpu"}}


@pytest.mark.parametrize("value,grade", [
    (100.0, "quiet"), (103.9, "quiet"), (104.1, "quiet"), (95.9, "quiet"),
    (96.1, "noisy"), (91.0, "noisy"), (150.0, "loud"), (85.0, None)])
def test_classify_matches_the_reference(value, grade):
    record, anchor = _record(value, grade), _anchor(100.0)
    assert (port.classify(record, anchor).to_dict()
            == ref.classify(record, anchor).to_dict())
    for anchor in (None, _anchor(0), _anchor(100.0, prov={"platform": "tpu"})):
        assert (port.classify(record, anchor).to_dict()
                == ref.classify(record, anchor).to_dict())


def test_judge_records_and_exit_code_match_the_reference():
    anchors = {"anchors": {"train": _anchor(100.0), "moe": _anchor(50.0),
                           "gone": _anchor(7.0)}}
    records = [_record(80.0), _record(52.0, section="moe"),
               _record(9.0, section="new")]
    got = port.judge_records(records, anchors)
    want = ref.judge_records(records, anchors)
    assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
    assert port.verdict_exit_code(got) == ref.verdict_exit_code(want) == 1
    assert [v.render() for v in got] == [v.render() for v in want]


def _port_round(sections) -> list[dict]:
    noise = port.host_noise_sentinel(spin_samples=50, sleeps=1)
    prov = port.provenance(env={"KFT_BENCH_PRESET": "cpu-mini"},
                           device="cpu")
    return [port.make_record(section, "metric", "x/s", _measurement(),
                             noise=noise, prov=prov)
            for section in sections]


def test_a_port_record_against_the_tpu_anchors_is_incomparable():
    before = ANCHORS.read_bytes()
    anchors = port.load_anchors(str(ANCHORS))
    sections = sorted(anchors["anchors"])
    assert sections
    verdicts = port.judge_records(_port_round(sections), anchors)
    assert {v.status for v in verdicts} == {port.INCOMPARABLE}
    assert all("torch" in v.notes for v in verdicts)
    assert port.verdict_exit_code(verdicts) == 0
    # The reference's own engine reads the port's records alike.
    assert {v.status for v in ref.judge_records(
        _port_round(sections), ref.load_anchors(str(ANCHORS)))} == {
        ref.INCOMPARABLE}
    assert ANCHORS.read_bytes() == before


def test_ledger_rows_and_trend_match_the_reference(tmp_path):
    doc = {"metric": "resnet50_train_images_per_sec_per_chip",
           "section": "resnet", "value": 1171.0, "unit": "images/sec/chip",
           "band": {"rel": 0.01}, "noise": {"grade": "quiet"},
           "vs_baseline": None,
           "extra_metrics": [
               {"metric": "lm_train_tokens_per_sec_per_chip",
                "section": "train", "value": 46446.0, "band": {"rel": 0.02},
                "noise": {"grade": "quiet"}},
               {"metric": "bench_extra_error", "section": "moe",
                "error": "x"}]}
    got = port.entries_from_full_record(doc, "h1", source="s")
    want = ref.entries_from_full_record(doc, "h1", source="s")
    assert got == want and len(got) == 2
    assert port.records_from_full(doc) == ref.records_from_full(doc)
    path = str(tmp_path / "ledger.jsonl")
    assert port.append_ledger(path, got) == 2
    assert port.append_ledger(path, got) == 0
    assert port.read_ledger(path) == ref.read_ledger(path)
    assert port.render_trend(port.read_ledger(path)) == ref.render_trend(
        ref.read_ledger(path))
    for bench in sorted(ROOT.glob("BENCH_r*.json")):
        data = json.loads(bench.read_text())
        assert (port.entries_from_bench_round(data, "r")
                == ref.entries_from_driver_round(data, "r"))


def test_cli_takes_explicit_paths_and_writes_only_there(tmp_path, capsys):
    watched = {p: p.stat().st_mtime_ns for p in (
        ANCHORS, ROOT / "PERF_TRAJECTORY.jsonl")}
    record = {**_port_round(["resnet"])[0],
              "extra_metrics": _port_round(["train", "moe"])}
    record_path = tmp_path / "full.json"
    record_path.write_text(json.dumps(record))
    for argv in (["verdict", "--record", str(record_path)],
                 ["ingest", "--record", str(record_path), "--round", "h1"],
                 ["report"]):
        with pytest.raises(SystemExit):
            port.main(argv)                     # no default path
    capsys.readouterr()
    assert port.main(["verdict", "--record", str(record_path), "--anchors",
                      str(ANCHORS)]) == 0
    out = capsys.readouterr().out
    assert "resnet: incomparable" in out and "summary:" in out
    pinned = tmp_path / "anchors.json"
    assert port.main(["pin", "--record", str(record_path), "--round", "h1",
                      "--anchors", str(pinned)]) == 0
    assert sorted(port.load_anchors(str(pinned))["anchors"]) == [
        "moe", "resnet", "train"]
    assert port.main(["verdict", "--record", str(record_path), "--anchors",
                      str(pinned), "--json"]) == 0
    verdicts = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert {v["status"] for v in verdicts} == {port.WITHIN_NOISE}
    ledger = tmp_path / "ledger.jsonl"
    assert port.main(["ingest", "--record", str(record_path), "--round",
                      "h1", "--ledger", str(ledger)]) == 0
    assert port.main(["report", "--ledger", str(ledger)]) == 0
    assert "h1" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == [
        "anchors.json", "full.json", "ledger.jsonl"]
    assert {p: p.stat().st_mtime_ns for p in watched} == watched
