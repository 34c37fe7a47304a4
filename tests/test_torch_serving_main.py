"""The port's pod entrypoint, ``python -m kubeflow_tpu_torch.serving``.

``build_model`` reads the reference's env contract into the same
``LMConfig`` fields as ``kubeflow_tpu/serving/__main__.py`` (the random
weights differ: the reference draws from ``jax.random.key(0)``, the port
from a seeded ``torch.Generator``, so only the config is compared).
``main(device="cpu")`` runs as a real process on a free port: it answers
``/readyz`` and a greedy request equal to ``generate`` on the same
``build_model`` params, and exits 0 on SIGTERM. A named checkpoint
directory raises (restore is a later slice), as does a run with no card.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from kubeflow_tpu.serving.__main__ import build_model as ref_build_model
from kubeflow_tpu_torch.models.decoding import generate
from kubeflow_tpu_torch.serving.__main__ import build_model, main

REPO = Path(__file__).resolve().parent.parent
TINY = {"vocab": 128, "layers": 2, "dim": 64, "heads": 4, "kv_heads": 2}


@pytest.fixture
def restore_port_logger():
    logger = logging.getLogger("kubeflow_tpu_torch")
    handlers, propagate, level = (list(logger.handlers), logger.propagate,
                                  logger.level)
    yield
    logger.handlers[:] = handlers
    logger.propagate, logger.level = propagate, level


@pytest.mark.parametrize("config", [
    {},
    TINY,
    {**TINY, "dtype": "bfloat16"},
    {**TINY, "attn_window": 16, "mlp_ratio": 2},
], ids=["default", "tiny", "bf16", "window"])
def test_build_model_reads_the_reference_config(config):
    env = {"KFT_SERVING_CONFIG": json.dumps(config)} if config else {}
    ref_cfg, _ = ref_build_model(env)
    cfg, params = build_model(env, device="cpu")
    want = dataclasses.asdict(ref_cfg)
    got = dataclasses.asdict(cfg)
    assert jnp.dtype(want.pop("dtype")).name == str(got.pop("dtype")).split(
        ".")[-1]
    assert got == want
    emb = params["embed"]["embedding"]
    assert emb.device.type == "cpu" and emb.dtype == cfg.dtype
    assert tuple(emb.shape) == (cfg.vocab, cfg.dim)


def test_build_model_refuses_a_bad_dtype_and_needs_a_card_by_default():
    with pytest.raises(ValueError, match="torch dtype"):
        build_model({"KFT_SERVING_CONFIG": '{"dtype": "float7"}'},
                    device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model({"KFT_SERVING_CONFIG": json.dumps(TINY)})


def test_main_refuses_a_model_dir_naming_a8(monkeypatch, tmp_path,
                                            restore_port_logger):
    monkeypatch.setenv("KFT_SERVING_MODEL_DIR", str(tmp_path))
    monkeypatch.setenv("KFT_SERVING_CONFIG", json.dumps(TINY))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        main(device="cpu")


def test_main_passes_spec_ngram_to_make_engine(monkeypatch,
                                               restore_port_logger):
    monkeypatch.delenv("KFT_SERVING_MODEL_DIR", raising=False)
    monkeypatch.setenv("KFT_SERVING_CONFIG", json.dumps(TINY))
    monkeypatch.setenv("KFT_SERVING_SPEC_NGRAM", "true")
    with pytest.raises(NotImplementedError, match="speculative"):
        main(device="cpu")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_main_serves_a_pod_and_exits_on_sigterm():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_") and k != "PYTHONPATH"}
    env.update({"KFT_SERVING_CONFIG": json.dumps(TINY),
                "KFT_SERVING_PORT": str(port),
                "KFT_SERVING_MAX_BATCH": "2",
                "KFT_SERVING_MAX_LEN": "64"})
    code = ("from kubeflow_tpu_torch.serving.__main__ import main; "
            "main(device='cpu')")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1].decode()
            try:
                with urllib.request.urlopen(url + "/readyz",
                                            timeout=5) as r:
                    assert json.loads(r.read()) == {"ready": True}
                    break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "pod never got ready"
                time.sleep(0.2)
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": [5, 6, 7], "max_new_tokens": 6,
                             "stream": False}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            payload = json.loads(r.read())
        cfg, params = build_model({"KFT_SERVING_CONFIG": json.dumps(TINY)},
                                  device="cpu")
        want = generate(cfg, params, [[5, 6, 7]], 6, device="cpu")
        assert payload["tokens"] == want[0].tolist()
        assert payload["reason"] == "length"
        with urllib.request.urlopen(url + "/v1/status", timeout=10) as r:
            status = json.loads(r.read())
        assert status["autopilot"]["actuators"] == ["gateway-admission"]
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err.decode()
        logged = [json.loads(line) for line in err.decode().splitlines()
                  if line.startswith("{")]
        assert any("inference gateway serving" in rec["msg"]
                   for rec in logged)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
