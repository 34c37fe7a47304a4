"""The port's pod entrypoint, ``python -m kubeflow_tpu_torch.serving``.

``build_model`` reads the reference's env contract into the same
``LMConfig`` fields as ``kubeflow_tpu/serving/__main__.py`` (the random
weights differ: the reference draws from ``jax.random.key(0)``, the port
from a seeded ``torch.Generator``, so only the config is compared).
``main(device="cpu")`` runs as a real process on a free port: it answers
``/readyz`` and a greedy request equal to ``generate`` on the same
``build_model`` params, and exits 0 on SIGTERM; a run with no card
raises. With ``KFT_SERVING_MODEL_DIR`` the pod restores the newest valid
step of a port-written f32 training checkpoint into ``build_model``'s
bf16 params and serves it (its stream equals ``generate`` on
``make_reload_fn``'s params, not on the init's); an empty directory
serves the init with a warning and ``POST /v1/admin/swap`` answers 409
until a step is committed, then 200 with that step, after which the
stream follows the new weights.
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
from kubeflow_tpu_torch.models import build_lm, create_lm_state
from kubeflow_tpu_torch.models.checkpoint import CheckpointManager
from kubeflow_tpu_torch.models.decoding import generate
from kubeflow_tpu_torch.models.optim import flatten
from kubeflow_tpu_torch.serving.__main__ import (
    build_model,
    main,
    make_reload_fn,
)

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


def _save_training_step(directory, cfg, seed: int, step: int) -> None:
    """Commit an f32 LM train state of ``cfg``'s dims at ``step``."""
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    state = create_lm_state(build_lm(f32), seed=seed, device="cpu")
    state.step = step
    CheckpointManager(directory).save(step, state)


def test_main_refuses_a_model_dir_naming_a8(tmp_path):
    """What this checks now: the pod's reload hook finds nothing in an
    empty directory and restores an f32 training checkpoint into the
    bf16 template, each leaf cast to the template's dtype. (The name is
    the one this test had while the model directory was refused; it is
    kept so that the test's record carries over.)"""
    env = {"KFT_SERVING_CONFIG": json.dumps({**TINY, "dtype": "bfloat16"})}
    cfg, template = build_model(env, device="cpu")
    reload_fn = make_reload_fn(str(tmp_path), template)
    assert reload_fn() == (None, {"dir": str(tmp_path), "step": None})
    _save_training_step(tmp_path, cfg, seed=3, step=5)
    params, info = reload_fn()
    assert info == {"dir": str(tmp_path), "step": 5}
    saved = create_lm_state(build_lm(dataclasses.replace(
        cfg, dtype=torch.float32)), seed=3, device="cpu").params
    flat_t, flat_s, flat_p = (dict(flatten(tree))
                              for tree in (template, saved, params))
    assert flat_p.keys() == flat_t.keys() == flat_s.keys()
    for path, leaf in flat_t.items():
        assert flat_p[path].dtype == leaf.dtype, path
        assert torch.equal(flat_p[path], flat_s[path].detach().to(leaf.dtype))


def test_pod_logs_in_the_port_tree_when_run_with_dash_m():
    """``python -m kubeflow_tpu_torch.serving`` runs this module as
    ``__main__``; its logger must still sit under the tree the
    structured handler is attached to, or the pod's "serving checkpoint
    step" record is dropped."""
    import runpy

    module = runpy.run_path(
        str(REPO / "kubeflow_tpu_torch" / "serving" / "__main__.py"),
        run_name="__not_main__")
    assert module["log"].name == "kubeflow_tpu_torch.serving.__main__"


def test_main_passes_spec_ngram_to_make_engine(monkeypatch,
                                               restore_port_logger):
    """The spec flag and its two knobs reach ``make_engine`` as the
    reference passes them (the engine itself is held by the pod test
    below and by tests/test_torch_speculative.py)."""
    from kubeflow_tpu_torch.serving import engine as engine_mod

    monkeypatch.delenv("KFT_SERVING_MODEL_DIR", raising=False)
    monkeypatch.setenv("KFT_SERVING_CONFIG", json.dumps(TINY))
    monkeypatch.setenv("KFT_SERVING_SPEC_NGRAM", "true")
    monkeypatch.setenv("KFT_SERVING_SPEC_DRAFT", "5")
    monkeypatch.setenv("KFT_SERVING_SPEC_NGRAM_N", "2")
    seen = {}

    class Stop(Exception):
        pass

    def fake_make_engine(cfg, params, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(engine_mod, "make_engine", fake_make_engine)
    with pytest.raises(Stop):
        main(device="cpu")
    assert (seen["spec_ngram"], seen["spec_draft"], seen["spec_ngram_n"]) \
        == (True, 5, 2)
    monkeypatch.setenv("KFT_SERVING_SPEC_NGRAM", "0")
    monkeypatch.delenv("KFT_SERVING_SPEC_DRAFT")
    monkeypatch.delenv("KFT_SERVING_SPEC_NGRAM_N")
    with pytest.raises(Stop):
        main(device="cpu")
    assert (seen["spec_ngram"], seen["spec_draft"], seen["spec_ngram_n"]) \
        == (False, 8, 3)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _start_pod(extra: dict) -> tuple[subprocess.Popen, str]:
    """``main(device='cpu')`` as its own process on a free port, ready."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFT_") and k != "PYTHONPATH"}
    env.update({"KFT_SERVING_CONFIG": json.dumps(TINY),
                "KFT_SERVING_PORT": str(port),
                "KFT_SERVING_MAX_BATCH": "2",
                "KFT_SERVING_MAX_LEN": "64", **extra})
    code = ("from kubeflow_tpu_torch.serving.__main__ import main; "
            "main(device='cpu')")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while True:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[1].decode())
        try:
            with urllib.request.urlopen(url + "/readyz", timeout=5) as r:
                assert json.loads(r.read()) == {"ready": True}
                return proc, url
        except (urllib.error.URLError, ConnectionError):
            if time.monotonic() > deadline:
                proc.kill()
                raise AssertionError("pod never got ready") from None
            time.sleep(0.2)


def _call(url: str, path: str, body=None) -> tuple[int, dict]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, headers={
        "Content-Type": "application/json"}, method="POST" if path in (
            "/v1/generate", "/v1/admin/swap") else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _tokens(url: str, prompt, n: int) -> list[int]:
    status, payload = _call(url, "/v1/generate", {
        "prompt": prompt, "max_new_tokens": n, "stream": False})
    assert status == 200 and payload["reason"] == "length", payload
    return payload["tokens"]


def _stop(proc) -> str:
    """SIGTERM; the pod must exit 0. Returns its stderr."""
    proc.send_signal(signal.SIGTERM)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err.decode()
    return err.decode()


def _logged(err: str) -> list[dict]:
    return [json.loads(line) for line in err.splitlines()
            if line.startswith("{")]


def test_main_serves_a_pod_and_exits_on_sigterm():
    proc, url = _start_pod({})
    try:
        cfg, params = build_model({"KFT_SERVING_CONFIG": json.dumps(TINY)},
                                  device="cpu")
        want = generate(cfg, params, [[5, 6, 7]], 6, device="cpu")
        assert _tokens(url, [5, 6, 7], 6) == want[0].tolist()
        status, payload = _call(url, "/v1/status")
        assert payload["autopilot"]["actuators"] == ["gateway-admission"]
        # No model directory: no reload hook, so no swap.
        assert _call(url, "/v1/admin/swap")[0] == 404
        err = _stop(proc)
        records = _logged(err)
        assert any("inference gateway serving" in rec["msg"]
                   for rec in records)
        # The CPU twins are no launches: every count is logged, at 0.
        launches = [rec["kernel_launches"] for rec in records
                    if "kernel_launches" in rec]
        assert launches == [{name: 0 for name in (
            "flash_attention", "gemv", "qkv_rope", "decode_attention",
            "flash_dq", "flash_dkv", "split3", "bn_stats", "bn_apply",
            "bn_grad_sums", "bn_dx")}]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


BF16 = {**TINY, "dtype": "bfloat16"}


def _served(cfg, template, directory, prompt, n):
    params, info = make_reload_fn(str(directory), template)()
    return generate(cfg, params, [prompt], n, device="cpu")[0].tolist(), info


def test_main_restores_and_hot_swaps_a_checkpoint(tmp_path):
    """A port-written f32 training checkpoint at step 1 serves at boot in
    bf16; step 2 committed later is swapped in with 200, counted once in
    ``inference_model_swap_total``, and then served."""
    env = {"KFT_SERVING_CONFIG": json.dumps(BF16)}
    cfg, template = build_model(env, device="cpu")
    prompt = [9, 3, 7, 1]
    init = generate(cfg, template, [prompt], 8, device="cpu")[0].tolist()
    _save_training_step(tmp_path, cfg, seed=3, step=1)
    want1, _ = _served(cfg, template, tmp_path, prompt, 8)
    assert want1 != init
    proc, url = _start_pod({**env, "KFT_SERVING_MODEL_DIR": str(tmp_path)})
    try:
        assert _tokens(url, prompt, 8) == want1
        _save_training_step(tmp_path, cfg, seed=4, step=2)
        want2, info = _served(cfg, template, tmp_path, prompt, 8)
        assert want2 != want1 and info["step"] == 2
        status, payload = _call(url, "/v1/admin/swap")
        assert status == 200 and payload["info"]["step"] == 2, payload
        deadline = time.monotonic() + 60
        while _call(url, "/v1/status")[1]["swaps"] < 1:
            assert time.monotonic() < deadline, "the swap was never applied"
            time.sleep(0.1)
        assert _tokens(url, prompt, 8) == want2
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            assert "inference_model_swap_total 1.0" in r.read().decode()
        err = _stop(proc)
        assert any(rec["msg"].startswith("serving checkpoint step 1")
                   for rec in _logged(err))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_main_serves_init_on_an_empty_model_dir_and_swap_answers_409(
        tmp_path):
    env = {"KFT_SERVING_CONFIG": json.dumps(BF16)}
    cfg, template = build_model(env, device="cpu")
    prompt = [2, 4, 6]
    proc, url = _start_pod({**env, "KFT_SERVING_MODEL_DIR": str(tmp_path)})
    try:
        init = generate(cfg, template, [prompt], 6, device="cpu")[0]
        assert _tokens(url, prompt, 6) == init.tolist()
        status, payload = _call(url, "/v1/admin/swap")
        assert status == 409 and payload["info"]["step"] is None, payload
        _save_training_step(tmp_path, cfg, seed=5, step=3)
        status, payload = _call(url, "/v1/admin/swap")
        assert status == 200 and payload["info"]["step"] == 3, payload
        err = _stop(proc)
        assert any(rec["level"] == "WARNING"
                   and "no valid checkpoint" in rec["msg"]
                   for rec in _logged(err))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _metric_value(url: str, line_start: str) -> float:
    with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(line_start):
                return float(line.split()[-1])
    raise AssertionError(f"no {line_start} in /metrics")


def test_main_serves_speculative_decoding_from_the_env():
    """``KFT_SERVING_SPEC_NGRAM=1`` with the draft and n knobs: the pod
    serves ``generate``'s greedy tokens through verify cycles."""
    proc, url = _start_pod({"KFT_SERVING_SPEC_NGRAM": "1",
                            "KFT_SERVING_SPEC_DRAFT": "4",
                            "KFT_SERVING_SPEC_NGRAM_N": "2"})
    try:
        cfg, params = build_model({"KFT_SERVING_CONFIG": json.dumps(TINY)},
                                  device="cpu")
        prompt = [5, 6, 7, 5, 6, 7, 5, 6]
        want = generate(cfg, params, [prompt], 12, device="cpu")[0].tolist()
        assert _tokens(url, prompt, 12) == want
        verify = 'inference_batch_cycle_seconds_count{phase="verify"}'
        commit = 'inference_batch_cycle_seconds_count{phase="commit"}'
        assert _metric_value(url, verify) >= 1
        assert _metric_value(url, verify) == _metric_value(url, commit)
        _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_main_starts_an_moe_config_on_the_fallback_engine():
    moe = {**TINY, "moe_experts": 4, "moe_top_k": 2}
    proc, url = _start_pod({"KFT_SERVING_CONFIG": json.dumps(moe)})
    try:
        cfg, params = build_model({"KFT_SERVING_CONFIG": json.dumps(moe)},
                                  device="cpu")
        assert "moe" in params["block_1"]
        status, payload = _call(url, "/v1/status")
        assert payload["batched"] is False
        assert payload["slots"]["total"] == 1
        want = generate(cfg, params, [[8, 1, 9]], 6, device="cpu")[0]
        assert _tokens(url, [8, 1, 9], 6) == want.tolist()
        err = _stop(proc)
        assert any(rec["level"] == "WARNING" and "fallback" in rec["msg"]
                   for rec in _logged(err))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
