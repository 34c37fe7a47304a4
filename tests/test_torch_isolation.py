"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, not even its framework-free modules, and no
``prometheus_client`` (the port renders its own exposition, so a CUDA
serving image need not carry it).

Two checks: a fresh interpreter imports the port and ``chip_smoke``
(without running it) and must end with no ``jax``/``flax``/``optax`` or
``kubeflow_tpu.*`` module loaded; and an AST scan of every port source
and ``chip_smoke.py`` finds no such import. ``kubeflow_tpu`` is matched
as a whole dotted name, since ``kubeflow_tpu_torch`` starts with it.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "kubeflow_tpu",
             "prometheus_client")


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN


def _port_sources() -> list[Path]:
    return sorted((REPO / "kubeflow_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import kubeflow_tpu_torch, kubeflow_tpu_torch.serving\n"
        "import kubeflow_tpu_torch.models, kubeflow_tpu_torch.ops\n"
        "import kubeflow_tpu_torch.models.speculative\n"
        "import kubeflow_tpu_torch.obs, chip_smoke\n"
        "import kubeflow_tpu_torch.serving.gateway\n"
        "import kubeflow_tpu_torch.serving.__main__\n"
        "import kubeflow_tpu_torch.autopilot\n"
        "import kubeflow_tpu_torch.autopilot.core\n"
        "import kubeflow_tpu_torch.autopilot.serving\n"
        "import kubeflow_tpu_torch.obs.alerts, kubeflow_tpu_torch.obs.slo\n"
        "import kubeflow_tpu_torch.obs.trace\n"
        "import kubeflow_tpu_torch.obs.logging\n"
        "import kubeflow_tpu_torch.obs.envknob\n"
        "import kubeflow_tpu_torch.obs.exposition\n"
        "import kubeflow_tpu_torch.obs.recorder\n"
        "import kubeflow_tpu_torch.parallel, kubeflow_tpu_torch.ops.ring\n"
        "import kubeflow_tpu_torch.parallel.collectives\n"
        "import kubeflow_tpu_torch.parallel.distributed\n"
        "import kubeflow_tpu_torch.parallel.mesh\n"
        "import kubeflow_tpu_torch.parallel.pipeline\n"
        "import kubeflow_tpu_torch.parallel.schedule1f1b\n"
        "import kubeflow_tpu_torch.models.pipeline_lm\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == [], f"{path.name} imports {bad}"


def test_the_whole_name_rule():
    assert _forbidden("kubeflow_tpu.obs.metrics")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert _forbidden("prometheus_client.core")
    assert not _forbidden("kubeflow_tpu_torch.ops")
