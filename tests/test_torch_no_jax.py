"""The port stands alone: every module of ``spark_ensemble_tpu_torch`` (and
``chip_smoke.py``) imports with ``jax`` and the JAX package blocked in
``sys.modules``, and no source line of either imports them.  The imports
run in a fresh interpreter, since this test process has imported jax
already."""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "spark_ensemble_tpu_torch")
BLOCKED = ("jax", "jaxlib", "spark_ensemble_tpu")

_SCRIPT = """
import importlib, json, pkgutil, sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import spark_ensemble_tpu_torch as pkg
failed, names = [], [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    names.append(info.name)
    try:
        importlib.import_module(info.name)
    except Exception as e:
        failed.append([info.name, repr(e)])
try:
    importlib.import_module("chip_smoke")
    names.append("chip_smoke")
except Exception as e:
    failed.append(["chip_smoke", repr(e)])
print(json.dumps({{"names": names, "failed": failed}}))
"""


def _sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the mesh tests' rank processes import only the port
    yield os.path.join(ROOT, "tests", "_torch_mesh_worker.py")


def test_every_port_module_imports_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(blocked=BLOCKED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["failed"] == []
    expected = {"spark_ensemble_tpu_torch.data.streaming",
                "spark_ensemble_tpu_torch.serving.export",
                "spark_ensemble_tpu_torch.serving.engine",
                "spark_ensemble_tpu_torch.serving.registry",
                "spark_ensemble_tpu_torch.serving.fleet",
                "spark_ensemble_tpu_torch.serving.autopilot",
                "spark_ensemble_tpu_torch.telemetry.watchdog",
                "spark_ensemble_tpu_torch.telemetry.events",
                "spark_ensemble_tpu_torch.telemetry.flight",
                "spark_ensemble_tpu_torch.telemetry.quality",
                "spark_ensemble_tpu_torch.telemetry.registry",
                "spark_ensemble_tpu_torch.telemetry.trace",
                "spark_ensemble_tpu_torch.utils.instrumentation",
                "spark_ensemble_tpu_torch.utils.profiling",
                "spark_ensemble_tpu_torch.autotune.resolve",
                "spark_ensemble_tpu_torch.autotune.space",
                "spark_ensemble_tpu_torch.autotune.cache",
                "spark_ensemble_tpu_torch.autotune.search",
                "spark_ensemble_tpu_torch.autotune.compilation_cache",
                "spark_ensemble_tpu_torch.ops.collective",
                "spark_ensemble_tpu_torch.parallel.mesh",
                "spark_ensemble_tpu_torch.parallel.elastic",
                "spark_ensemble_tpu_torch.parallel.multihost", "chip_smoke"}
    assert expected <= set(report["names"])


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_line_imports_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names if n.split(".")[0] in BLOCKED]
    assert bad == []
