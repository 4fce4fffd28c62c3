"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere under ``benchmark/``, and nothing of the port in the reference.
Module names are compared by their whole top-level part (before the first
dot), so ``spark_ensemble_tpu_torch`` is not taken for
``spark_ensemble_tpu``."""

import ast
import subprocess
import sys

from benchmark.harness import env, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "spark_ensemble_tpu"}
PORT = "spark_ensemble_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def _top(name):
    return name.split(".", 1)[0]


def test_no_file_under_benchmark_imports_jax_or_the_jax_package():
    files = sorted(spec.BENCH_DIR.rglob("*.py"))
    assert files
    bad = [(f.name, m) for f in files for m in _imports(f) if _top(m) in FORBIDDEN]
    assert bad == []


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((spec.BENCH_DIR / "reference").rglob("*.py"))
    assert files
    assert [(f.name, m) for f in files for m in _imports(f) if _top(m) == PORT] == []


def test_top_level_names_are_compared_whole():
    assert _top("spark_ensemble_tpu_torch.ops.tree") not in FORBIDDEN
    assert _top("spark_ensemble_tpu.ops.tree") in FORBIDDEN
    assert set(env.FORBIDDEN_MODULES) == FORBIDDEN


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark.harness import env; env.prepare();"
        "from benchmark.harness import spec;"
        "from benchmark.harness.cell import run_cell;"
        "import conftest;"
        "cell = conftest.shrink(spec.load_cell(conftest.CELLS[0]));"
        "run_cell(cell, 7, 0.1, False, 'cpu', rows=conftest.FIT_ROWS);"
        "print(env.forbidden_loaded())"
    )
    tests = spec.BENCH_DIR / "tests"
    p = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], cwd=tests,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
