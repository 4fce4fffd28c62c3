"""The port's operator endpoints (``telemetry/exporter.py``) against the JAX
package's: OpenMetrics rendering and the stdlib checker, the live plane
around a fit, snapshot files and the CLI.

Tolerances:
- Parity: the same registry-snapshot dict through both packages'
  ``render_openmetrics`` gives IDENTICAL text, and the same expositions
  through both ``validate_openmetrics`` give EQUAL findings.
- A fit scraped live (``/metrics``, ``/programz``, ``/statusz``,
  ``/healthz`` in a loop) against the same fit unscraped: EQUAL params; no
  kernel launch counted, no build, no capture during the scrapes.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import spark_ensemble_tpu_torch as st
from spark_ensemble_tpu.telemetry import exporter as jax_exporter
from spark_ensemble_tpu_torch.models.base import tree_leaves
from spark_ensemble_tpu_torch.ops import hist_kernels as hk
from spark_ensemble_tpu_torch.telemetry import exporter, programz
from spark_ensemble_tpu_torch.telemetry.events import compile_snapshot, global_metrics
from spark_ensemble_tpu_torch.telemetry.exporter import (
    OperatorPlane,
    render_openmetrics,
    validate_openmetrics,
    write_snapshot,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n=300, d=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _gbm():
    return st.GBMRegressor(num_base_learners=4, seed=0, base_learner=st.DecisionTreeRegressor(
        max_depth=3, max_bins=16, hist="fused"))


def _fetch(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _loopback_or_skip():
    import socket

    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
    except OSError as e:
        pytest.skip(f"no loopback sockets: {e}")


# -- parity: rendering and the checker ------------------------------------------

SNAPSHOTS = {
    "families": {
        "fit/rounds": {"type": "counter", "value": 7},
        "hbm/gpu:0/bytes_in_use": {"type": "gauge", "value": 1024},
        "fit/round_ms": {"type": "histogram", "count": 3, "sum": 30.0,
                         "p50": 9.0, "p90": 11.0, "p99": 12.0},
        "fleet/svc:1:2": {"type": "source",
                          "value": {"p99_ms": 4.5, "stopped": False,
                                    "replicas": ["r0", "r1"], "label": "svc"}},
    },
    "edges": {
        "0lead/digit": {"type": "gauge", "value": 0.1},
        "nan/gauge": {"type": "gauge", "value": float("nan")},
        "none/gauge": {"type": "gauge", "value": None},
        "empty/hist": {"type": "histogram", "count": 0},
        "partial/hist": {"type": "histogram", "count": 2, "sum": 1.5, "p50": 0.25},
        "big/counter": {"type": "counter", "value": 1e16},
        "zero/counter": {"type": "counter", "value": None},
        "elastic/fit:3": {"type": "source",
                          "value": {"width": 3, "losses": [[1, "s", 3]],
                                    "nested": {"a": 1.5, "b": True, "c": None}}},
        "elastic/bad": {"type": "source", "error": "boom"},
        'quality/m"x\\y': {"type": "source", "value": {"psi_max": 0.25}},
        "plainsource": {"type": "source", "value": 3},
    },
    "empty": {},
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_render_parity_with_the_jax_package(name):
    snap = SNAPSHOTS[name]
    text = render_openmetrics(snap)
    assert text == jax_exporter.render_openmetrics(snap)
    assert validate_openmetrics(text) == []


def test_render_parity_on_a_live_registry_after_a_fit():
    X, y = _data()
    inv = programz.enable()
    try:
        _gbm().fit(X, y, device="cpu")
        programz.HbmSampler(interval_s=3600.0).sample_once()
        snap = global_metrics().snapshot()
    finally:
        programz.disable()
        inv.clear()
    assert "programz/programs" in snap
    text = render_openmetrics(snap)
    assert text == jax_exporter.render_openmetrics(snap)
    assert validate_openmetrics(text) == []


def test_render_families_and_sources():
    text = render_openmetrics(SNAPSHOTS["families"])
    assert "# TYPE se_tpu_fit_rounds counter" in text
    assert "se_tpu_fit_rounds_total 7" in text
    assert "se_tpu_hbm_gpu:0_bytes_in_use 1024" in text
    assert 'se_tpu_fit_round_ms{quantile="0.99"} 12' in text
    assert 'se_tpu_fleet{source="svc:1:2",field="p99_ms"} 4.5' in text
    assert 'field="stopped"} 0' in text
    assert 'field="replicas.len"} 2' in text
    assert 'field="label"' not in text
    assert text.endswith("# EOF\n")


MALFORMED = [
    "# EOF\n",
    "se_tpu_x 1\n",
    "# TYPE se_tpu_a counter\nse_tpu_a 1\n# EOF",
    "# TYPE se_tpu_a gauge\n# TYPE se_tpu_a gauge\n# EOF",
    "# TYPE se_tpu_a gauge\n# TYPE se_tpu_b gauge\nse_tpu_b 1\nse_tpu_a 1\nse_tpu_b 2\n# EOF",
    "!!!\n# EOF",
    "# TYPE se_tpu_a gauge\nse_tpu_a 1\n# EOF\nse_tpu_a 2",
    "# TYPE se_tpu_a gauge\nse_tpu_a{x=\"1\"} NaN\n# EOF",
    "# HELP se_tpu_a help text\n# TYPE se_tpu_a summary\nse_tpu_a_count 1\nse_tpu_a_sum 2\n# EOF",
    "# TYPE se_tpu_a gauge\nse_tpu_a one\n# EOF",
    "# TYPE se_tpu_a nonsense\n# EOF",
    "",
]


@pytest.mark.parametrize("i", range(len(MALFORMED)))
def test_validate_parity_with_the_jax_package(i):
    text = MALFORMED[i]
    assert validate_openmetrics(text) == jax_exporter.validate_openmetrics(text)


def test_validate_catches_violations():
    assert validate_openmetrics("# EOF\n") == []
    assert validate_openmetrics("se_tpu_x 1\n") != []
    assert any("no declared TYPE" in p for p in validate_openmetrics(MALFORMED[2]))
    assert any("duplicate" in p for p in validate_openmetrics(MALFORMED[3]))
    assert any("interleaved" in p for p in validate_openmetrics(MALFORMED[4]))
    assert any("unparseable" in p for p in validate_openmetrics(MALFORMED[5]))


# -- the live plane ---------------------------------------------------------------


def test_live_scrape_during_an_active_fit_is_valid_and_changes_nothing():
    _loopback_or_skip()
    X, y = _data()
    quiet = _gbm().fit(X, y, device="cpu")
    plane = OperatorPlane(port=0, sampler_interval_s=0.05,
                          watchdog_interval_s=3600.0).start()
    try:
        stop = threading.Event()
        problems, codes, loops = [], [], [0]

        def scraper():
            while not stop.is_set():
                code, body = _fetch(plane.url + "/metrics")
                codes.append(code)
                problems.extend(validate_openmetrics(body))
                for path in ("/programz?n=5", "/healthz", "/statusz"):
                    codes.append(_fetch(plane.url + path)[0])
                loops[0] += 1

        t = threading.Thread(target=scraper, daemon=True)
        builds, launches = compile_snapshot(), dict(hk.LAUNCHES)
        t.start()
        scraped = _gbm().fit(X, y, device="cpu")
        while loops[0] < 2 and t.is_alive():
            t.join(timeout=0.05)
        stop.set()
        t.join(timeout=30)
        assert compile_snapshot() == builds and hk.LAUNCHES == launches
        assert codes and all(c == 200 for c in codes), set(codes)
        assert problems == []
        for a, b in zip(tree_leaves(quiet.params), tree_leaves(scraped.params)):
            assert torch.equal(a, b)
        status = json.loads(_fetch(plane.url + "/statusz")[1])
        assert status["backend"] == "cpu"
        assert status["scrapes"] >= loops[0]
        assert status["programs"]["programs"] >= 1
        assert len(json.loads(_fetch(plane.url + "/programz?n=3")[1])["programs"]) == 3
        progz = json.loads(_fetch(plane.url + "/programz")[1])
        assert {"gbm_reg_round", "hist_packed", "route_packed", "leaf_sums"} <= {
            r["tag"] for r in progz["programs"]}
        code, body = _fetch(plane.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        assert _fetch(plane.url + "/qualityz")[0] == 200
        code, body = _fetch(plane.url + "/nope")
        assert code == 404 and "/programz" in json.loads(body)["endpoints"]
    finally:
        plane.stop()
    assert not programz.enabled()
    programz.global_inventory().clear()


def test_plane_stop_raises_after_a_sampler_error():
    _loopback_or_skip()
    plane = OperatorPlane(port=0, with_watchdog=False, sampler_interval_s=0.01).start()

    def broken():
        raise RuntimeError("allocator stats unreadable")

    plane.sampler.sample_once = broken
    while not plane.sampler.errors:
        threading.Event().wait(0.01)
    with pytest.raises(RuntimeError, match="allocator stats unreadable"):
        plane.stop()
    assert not programz.enabled()
    programz.global_inventory().clear()


def test_write_snapshot_files_validate(tmp_path):
    X, y = _data()
    inv = programz.enable()
    inv.clear()
    try:
        _gbm().fit(X, y, device="cpu")
        inv.analyze_pending()
        paths = write_snapshot(str(tmp_path / "snap"), inventory=inv)
    finally:
        programz.disable()
        inv.clear()
    assert validate_openmetrics(open(paths["metrics"]).read()) == []
    progs = json.load(open(paths["programz"]))
    assert {r["tag"] for r in progs["programs"]} >= {"gbm_reg_round", "hist_packed"}
    status = json.load(open(paths["statusz"]))
    assert status["programs"]["programs"] >= 1 and status["backend"] == "cpu"
    assert set(json.load(open(paths["qualityz"]))) == {"streams", "series", "watchdog"}
    # the CLI's checker agrees on the file
    assert exporter.main(["--validate", paths["metrics"]]) == 0


def test_cli_validate_flags_a_bad_file(tmp_path, capsys):
    bad = tmp_path / "bad.txt"
    bad.write_text(MALFORMED[2])
    assert exporter.main(["--validate", str(bad)]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"file": str(bad), "ok": False, "violations": 1}


def test_a_fresh_interpreter_scrapes_without_initializing_cuda(tmp_path):
    """The CLI's snapshot mode in a new process: every file is written, and
    CUDA is still not initialized after the scrape."""
    code = (
        "import json, sys, torch\n"
        "from spark_ensemble_tpu_torch.telemetry import exporter\n"
        "rc = exporter.main(['--snapshot', sys.argv[1]])\n"
        "print(json.dumps({'rc': rc, 'cuda_initialized': torch.cuda.is_initialized()}))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "s")], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"rc": 0, "cuda_initialized": False}
    for name in ("metrics.txt", "statusz.json", "programz.json", "qualityz.json"):
        assert (tmp_path / "s" / name).exists()
    status = json.loads((tmp_path / "s" / "statusz.json").read_text())
    assert status["backend"] == "cpu"
