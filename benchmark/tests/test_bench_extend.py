"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as new files and entries only: shown in a copy of the
benchmark, where no file that was there changes but ``BENCHMARK.json``.
The added configuration is a 3-class softmax fit on argmax labels, the
data rule and loss that the held-out softmax cell (``PERF.md`` section 7)
needs and no listed cell runs."""

import hashlib
import json
import shutil

from benchmark.harness import spec
from benchmark.harness.cell import run_cell

READER = '''"""``fit.rounds_traced``: the traced fit's rounds."""


def read(ctx):
    s = ctx.get("trace")
    return None if s is None else s.rounds
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_add_a_cell_a_config_a_mix_and_a_metric(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "higgs-bin-d8.json").read_text())
    cfg.update(name="tiny-smx-d4")
    cfg["data"].update(rows=3000, numeric_features=6, one_hot_groups=[3], classes=3,
                       label_rule="argmax")
    cfg["estimator"].update(loss="logloss", num_base_learners=2)
    cfg["base_learner"].update(max_depth=4, max_bins=15)
    (bench / "configs" / "tiny-smx-d4.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fit-short.json").write_text(json.dumps(
        {"driver": "fit", "warm_rounds": 1, "check_rounds": 2}))
    limits = json.loads((bench / "limits" / "higgs.fit.json").read_text())
    (bench / "limits" / "tiny.fit-short.json").write_text(json.dumps(limits))
    (bench / "metrics" / "fit.rounds_traced.py").write_text(READER)
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_["configs"].append({"name": "tiny-smx-d4", "source": "a test", "reduced": [],
                             "file": "benchmark/configs/tiny-smx-d4.json", "why": "a test"})
    spec_["workloads"].append({"name": "tiny.fit-short", "config": "tiny-smx-d4",
                               "traffic": "fit-short", "chips": 1, "why": "a test"})
    for m in spec_["end_to_end"]:
        if m["name"] == "fit_rounds_per_s":
            m["workloads"].append("tiny.fit-short")
    spec_["per_layer"].append({"name": "fit.rounds_traced", "unit": "rounds", "better": "higher",
                               "source": "device_trace", "layer": "round loop",
                               "moves": "fit_rounds_per_s", "workloads": ["tiny.fit-short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))

    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {tmp_path.joinpath("BENCHMARK.json").relative_to(tmp_path)}

    cell = spec.load_cell("tiny.fit-short", tmp_path)
    assert cell.root == tmp_path
    plain = run_cell(cell, 11, 0.1, False, "cpu")
    assert plain["correct"] and "fit_rounds_per_s" in plain["metrics"]
    traced = run_cell(cell, 11, 0.1, True, "cpu")
    assert traced["correct"] and traced["metrics"]["fit.rounds_traced"]["value"] == 2
