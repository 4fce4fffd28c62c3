"""The program's spans in a profiler window (``harness/spans.py``): on
events made by hand, on a CPU fit's own profile, and on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness.spans import span_table
from benchmark.harness.trace import summarize


class Ev:
    """A kineto event made by hand: operators and spans carry their
    thread and correlation id; runtime calls and device events the id of
    their launch (``corr``) and of the operator they link to."""

    def __init__(self, name, start, dur, device=False, corr=0, linked=0, tid=1,
                 annotation=False):
        self._n, self._s, self._d, self._dev = name, start, dur, device
        self._corr, self._linked, self._tid, self._ann = corr, linked, tid, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._ann


#: the program's operators and spans; ids 1-9 are operators', on thread 1
SPANS = [
    Ev("fit", 0, 1000, corr=1),
    Ev("round.step", 100, 300, corr=2),
    Ev("tree.split", 400, 300, corr=3),
]
OPS = [Ev("aten::add", 150, 50, corr=4), Ev("aten::item", 450, 200, corr=5)]
#: runtime calls (the profiler gives them threads of another numbering) and
#: device work; ids from 1001 are launches'
CALLS = [
    Ev("cudaLaunchKernel", 160, 5, corr=1001, linked=4, tid=77),
    Ev("cudaStreamSynchronize", 170, 20, corr=1002, linked=4, tid=77),
    Ev("cudaLaunchKernel", 560, 5, corr=1003, linked=5, tid=77),
    Ev("cudaLaunchKernelExC", 800, 5, corr=1004, linked=1, tid=77),
    Ev("cudaLaunchKernel", 1100, 5, corr=1005, linked=0, tid=77),
]
DEVICE = [
    Ev("round_kernel", 300, 50, device=True, corr=1001, linked=4),
    Ev("split_kernel", 900, 300, device=True, corr=1003, linked=5),
    Ev("fit_kernel", 1250, 50, device=True, corr=1004, linked=1),
    Ev("outside_kernel", 1400, 50, device=True, corr=1005),
    # a copy whose launch the window lost: its operator places it
    Ev("Memcpy DtoH", 600, 20, device=True, corr=2001, linked=5),
]


def test_span_table_charges_the_innermost_span_by_correlation_id():
    table = span_table(SPANS + OPS + CALLS + DEVICE)
    assert set(table) == {"fit", "round.step", "tree.split"}
    step, split, fit = table["round.step"], table["tree.split"], table["fit"]
    assert (step["launches"], step["syncs"]) == (1, 1)
    assert step["device_s"] == pytest.approx(50e-9)
    assert (split["launches"], split["syncs"]) == (1, 0)
    assert split["device_s"] == pytest.approx(320e-9)
    assert (fit["launches"], fit["syncs"]) == (1, 0)
    assert fit["device_s"] == pytest.approx(50e-9)  # its own launch only
    assert step["wall_s"] == pytest.approx(300e-9)
    assert step["extent_s"] == pytest.approx(300e-9)  # its kernel ended inside
    assert split["extent_s"] == pytest.approx(800e-9)  # 400 to its kernel's end, 1200
    assert fit["extent_s"] == pytest.approx(1300e-9)  # to the end of fit_kernel
    assert all(row["count"] == 1 for row in table.values())


def test_span_table_sums_instances_and_ignores_annotation_copies():
    events = [Ev("fit.round", 0, 100, corr=1), Ev("fit.round", 200, 100, corr=2),
              Ev("cudaLaunchKernel", 10, 5, corr=1001, linked=1, tid=9),
              Ev("k", 50, 10, device=True, corr=1001),
              Ev("fit.round", 40, 30, device=True, annotation=True)]
    row = span_table(events)["fit.round"]
    assert row["count"] == 2 and row["wall_s"] == pytest.approx(200e-9)
    assert row["device_s"] == pytest.approx(10e-9) and row["launches"] == 1
    assert span_table(OPS + CALLS + DEVICE) == {}


def test_spans_change_no_summary_field_but_the_names_of_idle_gaps():
    """The program's spans are operators to ``summarize``: the same
    window with and without them reads the same, except that a gap with no
    other operator at its middle is named by the span around it."""
    plain = OPS + CALLS + DEVICE
    bare, spanned = summarize(plain, 2e-6), summarize(SPANS + plain, 2e-6)
    for f in dataclasses.fields(bare):
        if f.name != "idle_gaps":
            assert getattr(spanned, f.name) == getattr(bare, f.name), f.name
    assert [g[1] for g in spanned.idle_gaps] == [g[1] for g in bare.idle_gaps]
    named = {round(g[1] * 1e9): g[0] for g in spanned.idle_gaps}
    # [350, 600]: aten::item, inside tree.split, holds its middle;
    # [1200, 1250]: nothing does
    assert named[250] == "aten::item" and named[50] == "(no host operation)"
    # [620, 900]: only the fit's span is open at 760
    assert named[280] == "fit"
    assert {round(g[1] * 1e9): g[0] for g in bare.idle_gaps}[280] == "(no host operation)"


def test_a_profiled_cpu_fit_reads_its_spans():
    from torch.profiler import ProfilerActivity, profile

    import spark_ensemble_tpu_torch as st

    rng = np.random.RandomState(0)
    X = rng.randn(300, 4).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.randn(300) > 0).astype(np.float32)
    est = st.GBMClassifier(num_base_learners=2,
                           base_learner=st.DecisionTreeRegressor(max_depth=3, max_bins=16))
    est.fit(X, y, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        est.fit(X, y, device="cpu")
    table = span_table(prof.profiler.kineto_results.events())
    counts = {name: row["count"] for name, row in table.items()}
    assert counts["fit"] == 1 and counts["fit.round"] == 2 and counts["round.step"] == 2
    assert counts["tree.level"] == 6 and counts["tree.split"] == 6
    assert all(row["device_s"] == 0 and row["launches"] == 0 for row in table.values())
    assert all(row["extent_s"] == pytest.approx(row["wall_s"]) for row in table.values())


def test_the_span_probe_reads_a_small_cpu_fit(capsys):
    """``span_probe.py`` on a small CPU fit: one JSON line a fit, the span
    readings with the spans on and none with them forced off."""
    import json

    from benchmark import span_probe

    from conftest import FIT_ROWS

    lines = span_probe.main(["--seed", "3000000019", "--order", "on,off", "--rows",
                             str(FIT_ROWS), "--rounds", "2", "--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert printed == json.loads(json.dumps(lines))
    on, off = lines
    assert (on["mode"], off["mode"], on["rounds"]) == ("on", "off", 2)
    m = on["metrics"]
    assert m["fit.bin_ms"] > 0 and m["fit.fixed_ms"] > 0
    assert m["fit.step_device_ms_per_round"] == 0 and m["fit.step_syncs_per_round"] == 0
    assert on["per_round"]["fit.round"]["count"] == 2
    assert "metrics" not in off and off["annotations"] == 0


@pytest.mark.card
def test_the_spans_below_the_fit_hold_its_device_time(need_card):
    """On the card, nine tenths or more of a small fit's device time is
    charged to a span below ``fit``, and the spans add no user annotation
    (whose device-side copy would read as device work)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_ensemble_tpu_torch.models.gbm import GBMClassifier
    from spark_ensemble_tpu_torch.models.tree import DecisionTreeRegressor

    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn(200_000, 28, device="cuda", generator=g)
    y = (X[:, :4].sum(1) + torch.randn(200_000, device="cuda", generator=g) > 0).float()
    est = GBMClassifier(loss="bernoulli", num_base_learners=3, optimized_weights=True,
                        base_learner=DecisionTreeRegressor(max_depth=8, max_bins=63,
                                                           hist="fused",
                                                           hist_precision="highest"))
    est.fit(X, y, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        est.fit(X, y, device="cuda")
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    assert not any(e.is_user_annotation() for e in events)
    table = span_table(events)
    device = sum(e.duration_ns() for e in events if "CUDA" in str(e.device_type())) * 1e-9
    below = sum(row["device_s"] for name, row in table.items() if name != "fit")
    assert device > 0 and below >= 0.9 * device, (below, device, table)
