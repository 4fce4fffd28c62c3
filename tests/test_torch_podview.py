"""Pod-scope trace stitching in the port (``telemetry/podview.py``) against
the JAX package's, on the JAX package's synthetic host streams and on the
port's own per-rank streams of an elastic rewind.

Tolerances:
- Parity: the same streams through both packages' ``estimate_offsets``,
  ``stitch``, ``skew_report`` and ``render_skew`` give EQUAL output (the
  same pure-Python arithmetic in the same order).
- The port's 3 gloo ranks share one host clock: every estimated offset is
  within 50 ms of 0 (the barrier spans of a CPU fit unblock within
  milliseconds of one another; the JAX package's synthetic streams put
  known skews of seconds in).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

import _torch_mesh_worker as mw
from spark_ensemble_tpu.telemetry import podview as jax_podview
from spark_ensemble_tpu_torch.telemetry import podview

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# tests/test_podview.py's generator (tests/ is not a package)
def _host_stream(h, skew, steps_by_round, jitter=None, flow_out=None,
                 flow_in=None, digest="d1", stalls=()):
    """A synthetic per-host stream of one distributed fit: hosts cross
    the same TRUE barrier walls, but each records them on its own clock
    (``true + skew``).  ``steps_by_round[r]`` is this host's sweep-step
    wall for round r; fetch pads every host to the common barrier."""
    jitter = jitter or [0.0] * 8
    fid = f"fit_h{h}"
    ev = [
        {"event": "fit_start", "fit_id": fid, "family": "GBM",
         "ts": 99.0 + skew},
        {"event": "dist_config", "fit_id": fid, "process": h, "hosts": 2,
         "positions": 2, "ts": 99.5 + skew},
        {"event": "dist_manifest_agreed", "fit_id": fid,
         "ts": 100.0 + skew + jitter[0], "digest": digest},
    ]
    slowest = max(steps_by_round)
    for r, steps in enumerate(steps_by_round):
        barrier = 101.0 + r + slowest
        fetch = barrier - (101.0 + r + steps)
        ev.append({
            "event": "span", "name": "dist_level_0",
            "trace_id": f"t{h}", "span_id": f"L{r}", "parent_id": "",
            "ts": 101.0 + r + skew + jitter[1 + r],
            "dur_s": steps + fetch + 0.01,
            "pid": 1000 + h, "thread": f"host{h}", "fit_id": fid,
            "steps_s": steps, "fetch_s": fetch, "round": r,
        })
    for site, seconds in stalls:
        ev.append({"event": "host_stalled", "fit_id": fid,
                   "ts": 101.2 + skew, "victim": h, "site": site,
                   "seconds": seconds})
    if flow_out is not None:
        ev.append({
            "event": "span", "name": "host_preempt",
            "trace_id": f"t{h}", "span_id": "pre", "parent_id": "",
            "ts": 103.0 + skew, "dur_s": 0.0, "pid": 1000 + h,
            "thread": f"host{h}", "fit_id": fid, "flow_out": [flow_out],
        })
    if flow_in is not None:
        ev.append({
            "event": "span", "name": "rewind",
            "trace_id": f"t{h}", "span_id": "rew", "parent_id": "",
            "ts": 103.5 + skew, "dur_s": 0.0, "pid": 1000 + h,
            "thread": f"host{h}", "fit_id": fid, "flow_in": flow_in,
        })
    return ev


SCENARIOS = {
    "known_skew": lambda: [_host_stream(0, 0.0, [0.05, 0.05]),
                           _host_stream(1, 3.7, [0.05, 0.05])],
    "jitter": lambda: [
        _host_stream(0, 0.0, [0.05, 0.05, 0.05], jitter=[0.002, -0.004, 0.001, 0.003]),
        _host_stream(1, -1.25, [0.05, 0.05, 0.05], jitter=[-0.003, 0.004, -0.002, 0.001])],
    "no_shared_barrier": lambda: [_host_stream(0, 0.0, [0.05]), [{"event": "fit_start"}]],
    "digest_mismatch": lambda: [_host_stream(0, 0.0, [0.05], digest="aaaa"),
                                _host_stream(1, 0.0, [0.05], digest="bbbb")],
    "cross_host_flow": lambda: [_host_stream(0, 0.0, [0.05], flow_in=424242),
                                _host_stream(1, 0.0, [0.05], flow_out=424242)],
    "straggler": lambda: [
        _host_stream(0, 0.0, [0.05, 0.05]),
        _host_stream(1, 2.0, [0.05, 0.45],
                     stalls=[("GBM:stream_round:1:level:0:dist_step:0", 0.4)])],
    "single_host": lambda: [_host_stream(0, 0.0, [0.05])],
    "empty": lambda: [],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_parity_with_the_jax_package(name):
    streams = SCENARIOS[name]()
    assert podview.estimate_offsets(streams) == jax_podview.estimate_offsets(streams)
    assert podview.stitch(streams) == jax_podview.stitch(streams)
    report = podview.skew_report(streams)
    assert report == jax_podview.skew_report(streams)
    assert podview.render_skew(report) == jax_podview.render_skew(report)


def test_offsets_recover_known_skew():
    offsets = podview.estimate_offsets(SCENARIOS["known_skew"]())
    assert offsets[0] == 0.0 and abs(offsets[1] - 3.7) < 1e-9


def test_skew_report_names_the_straggler():
    report = podview.skew_report(SCENARIOS["straggler"]())
    r1 = next(r for r in report["rounds"] if r["round"] == 1)
    assert r1["offender"] == 1 and r1["ratio"] > 1.5
    assert report["persistent_offender"] == 1
    assert report["stalls"]["1"]["count"] == 1


def test_expand_inputs_parity(tmp_path):
    (tmp_path / "sub").mkdir()
    for name in ("b.jsonl", "a.jsonl", "sub/c.jsonl", "skip.txt"):
        (tmp_path / name).write_text("{}\n")
    args = [str(tmp_path), str(tmp_path / "a.jsonl")]
    got = podview.expand_inputs(args)
    assert got == jax_podview.expand_inputs(args)
    assert [os.path.basename(p) for p in got] == ["a.jsonl", "b.jsonl", "c.jsonl"]


def test_load_stream_skips_a_torn_tail(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text('{"event": "fit_start"}\n\n{"event": "round_e')
    assert podview.load_stream(str(p)) == [{"event": "fit_start"}]


# -- the port's own rewind streams ---------------------------------------------


@pytest.fixture(scope="module")
def rewind(tmp_path_factory):
    out = tmp_path_factory.mktemp("podview")
    try:
        mw.free_port()
    except OSError as e:  # the sandbox forbids loopback sockets
        pytest.skip(f"no loopback sockets: {e}")
    mw.spawn("podview", str(out), timeout=300, world=mw.PODVIEW_W)
    ranks = [dict(np.load(os.path.join(out, f"podview_r{r}.npz")))
             for r in range(mw.PODVIEW_W)]
    paths = [os.path.join(out, f"tel_r{r}", "t.jsonl") for r in range(mw.PODVIEW_W)]
    return ranks, paths, str(out)


def test_the_rewind_ran_as_planned(rewind):
    ranks, _, _ = rewind
    assert [bool(r["victim"]) for r in ranks] == [False, True, False]
    assert str(ranks[0]["digest"]) == str(ranks[2]["digest"])


def test_rewind_streams_stitch_into_one_pod_trace(rewind):
    """The three ranks' streams: hosts are the ranks, the first attempt
    and the resumed fit are two pod groups, the offsets are near 0 (one
    host clock), and the victim's ``host_preempt`` flow resolves into a
    survivor's ``rewind`` only once the streams are stitched."""
    ranks, paths, out = rewind
    viewer = _load_tool("trace_viewer")
    merged, info = podview.stitch_files([out])
    assert info["inputs"] == paths
    assert info["hosts"] == [0, 1, 2]
    assert info["groups"] == 2
    assert info["digest_mismatches"] == []
    assert all(abs(o) < 0.05 for o in info["offsets"]), info["offsets"]
    spans = viewer.select_spans(merged)
    assert viewer.validate(spans) == []
    fid = int(ranks[0]["fid"])
    pre = [s for s in spans if s["name"] == "host_preempt"]
    rew = [s for s in spans if s["name"] == "rewind"]
    assert [s["host"] for s in pre] == [1] and pre[0]["flow_out"] == [fid]
    assert sorted(s["host"] for s in rew) == [0, 2]
    assert all(s["flow_in"] == fid for s in rew)
    # a survivor's stream alone leaves the rewind's flow unresolved
    survivor = viewer.select_spans(podview.load_stream(paths[0]))
    assert any("flow_in" in p for p in viewer.validate(survivor))
    # the dist spans moved onto the pod traces, ids prefixed by rank
    dist = [s for s in spans if s["name"].startswith("dist_level_")]
    assert dist and all(s["trace_id"].startswith("pod.") for s in dist)
    assert {s["span_id"].split(".")[0] for s in dist} == {"h0", "h1", "h2"}


def test_rewind_streams_match_the_jax_package(rewind):
    _, paths, _ = rewind
    streams = [podview.load_stream(p) for p in paths]
    assert podview.stitch(streams) == jax_podview.stitch(streams)
    assert podview.skew_report(streams) == jax_podview.skew_report(streams)
    assert podview.estimate_offsets(streams) == jax_podview.estimate_offsets(streams)


def test_skew_report_over_the_rewind(rewind):
    _, paths, _ = rewind
    streams = [podview.load_stream(p) for p in paths]
    report = podview.skew_report(streams)
    assert report["hosts"] == [0, 1, 2]
    # 4 rounds of dist spans (the resumed fit replays from the checkpoint)
    assert sorted(r["round"] for r in report["rounds"]) == [0, 1, 2, 3]
    assert report["pod_skew_ratio"] >= 1.0
    assert "== pod skew ==" in podview.render_skew(report)


def test_trace_viewer_cli_reads_the_rewind_directory(rewind, tmp_path, capsys):
    _, _, out = rewind
    viewer = _load_tool("trace_viewer")
    dest = tmp_path / "pod.json"
    assert viewer.main(["--jsonl", out, "--out", str(dest)]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["hosts"] == [0, 1, 2]
    names = {e["args"]["name"] for e in json.loads(dest.read_text())["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert {"host0", "host1", "host2"} <= names
