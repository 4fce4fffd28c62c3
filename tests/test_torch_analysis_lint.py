"""The port's lint (tier 1 of ``spark_ensemble_tpu_torch.analysis``): the
engine against the JAX package's on the same sources, each torch rule on
its fixture pair under ``tests/fixtures/lint_torch/``, the port linting
clean, the JSONL records and the CLI's exit codes."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from spark_ensemble_tpu.analysis import lint as jax_lint
from spark_ensemble_tpu_torch.analysis import all_rules, lint_file, lint_paths
from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod
from spark_ensemble_tpu_torch.analysis.cli import main as graftlint_main
from spark_ensemble_tpu_torch.analysis.lint import DEFAULT_TARGETS, write_jsonl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "lint_torch")
RULE_IDS = sorted(all_rules())

#: the JAX rules that carry a meaning in torch (analysis/rules.py's docstring
#: says why the other four do not)
PORTED = ["f64-upcast", "key-reuse", "unclosed-span", "unfenced-blocking-read"]


def _unsuppressed(findings, rule):
    return [f for f in findings if f.rule == rule and not f.suppressed]


def _fixture(rule_id, kind):
    return os.path.join(FIXTURES, f"{rule_id.replace('-', '_')}_{kind}.py")


def test_the_four_torch_rules_are_registered():
    assert RULE_IDS == PORTED
    assert set(PORTED) < set(jax_lint.all_rules())


# ---------------------------------------------------------------------------
# rule fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_fixture_pair_exists(rule_id):
    assert os.path.exists(_fixture(rule_id, "bad")), rule_id
    assert os.path.exists(_fixture(rule_id, "ok")), rule_id


#: lines of each bad fixture the rule must flag
BAD_LINES = {
    "f64-upcast": {7, 8, 9, 14},
    "key-reuse": {8, 16},
    "unclosed-span": {6, 10, 18},
    "unfenced-blocking-read": {11, 16, 20, 24, 28, 32},
}


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_fires_on_bad_fixture(rule_id):
    findings = _unsuppressed(lint_file(_fixture(rule_id, "bad"), select=[rule_id]), rule_id)
    assert {f.line for f in findings} == BAD_LINES[rule_id]
    assert all(f.message and f.col >= 0 for f in findings)


@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_quiet_on_ok_fixture(rule_id):
    findings = _unsuppressed(lint_file(_fixture(rule_id, "ok"), select=[rule_id]), rule_id)
    assert not findings, [f.to_record() for f in findings]


def test_unclosed_span_matches_the_jax_rule_on_its_fixtures():
    """The framework-free rule is the JAX package's, unchanged: the same
    findings on both packages' fixtures."""
    for kind in ("bad", "ok"):
        for path in (_fixture("unclosed-span", kind),
                     os.path.join(ROOT, "tests", "fixtures", "lint",
                                  f"unclosed_span_{kind}.py")):
            ours = [f.to_record() for f in lint_file(path, select=["unclosed-span"])]
            theirs = [f.to_record() for f in jax_lint.lint_file(path, select=["unclosed-span"])]
            assert ours == theirs


# ---------------------------------------------------------------------------
# the engine against the JAX package's
# ---------------------------------------------------------------------------

_SPAN_SRC = textwrap.dedent(
    """\
    def leaky(telem):
        telem.begin_span("round_chunk"){trailing}


    def ok(telem):
        with telem.begin_span("fit"):
            pass
    """
)

ENGINE_CASES = {
    "trailing": _SPAN_SRC.format(
        trailing="  # graftlint: ignore[unclosed-span] -- fixture reason"),
    "full_line": _SPAN_SRC.format(trailing="").replace(
        '    telem.begin_span("round_chunk")',
        '    # graftlint: ignore[unclosed-span] -- above-line form\n\n'
        '    telem.begin_span("round_chunk")'),
    "bare": _SPAN_SRC.format(trailing="  # graftlint: ignore[unclosed-span]"),
    "all_token": _SPAN_SRC.format(trailing="  # graftlint: ignore[all] -- every rule"),
    "other_rule": _SPAN_SRC.format(
        trailing="  # graftlint: ignore[key-reuse] -- not this rule"),
    "meta": ("# graftlint: ignore[suppression-missing-reason] -- nice try\n"
             "x = 1  # graftlint: ignore[unclosed-span]\n"),
    "syntax_error": "def f(:\n",
    "unsuppressed": _SPAN_SRC.format(trailing=""),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_jax_engine(case, tmp_path):
    """Suppressions (trailing, full-line, bare, ``all``), the meta rule and
    a syntax error resolve exactly as in the JAX package: equal records,
    suppressed flags and justifications."""
    p = tmp_path / "mod.py"
    p.write_text(ENGINE_CASES[case])
    ours = [f.to_record() for f in lint_file(str(p), select=["unclosed-span"])]
    theirs = [f.to_record() for f in jax_lint.lint_file(str(p), select=["unclosed-span"])]
    assert ours == theirs
    assert ours, case  # every case yields at least one finding


def test_bare_suppression_suppresses_nothing(tmp_path):
    p = tmp_path / "mod.py"
    p.write_text(ENGINE_CASES["bare"])
    findings = lint_file(str(p))
    assert _unsuppressed(findings, "unclosed-span")
    meta = [f for f in findings if f.rule == "suppression-missing-reason"]
    assert meta and not meta[0].suppressed


def test_syntax_error_is_one_finding(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    assert [f.rule for f in lint_file(str(p))] == ["syntax-error"]


# ---------------------------------------------------------------------------
# the port lints clean
# ---------------------------------------------------------------------------


def test_default_targets_are_the_port_and_its_drivers():
    assert DEFAULT_TARGETS[0] == "spark_ensemble_tpu_torch"
    for t in DEFAULT_TARGETS:
        assert os.path.exists(os.path.join(ROOT, t)), t
        assert not t.startswith("spark_ensemble_tpu/") and t != "spark_ensemble_tpu"


def test_port_lints_clean():
    findings = lint_paths()
    loud = [f.to_record() for f in findings if not f.suppressed]
    assert not loud, loud
    assert all(f.justification for f in findings if f.suppressed)
    assert {f.path.split("/")[0] for f in findings} <= {
        "spark_ensemble_tpu_torch", "chip_smoke.py", "tools"}


def _emulation_site(path, line):
    """(file under the package, enclosing function) of a source line."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    best = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.lineno <= line <= node.end_lineno:
            if best is None or node.lineno > best.lineno:
                best = node
    rel = os.path.relpath(path, "spark_ensemble_tpu_torch").replace(os.sep, "/")
    return rel, best.name if best else None


def test_every_f64_suppression_is_a_named_emulation_site():
    """The port's float64 sites are the emulation sites the contracts'
    f64 watch allows, plus the watch's own dtype test, and each carries a
    reason."""
    sites = set()
    for f in lint_paths(select=["f64-upcast"]):
        assert f.suppressed and f.justification
        if f.path.startswith("spark_ensemble_tpu_torch/analysis/"):
            continue
        sites.add(_emulation_site(f.path, f.line))
    assert sites == set(contracts_mod.F64_EMULATION_SITES)


# ---------------------------------------------------------------------------
# JSONL + CLI
# ---------------------------------------------------------------------------


def test_jsonl_record_shape(tmp_path):
    findings = lint_file(_fixture("key-reuse", "bad"))
    out = tmp_path / "findings.jsonl"
    write_jsonl(findings, str(out))
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(records) == len(findings) == 2
    for rec in records:
        assert rec["event"] == "lint_finding"
        assert {"rule", "file", "line", "col", "message", "suppressed"} <= set(rec)


def test_cli_exit_codes(capsys):
    assert graftlint_main([_fixture("f64-upcast", "bad")]) == 1
    assert graftlint_main([_fixture("f64-upcast", "ok")]) == 0
    # --select runs only the named rules
    assert graftlint_main([_fixture("f64-upcast", "bad"), "--select", "key-reuse"]) == 0
    assert graftlint_main([_fixture("f64-upcast", "bad"), "--no-lint"]) == 0
    assert graftlint_main(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    for rule_id in RULE_IDS:
        assert rule_id in listing


def test_cli_writes_jsonl(tmp_path):
    out = tmp_path / "lint.jsonl"
    rc = graftlint_main([_fixture("unfenced-blocking-read", "bad"), "--jsonl", str(out)])
    assert rc == 1
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert sum(r["rule"] == "unfenced-blocking-read" for r in records) == 6


def test_tool_exits_zero_on_the_port():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "graftlint_torch.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "graftlint tier 1: 0 finding(s)" in out.stdout
