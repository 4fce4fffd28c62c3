"""Tier-1 engine: AST lint over the port, with justified suppressions
(PyTorch port of ``analysis/lint.py``; stdlib only, it imports neither
torch nor the JAX package).

The engine owns everything rule-independent: file discovery, parsing,
comment/suppression extraction, the rule registry, and JSONL rendering.
Rules (:mod:`~spark_ensemble_tpu_torch.analysis.rules`) are small visitor
classes registered with :func:`register_rule`; each sees a
:class:`FileContext` (source, AST, import map, parent map) and yields
:class:`Finding` records.

Suppression syntax — one comment, on the offending line or the line
directly above it::

    host = out.tolist()  # graftlint: ignore[unfenced-blocking-read] -- warmup read, untimed

The justification after ``--`` is **mandatory**: a bare
``# graftlint: ignore[rule]`` is itself reported as
``suppression-missing-reason`` and does not suppress anything, so every
silenced finding carries a human-readable reason.  A file that does not
parse is one ``syntax-error`` finding.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: repo-relative targets a bare run lints: the port and its drivers (tests
#: are excluded, they read device values freely; the JAX package and its
#: tools have their own linter, ``tools/graftlint.py``)
DEFAULT_TARGETS = (
    "spark_ensemble_tpu_torch",
    "chip_smoke.py",
    "fit_ab.py",
    "tools/autotune_torch.py",
    "tools/autotune_resolve_cost.py",
    "tools/graftlint_torch.py",
)

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore\[([A-Za-z0-9_\-, ]+)\]\s*(?:--\s*(\S.*))?\s*$"
)


@dataclass
class Finding:
    """One lint finding: ``file:line`` + rule id + message, plus the
    suppression state resolved by the engine."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_record(self) -> dict:
        """The JSONL record shape shared with the telemetry tooling
        (``tools/telemetry_report.py`` conventions: flat JSON object per
        line, snake_case keys)."""
        rec = {
            "event": "lint_finding",
            "rule": self.rule,
            "file": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
        }
        if self.justification:
            rec["justification"] = self.justification
        return rec


@dataclass
class Suppression:
    rules: Tuple[str, ...]
    reason: Optional[str]
    comment_line: int
    target_line: int
    used: bool = False


class LintRule:
    """Base class for pluggable rules.

    Subclasses set ``id`` (kebab-case, stable — it is the suppression
    token and the JSONL key) and ``doc`` (one paragraph rendered into the
    rule catalogue), and implement :meth:`check`.  Each rule has a
    minimal positive and negative fixture under
    ``tests/fixtures/lint_torch/`` named ``<id with _>_bad.py`` /
    ``<id with _>_ok.py``.
    """

    id: str = ""
    doc: str = ""

    def check(self, ctx: "FileContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=ctx.relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


_REGISTRY: Dict[str, LintRule] = {}


def register_rule(cls):
    """Class decorator adding a rule to the registry (instantiated once;
    rules are stateless across files)."""
    rule = cls()
    if not rule.id:
        raise ValueError(f"{cls.__name__} must set a rule id")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    _REGISTRY[rule.id] = rule
    return cls


def all_rules() -> Dict[str, LintRule]:
    from spark_ensemble_tpu_torch.analysis import rules as _rules  # noqa: F401

    return dict(_REGISTRY)


@dataclass
class FileContext:
    """Everything a rule may want about one file, parsed once."""

    path: str
    relpath: str
    src: str
    lines: List[str]
    tree: ast.Module
    comments: Dict[int, str] = field(default_factory=dict)
    _imports: Optional[object] = None
    _parents: Optional[dict] = None

    @property
    def imports(self):
        if self._imports is None:
            from spark_ensemble_tpu_torch.analysis.rules import ImportMap

            self._imports = ImportMap(self.tree)
        return self._imports

    @property
    def parents(self) -> dict:
        if self._parents is None:
            parents: dict = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    parents[child] = parent
            self._parents = parents
        return self._parents

    def enclosing_function(self, node: ast.AST):
        """Nearest enclosing FunctionDef/AsyncFunctionDef, or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None


def _collect_comments(src: str) -> Dict[int, str]:
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        pass
    return comments


def _parse_suppressions(
    comments: Dict[int, str], lines: List[str]
) -> Tuple[Dict[int, List[Suppression]], List[Finding]]:
    """Suppression map (target line -> suppressions) + the findings the
    suppressions themselves generate (missing justification)."""
    by_line: Dict[int, List[Suppression]] = {}
    meta: List[Finding] = []
    for line_no, text in comments.items():
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = tuple(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        reason = (m.group(2) or "").strip() or None
        code = lines[line_no - 1][: lines[line_no - 1].find("#")].strip()
        if code:
            target = line_no  # trailing comment: suppress its own line
        else:
            # full-line comment: suppress the next line carrying code
            target = line_no + 1
            while target <= len(lines) and not lines[target - 1].strip():
                target += 1
        sup = Suppression(rules, reason, line_no, target)
        if reason is None:
            meta.append(
                Finding(
                    rule="suppression-missing-reason",
                    path="",  # engine fills the relpath
                    line=line_no,
                    col=0,
                    message=(
                        "graftlint suppression without a justification: "
                        "append ` -- <reason>` (a bare ignore suppresses "
                        "nothing)"
                    ),
                )
            )
        else:
            by_line.setdefault(target, []).append(sup)
    return by_line, meta


def lint_file(
    path: str,
    repo_root: Optional[str] = None,
    select: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Lint one file; returns ALL findings with suppressed ones marked
    (callers gate on the unsuppressed subset)."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    relpath = (
        os.path.relpath(path, repo_root) if repo_root else path
    )
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [
            Finding(
                rule="syntax-error",
                path=relpath,
                line=e.lineno or 0,
                col=e.offset or 0,
                message=f"cannot parse: {e.msg}",
            )
        ]
    lines = src.splitlines()
    ctx = FileContext(
        path=path,
        relpath=relpath,
        src=src,
        lines=lines,
        tree=tree,
        comments=_collect_comments(src),
    )
    suppressions, findings = _parse_suppressions(ctx.comments, lines)
    for f_ in findings:
        f_.path = relpath
    rules = all_rules()
    wanted = set(select) if select else None
    for rule_id, rule in sorted(rules.items()):
        if wanted is not None and rule_id not in wanted:
            continue
        for finding in rule.check(ctx):
            findings.append(finding)
    for finding in findings:
        if finding.rule == "suppression-missing-reason":
            continue  # the meta rule cannot be suppressed
        for sup in suppressions.get(finding.line, []):
            if finding.rule in sup.rules or "all" in sup.rules:
                finding.suppressed = True
                finding.justification = sup.reason
                sup.used = True
    return findings


def discover_files(targets: Iterable[str], repo_root: str) -> List[str]:
    out: List[str] = []
    for target in targets:
        full = (
            target
            if os.path.isabs(target)
            else os.path.join(repo_root, target)
        )
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [
                d for d in dirnames if d not in ("__pycache__", ".git")
            ]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.join(dirpath, name))
    return sorted(set(out))


def lint_paths(
    targets: Optional[Iterable[str]] = None,
    repo_root: Optional[str] = None,
    select: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Lint ``targets`` (files or directories; default:
    :data:`DEFAULT_TARGETS`) relative to ``repo_root`` (default: the
    checkout holding the port)."""
    if repo_root is None:
        repo_root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    files = discover_files(targets or DEFAULT_TARGETS, repo_root)
    findings: List[Finding] = []
    for path in files:
        findings.extend(lint_file(path, repo_root=repo_root, select=select))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def write_jsonl(findings: Iterable[Finding], path: str) -> None:
    """One finding per line, in the flat-JSON-record shape the telemetry
    tooling reads and diffs (``tools/telemetry_report.py``)."""
    with open(path, "w") as f:
        for finding in findings:
            f.write(json.dumps(finding.to_record(), sort_keys=True) + "\n")
