"""Static and traced analysis of the port: the ``graftlint`` two-tier gate
(PyTorch port of ``analysis/``).

The port's speed and exactness rest on invariants nothing in the type
system checks: bit-identity needs PRNG keys derived from absolute round
indices (never reused), the lookahead pipeline needs no unfenced blocking
host reads inside the dispatch window, and the serving engine needs zero
CUDA-graph captures after warmup.  This package checks them before a
change lands:

- **Tier 1** (:mod:`~spark_ensemble_tpu_torch.analysis.lint`): an AST
  linter with pluggable rules (:mod:`~spark_ensemble_tpu_torch.analysis.
  rules`): key reuse, unfenced blocking reads, f64 upcasts, unclosed
  spans.  Findings carry ``file:line`` + rule id;
  ``# graftlint: ignore[rule] -- reason`` suppresses with a mandatory
  justification.
- **Tier 2** (:mod:`~spark_ensemble_tpu_torch.analysis.contracts`): fits
  and predicts every family, the streaming, sweep and sampled fits, the
  serving engine, the fleet and the operator plane on canonical tiny
  data, and holds their budgets (distinct programs per entry point,
  kernel launches and host reads per round, captures after warmup, nvcc
  builds inside a fit) against the committed ``analysis/contracts.json``,
  with the intrinsic checks (no f64 inside a round, collective axes on
  the mesh's own axes).

Both tiers run from ``tools/graftlint_torch.py``.
"""

from spark_ensemble_tpu_torch.analysis.contracts import (
    ContractReport,
    ContractViolation,
    check_contracts,
    trace_contracts,
    update_baseline,
)
from spark_ensemble_tpu_torch.analysis.lint import (
    Finding,
    LintRule,
    all_rules,
    lint_file,
    lint_paths,
    register_rule,
)

# importing the rules module populates the registry
from spark_ensemble_tpu_torch.analysis import rules as _rules  # noqa: F401

__all__ = [
    "Finding",
    "LintRule",
    "all_rules",
    "lint_file",
    "lint_paths",
    "register_rule",
    "ContractReport",
    "ContractViolation",
    "check_contracts",
    "trace_contracts",
    "update_baseline",
]
