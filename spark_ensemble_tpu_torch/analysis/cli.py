"""``graftlint`` command line for the port: both tiers, one exit code
(PyTorch port of ``analysis/cli.py``; run it as
``python tools/graftlint_torch.py``).

Exit 0 iff the repo is clean — zero unsuppressed tier-1 findings and
(with ``--contracts``) zero contract violations.  Suppressed findings
are listed (with their justifications) but never fail the run; the
``--jsonl`` artifact carries every finding, suppressed or not, in the
flat-record shape ``tools/telemetry_report.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint_torch",
        description=(
            "Static analysis for spark_ensemble_tpu_torch: AST lint "
            "(tier 1) + program contracts (tier 2)."
        ),
    )
    p.add_argument(
        "targets",
        nargs="*",
        help="files/directories to lint (default: the port, chip_smoke.py, "
        "fit_ab.py and the port's tools)",
    )
    p.add_argument(
        "--select",
        action="append",
        metavar="RULE",
        help="run only these rule ids (repeatable)",
    )
    p.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalogue (id + doc) and exit",
    )
    p.add_argument(
        "--jsonl",
        metavar="PATH",
        help="write every finding (and contract violation) as JSONL",
    )
    p.add_argument(
        "--no-lint",
        action="store_true",
        help="skip tier 1 (contracts only)",
    )
    p.add_argument(
        "--contracts",
        action="store_true",
        help="also run tier 2: fit/predict every family, the kernels, "
        "serving and the planes on --device, and check the budgets against "
        "analysis/contracts.json",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="re-trace on --device and rewrite analysis/contracts.json "
        "(a budget the device cannot measure keeps its pin), then exit",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="the device the contracts run on (default cuda; cpu for a "
        "machine without a card)",
    )
    p.add_argument(
        "--show-suppressed",
        action="store_true",
        help="list suppressed findings with their justifications",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    from spark_ensemble_tpu_torch.analysis import lint as lint_mod

    if args.list_rules:
        for rule_id, rule in sorted(lint_mod.all_rules().items()):
            print(f"{rule_id}")
            print(f"    {rule.doc}")
        return 0

    if args.update_baseline:
        from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod

        base = contracts_mod.update_baseline(device=args.device)
        print(
            f"wrote {contracts_mod._BASELINE_PATH} "
            f"({len(base['entry_points'])} entry points)"
        )
        for entry, n in sorted(base["entry_points"].items()):
            print(f"  {entry}: {n}")
        return 0

    records: List[dict] = []
    failures = 0

    if not args.no_lint:
        findings = lint_mod.lint_paths(
            targets=args.targets or None, select=args.select
        )
        records.extend(f.to_record() for f in findings)
        for f in findings:
            if f.suppressed:
                if args.show_suppressed:
                    print(
                        f"{f.location()}: {f.rule} [suppressed: "
                        f"{f.justification}]"
                    )
                continue
            failures += 1
            print(f"{f.location()}:{f.col}: {f.rule}: {f.message}")
        n_sup = sum(1 for f in findings if f.suppressed)
        print(
            f"graftlint tier 1: {failures} finding(s), "
            f"{n_sup} suppressed (justified)"
        )

    if args.contracts:
        from spark_ensemble_tpu_torch.analysis import contracts as contracts_mod

        report = contracts_mod.check_contracts(device=args.device,
                                               spawn_ranks=True)
        records.extend(v.to_record() for v in report.violations)
        for entry, n in sorted(report.budgets.items()):
            records.append(
                {"event": "contract_budget", "entry_point": entry,
                 "budget": n}
            )
        for v in report.violations:
            failures += 1
            print(f"contract {v.contract}: {v.entry_point}: {v.message}")
        for entry, why in sorted(report.skipped.items()):
            print(f"contract skipped: {entry}: {why}")
        print(
            f"graftlint tier 2: {len(report.budgets)} entry points, "
            f"{len(report.violations)} violation(s)"
        )

    if args.jsonl:
        with open(args.jsonl, "w") as f:
            for rec in records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
