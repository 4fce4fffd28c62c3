#!/usr/bin/env python
"""Repo entry point for the port's graftlint (``spark_ensemble_tpu_torch.
analysis``), beside ``tools/graftlint.py`` for the JAX package.

    python tools/graftlint_torch.py                     # tier-1 lint of the port
    python tools/graftlint_torch.py --contracts         # + tier-2 contracts on the card
    python tools/graftlint_torch.py --contracts --device cpu
    python tools/graftlint_torch.py --update-baseline --device cuda
    python tools/graftlint_torch.py --list-rules

Exits 0 if and only if the port is clean.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spark_ensemble_tpu_torch.analysis.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
