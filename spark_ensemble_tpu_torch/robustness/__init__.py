"""The fault-tolerant training runtime (PyTorch port of
``robustness/``): numeric guards, retry with backoff, fail-fast input
validation and the deterministic chaos harness.

- ``guards``: a fused non-finite check over each round chunk's outputs
  with the ``on_nonfinite`` policies raise | skip_round | halve_step |
  stop_early (``off`` disables the check);
- ``retry``: exponential backoff with deterministic jitter around round
  launches, member fits and checkpoint I/O;
- ``validate``: NaN/Inf input validation at ``fit()`` entry;
- ``chaos``: the fault injector (``SE_TPU_CHAOS``) for NaN gradients,
  preemption, transient errors and checkpoint corruption.
"""

from spark_ensemble_tpu_torch.robustness.chaos import (
    ChaosController,
    ChaosPreemption,
    ChaosTransientError,
)
from spark_ensemble_tpu_torch.robustness.guards import (
    NONFINITE_POLICIES,
    NonFiniteError,
    NumericGuard,
)
from spark_ensemble_tpu_torch.robustness.retry import RetryPolicy, retry_call
from spark_ensemble_tpu_torch.robustness.validate import validate_fit_inputs

__all__ = [
    "ChaosController",
    "ChaosPreemption",
    "ChaosTransientError",
    "NONFINITE_POLICIES",
    "NonFiniteError",
    "NumericGuard",
    "RetryPolicy",
    "retry_call",
    "validate_fit_inputs",
]
