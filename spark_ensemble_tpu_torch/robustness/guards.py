"""Numeric guards: fused non-finite detection over per-round outputs
(PyTorch port of ``robustness/guards.py``).

A single non-finite gradient silently poisons every later round.  The
guard catches it in the chunk it happens: one fused reduction over the
chunk's outputs (member params, step sizes, losses, each with a leading
round axis) yields a per-round ``bool`` vector, and only that vector
crosses to the host, in one read.

Recovery is policy-driven (``on_nonfinite`` estimator param):

- ``raise``       fail fast with :class:`NonFiniteError` (default);
- ``skip_round``  drop the poisoned round's contribution and go on;
- ``halve_step``  re-run the round at a halved step until finite (GBM;
  families without a scalable step degrade to skip);
- ``stop_early``  truncate the ensemble to the last good round;
- ``off``         no check at all.

:meth:`NumericGuard.record` logs each action, emits it as a
``guard_nonfinite`` event on the fit's telemetry stream, and keeps it on
the guard (``NumericGuard.events``, which the fitted model carries as
``guard_events_``).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

logger = logging.getLogger("spark_ensemble_tpu_torch")

NONFINITE_POLICIES = ("off", "raise", "skip_round", "halve_step",
                      "stop_early")


class NonFiniteError(FloatingPointError):
    """A non-finite value surfaced in a round's outputs under the
    ``on_nonfinite="raise"`` policy.  Carries ``family`` and
    ``round_index`` so the failure is attributable without re-running."""

    def __init__(self, message: str, family: str = "",
                 round_index: Optional[int] = None):
        super().__init__(message)
        self.family = family
        self.round_index = round_index


def _float_leaves(trees) -> List[torch.Tensor]:
    """The floating tensors of nested dicts, lists, tuples and NamedTuples
    (``None`` and non-tensors skipped)."""
    out: List[torch.Tensor] = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor) and node.is_floating_point():
            out.append(node)

    for tree in trees:
        walk(tree)
    return out


def round_nonfinite_flags(nan_leaves, strict_leaves) -> torch.Tensor:
    """``bool[c]``: per-round badness over leaves that share the leading
    round axis ``c``.  ``nan_leaves`` are checked for NaN only (tree split
    thresholds carry +inf sentinels); ``strict_leaves`` (step sizes,
    losses) must be fully finite.  One fused reduction, read by the caller
    in one host transfer."""
    bad = None
    for x in nan_leaves:
        b = torch.isnan(x.reshape(x.shape[0], -1)).any(dim=1)
        bad = b if bad is None else bad | b
    for x in strict_leaves:
        b = (~torch.isfinite(x.reshape(x.shape[0], -1))).any(dim=1)
        bad = b if bad is None else bad | b
    return bad


def tree_any_nan(*trees) -> bool:
    """Host bool: any NaN anywhere in the given trees (the whole-model
    check of families without a round axis; NaN only, for the +inf
    sentinel reason of :func:`round_nonfinite_flags`)."""
    leaves = _float_leaves(trees)
    if not leaves:
        return False
    return bool(torch.stack([torch.isnan(x).any() for x in leaves]).any())


class NumericGuard:
    """Per-fit guard: detection, policy and the record of what the policy
    did.  The round loops own recovery (they hold the carry to rewind
    and replay); the guard owns detection (:meth:`first_nonfinite`,
    :meth:`member_flags`) and the ``events`` record."""

    def __init__(self, policy: str, family: str = "", max_halvings: int = 4,
                 telem=None):
        if policy not in NONFINITE_POLICIES:
            raise ValueError(
                f"on_nonfinite must be one of {NONFINITE_POLICIES}, "
                f"got {policy!r}"
            )
        self.policy = policy
        self.family = family
        self.max_halvings = max_halvings
        self.telem = telem
        self.events: List[dict] = []

    @property
    def active(self) -> bool:
        return self.policy != "off"

    def flags(self, params, *arrays) -> Optional[torch.Tensor]:
        """``bool[c]`` device flags of a chunk (params NaN-only, ``arrays``
        strict), or ``None`` when there is nothing to check; the caller
        reads them with its other per-chunk values in one transfer."""
        nan_leaves = _float_leaves((params,))
        strict_leaves = _float_leaves(arrays)
        if not nan_leaves and not strict_leaves:
            return None
        return round_nonfinite_flags(nan_leaves, strict_leaves)

    def first_nonfinite(self, params, *arrays) -> Optional[int]:
        """Index of the first bad round of a chunk whose trees all carry a
        leading round axis, or ``None`` when the chunk is clean."""
        flags = self.member_flags(params, *arrays)
        if flags is None:
            return None
        idx = np.flatnonzero(flags)
        return int(idx[0]) if idx.size else None

    def member_flags(self, params, *arrays) -> Optional[np.ndarray]:
        """``bool[m]`` per-member badness of stacked members, or ``None``
        when there is nothing to check."""
        flags = self.flags(params, *arrays)
        return None if flags is None else flags.cpu().numpy()

    def record(self, round_index: int, action: str, **extra) -> None:
        """Log, emit a ``guard_nonfinite`` telemetry event and keep a
        record of what the policy did about a detection."""
        logger.warning(
            "[%s] non-finite round output at round %d -> %s",
            self.family, round_index, action,
        )
        if self.telem is not None:
            self.telem.emit(
                "guard_nonfinite",
                round=round_index,
                policy=self.policy,
                action=action,
                **extra,
            )
        self.events.append({"round": int(round_index), "policy": self.policy,
                            "action": action, **extra})

    def raise_error(self, round_index: int, what: str = "round outputs",
                    unit: str = "round"):
        """Record and raise :class:`NonFiniteError`; ``unit`` names what
        ``round_index`` counts (the member-indexed families say
        "member")."""
        self.record(round_index, "raise")
        raise NonFiniteError(
            f"non-finite {what} at {unit} {round_index} in "
            f"{self.family or 'fit'} (on_nonfinite='raise')",
            family=self.family,
            round_index=round_index,
        )
