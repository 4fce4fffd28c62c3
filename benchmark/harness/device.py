"""The card a run uses: the check that it is there, and the result's
``device`` entry."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoDevice(RuntimeError):
    """The cell asks for more CUDA devices than the machine has."""


def require(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} CUDA devices; {torch.cuda.device_count()} found")


def power_limit() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` reads them, or ''
    where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        print(f"nvidia-smi: {e}", file=sys.stderr)
        return ""
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else ""


def entry(chips: int, memory_peak_bytes: int) -> dict:
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": int(memory_peak_bytes),
    }
