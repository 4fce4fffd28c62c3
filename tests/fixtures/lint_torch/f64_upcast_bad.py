"""Positive fixture: float64 on the device path."""

import torch


def widen(x):
    a = x.double()  # flagged
    b = x.to(torch.float64)  # flagged
    c = torch.zeros(3, dtype=torch.double, device=x.device)  # flagged
    return a, b, c


def everything_wide():
    torch.set_default_dtype(torch.float64)  # flagged
