"""Negative fixture: f32 tensors, and host-side float64 accounting."""

import numpy as np
import torch


def host_accounting(values):
    return np.asarray(values, dtype=np.float64).sum()


def narrow(x):
    return x.to(torch.float32), torch.zeros(3, dtype=torch.float32, device=x.device)
