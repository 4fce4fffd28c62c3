"""Negative fixture: reads inside a perf_counter fence, a span, or after a
telemetry charge are measured, not hazards."""

import time

import numpy as np
import torch


def timed(model, X):
    t0 = time.perf_counter()
    out = np.asarray(model.predict(X))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall


def charged(model, X, telem):
    telem.blocking_read(model.predict(X))
    # fenced-and-charged above; this copy cannot block
    return model.predict(X).cpu().numpy()


def spanned(model, X, telem):
    with telem.span("readback"):
        return model.predict(X).tolist()


def bounded_join(fut):
    # timeout-bounded joins are outside the rule's scope
    return fut.result(timeout=60)


def plain_tensor(t):
    # not a predict result or a draw: the rule cannot see a device value
    return t.cpu().numpy()
