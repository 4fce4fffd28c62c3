"""``leaf_sums_roofline``: the leaf pass's least time (it routes the last
level and sums the leaves) over the device time of the ``leaf_sums``
kernels in the traced fit, in percent."""

from benchmark.harness.layers import kernel_roofline

KERNELS = ("leaf_sums",)


def read(ctx):
    return kernel_roofline(ctx, "leaf_sums", KERNELS)
