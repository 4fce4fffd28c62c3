"""``route_packed_roofline``: the level routes' least time over the
device time of the ``route_packed`` kernels in the traced fit, in
percent."""

from benchmark.harness.layers import kernel_roofline

KERNELS = ("route_packed",)


def read(ctx):
    return kernel_roofline(ctx, "route_packed", KERNELS)
