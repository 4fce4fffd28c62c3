"""``level_hist_roofline``: the level histograms' least time over the
device time of the ``level_hist`` kernels (``csrc/hist.cu``) in the
traced fit, in percent."""

from benchmark.harness.layers import kernel_roofline

KERNELS = ("level_hist",)


def read(ctx):
    return kernel_roofline(ctx, "level_hist", KERNELS)
