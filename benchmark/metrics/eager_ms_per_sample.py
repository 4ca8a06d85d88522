"""Device time of the kernels that are neither the port's (K1, K2, K4) nor
GEMMs -- elementwise, copies and casts, reductions, the optimizer, indexing
-- in the traced window, ms a sample."""

from harness.yardstick import is_eager, optional_ratio


def read(t):
    if not t.trace.kernels:
        return None
    return optional_ratio(t.trace.kernel_seconds(is_eager) * 1e3, t.window.samples)
