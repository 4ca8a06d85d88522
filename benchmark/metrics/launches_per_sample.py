"""CUDA kernel launches in the traced window, a sample."""

from harness.yardstick import optional_ratio


def read(t):
    if not t.trace.kernels:
        return None
    return optional_ratio(float(t.trace.kernel_launches), t.window.samples)
