"""K1's and K2's share of their roofline, in %: the least time of every
attention call of the traced window (its bytes once at 3.35 TB/s or its
operations at 989 TFLOP/s, whichever is larger; forward, and backward in
training) over the device time of the kernels whose names match
``PATTERNS``."""

from harness.yardstick import attention_least_seconds

PATTERNS = ("attention_fwd", "attention_bwd")


def read(t):
    spent = t.trace.kernel_seconds(lambda name: any(p in name for p in PATTERNS))
    least = attention_least_seconds(t.sites, t.train)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
