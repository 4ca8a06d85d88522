"""Device time of host-to-device copies in the traced window, ms a sample
(the pageable copy of each batch; nothing where the inputs live on the
device)."""

from harness.yardstick import optional_ratio


def read(t):
    if t.trace.h2d_s <= 0:
        return None
    return optional_ratio(t.trace.h2d_s * 1e3, t.window.samples)
