"""The share of the traced window, in %, in which no kernel, copy or fill
ran on the device (one minus the union of their intervals over the
window)."""


def read(t):
    if t.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)
