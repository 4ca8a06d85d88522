"""Host time of the program's ``eval.h2d`` spans (each batch's pageable
copies from numpy to the device, which the host waits for) in the
device-only traced window, ms a question."""

from harness.spans import ms_per_sample


def read(t):
    return ms_per_sample(t, "eval.h2d", device=False)
