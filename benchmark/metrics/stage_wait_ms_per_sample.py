"""Host time of the program's ``data.stage_wait`` spans (a task step waiting
for its staged batch and taking it onto the step's stream) in the
device-only traced window, ms a sample."""

from harness.spans import ms_per_sample


def read(t):
    return ms_per_sample(t, "data.stage_wait", device=False)
