"""Host time of the program's ``eval.score`` spans (each batch's loss,
score and submission records on the CPU) in the device-only traced
window, ms a question."""

from harness.spans import ms_per_sample


def read(t):
    return ms_per_sample(t, "eval.score", device=False)
