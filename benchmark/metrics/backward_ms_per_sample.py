"""Stream time of the program's ``step.backward`` spans (``backward()`` or
``autograd.grad``, each microbatch) in the device-only traced window, ms a
sample: the CUDA events' interval, which counts the device's waits for the
host's launches inside the phase besides its kernels."""

from harness.spans import ms_per_sample


def read(t):
    return ms_per_sample(t, "step.backward", device=True)
