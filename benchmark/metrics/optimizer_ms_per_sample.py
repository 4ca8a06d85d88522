"""Stream time of the program's ``step.optimizer`` spans (the gradients'
global norm and the update) in the device-only traced window, ms a sample:
the CUDA events' interval, which counts the device's waits for the host's
``_foreach`` launches besides its kernels."""

from harness.spans import ms_per_sample


def read(t):
    return ms_per_sample(t, "step.optimizer", device=True)
