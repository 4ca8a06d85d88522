"""The whole step's share of the chip's bf16 peak, in %: the model operations
of the window's untraced stretch (2 m n k for every dense and attention
product, forward, and twice that backward in training; no recomputation)
over 989 TFLOP/s times the stretch's wall time."""

from harness.yardstick import PEAK_BF16_FLOPS, model_flops


def read(t):
    if t.stretch.wall_s <= 0 or not t.stretch_sites:
        return None
    return 100.0 * model_flops(t.stretch_sites, t.train) / (PEAK_BF16_FLOPS * t.stretch.wall_s)
