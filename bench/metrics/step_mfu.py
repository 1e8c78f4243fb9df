"""The whole decode step's share of the card's float32 peak, in percent: the
operations the delivered steps need (two per nonzero per vector) over the
window's seconds and 67 TFLOP/s. It bounds what any change to the kernels
can claim, whichever kernels serve the step."""

from bench.harness.yardstick import FP32_FLOPS_PER_S


def read(run):
    w = run.window
    if w.seconds <= 0 or not w.steps:
        return None
    return run.work[1] * w.steps / w.seconds / FP32_FLOPS_PER_S * 100
