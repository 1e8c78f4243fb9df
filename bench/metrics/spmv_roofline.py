"""The kernels' share of their roofline, in percent: the least time the card
needs for the bytes the calls need (``harness/yardstick.py``, counted by the
configuration's precision and independent of the served format) at
3.35 TB/s, over the kernels' device time in the profiled stretch. SpMV is
bound by bytes: its operations over 67 TFLOP/s take far less."""

from bench.harness.yardstick import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def read(run):
    p = run.profile
    if p is None or p.kernel_s <= 0:
        return None
    nbytes, flops = run.work
    least = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * p.steps
    return least / p.kernel_s * 100
