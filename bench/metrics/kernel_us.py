"""Device time of every kernel the served calls launched in the profiled
stretch (``torch.profiler``), per product."""


def read(run):
    p = run.profile
    if p is None or p.kernel_s <= 0:
        return None
    return p.kernel_s / (p.steps * run.products_per_step) * 1e6
