"""The board's energy over the window (its NVML counter read at both ends)
over the products delivered, in microjoules."""


def read(run):
    w = run.window
    return w.energy_j / w.products * 1e6 if w.energy_j is not None and w.products else None
