"""The board's mean power over the window: its energy counter's rise over
the window's seconds."""


def read(run):
    w = run.window
    return w.energy_j / w.seconds if w.energy_j is not None and w.seconds > 0 else None
