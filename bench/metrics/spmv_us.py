"""The window's seconds over the matrix-vector products it delivered, in
microseconds: the price of one served product of a resident matrix."""


def read(run):
    w = run.window
    return w.seconds / w.products * 1e6 if w.products else None
