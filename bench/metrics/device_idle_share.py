"""The share of the profiled stretch in which nothing ran on the card, in
percent: one less the device's busy time over the stretch's host-clock
length."""


def read(run):
    p = run.profile
    if p is None or p.window_s <= 0:
        return None
    return (1 - p.busy_s / p.window_s) * 100
