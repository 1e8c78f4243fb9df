"""Host time inside the program's call, per product, without a wait for the
device: ``engine.matmul`` or ``PreparedSpmv.__call__`` down to the kernel's
launch, with the copy of ``x`` to the device where a request hands a host
``x``."""


def read(run):
    w = run.window
    if w.dispatch_s is None or not w.products:
        return None
    return w.dispatch_s / w.products * 1e6
