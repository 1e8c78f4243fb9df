"""Set-up: process start to the first timed call (imports, inputs, the
tuner's build, the first plan and answer, the warm-up pass)."""


def read(run):
    return run.setup["setup_s"]
