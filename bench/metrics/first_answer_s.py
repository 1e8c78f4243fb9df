"""From the dense input to the first answer on the device: fingerprint,
features, plan, conversion into the served format, the first call,
synchronised (``serve_optimize``, or the engine's ``register`` and
``plan_all``), host clock, in set-up."""


def read(run):
    return run.setup["first_answer_s"]
