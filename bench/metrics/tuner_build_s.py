"""``core/session.build_tuner`` as the configuration calls it (dataset,
predictor, the §5.3 overhead predictor), host clock, in set-up."""


def read(run):
    return run.setup["tuner_build_s"]
