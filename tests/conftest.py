"""Shared test fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the single real CPU device; only launch/dryrun.py forces 512
placeholder devices (and only when executed as a script).

``hypothesis`` is an optional test dependency (the ``[test]`` extra). When
absent, a stub is installed so the suite still collects; property-based
tests are skipped instead of killing collection with an ImportError."""

import numpy as np
import pytest

try:
    from hypothesis import settings, HealthCheck
except ModuleNotFoundError:
    import _hypothesis_fallback

    _hyp = _hypothesis_fallback.install()
    settings, HealthCheck = _hyp.settings, _hyp.HealthCheck

# single-core container: keep hypothesis example counts modest by default
settings.register_profile(
    "repro",
    max_examples=20,
    deadline=None,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)
settings.load_profile("repro")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none (run: -m card)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
