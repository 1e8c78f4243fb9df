"""Telemetry's adaptive selector, port vs reference: the cell keys, the
config, and ``AdaptiveFormatSelector`` fed the same scripted sequence of
``choose``/``update``/``review``/``promote``/``disable``/``absorb``/
``reconcile``/``warm_start`` calls in both packages (the selector has no
randomness, so every decision and summary must be identical). Also the
SpMV↔SpMSpV policy built on it, and the telemetry package's exports."""

import dataclasses

import numpy as np
import pytest

from repro.solvers.adaptive import AdaptiveSpmvPolicy as RefPolicy
from repro.telemetry import adaptive as ref_adaptive
from repro_torch.solvers.adaptive import SPMSPV, SPMV, AdaptiveSpmvPolicy
from repro_torch.telemetry import adaptive

PACKAGES = (ref_adaptive, adaptive)
FORMATS = ("csr", "ell", "bell", "sell")


def test_cell_keys_and_config_equal_reference():
    for b, i, n in (("b1", 0, 4), ("x_y", 7, 8), ("", 2, 6)):
        assert adaptive.block_arm_bucket(b, i, n) == ref_adaptive.block_arm_bucket(b, i, n)
        assert adaptive.phase_arm_bucket(b, i, n) == ref_adaptive.phase_arm_bucket(b, i, n)
    assert dataclasses.asdict(adaptive.AdaptiveConfig()) == dataclasses.asdict(
        ref_adaptive.AdaptiveConfig())


def _script(mod, seed: int, config_kw: dict):
    """Drive one selector through a fixed, seeded call sequence; return
    everything it decided, step by step, and its final state."""
    rng = np.random.default_rng(seed)
    sel = mod.AdaptiveFormatSelector(mod.AdaptiveConfig(**config_kw))
    # per (cell, format): a true mean the measurements scatter around
    truth = {(b, f): float(rng.uniform(0.5, 2.0)) for b in ("b0", "b1", "b2") for f in FORMATS}
    log = []
    for step in range(120):
        bucket = ("b0", "b1", "b2")[step % 3]
        incumbent = "csr" if step < 60 or bucket != "b1" else "ell"  # a re-plan mid-way
        prior = None if bucket == "b2" else 1.0
        fmt, explore = sel.choose(bucket, "latency", incumbent, FORMATS, prior_value=prior)
        measured = truth[(bucket, fmt)] * float(rng.uniform(0.9, 1.1))
        sel.update(bucket, "latency", fmt, measured, predicted_s=prior)
        challenger = sel.review(bucket, "latency")
        if challenger is not None:
            sel.promote(bucket, "latency", challenger)
        log.append((fmt, explore, challenger, sel.incumbent(bucket, "latency")))
        if step == 40:
            sel.disable("b0", "latency", "sell")
        if step == 50:
            sel.disable("b2", "latency", sel.incumbent("b2", "latency"))
        if step == 70:
            sel.absorb("b1", "latency", "bell", pulls=9, value=0.1)
            sel.absorb("peer", "latency", "sell", pulls=3, value=0.4)
            log.append(("reconcile", sel.reconcile("b1", "latency"), sel.reconcile("peer", "latency")))
    cells = {
        key: (c.incumbent, c.total_pulls, c.exploration_pulls, c.drift_strikes,
              c.model_drift_strikes, c.promoted, c.invalidations,
              {f: (a.pulls, a.prior_pulls, a.prior_value, a.disabled, a.absorbed_pulls,
                   a.measured_mean()) for f, a in c.arms.items()})
        for key, c in sel.cells().items()
    }
    return log, sel.summary(), cells


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config_kw", [{}, dict(exploration_fraction=0.5, drift_window=2),
                                       dict(prior_weight=1, min_challenger_pulls=1)])
def test_selector_decisions_equal_reference(seed, config_kw):
    ref_log, ref_summary, ref_cells = _script(ref_adaptive, seed, config_kw)
    log, summary, cells = _script(adaptive, seed, config_kw)
    assert log == ref_log
    assert summary == ref_summary
    assert cells == ref_cells


def test_zero_prior_weight_with_a_prior_divides_by_zero_in_both():
    """A trap kept as the reference has it: ``prior_weight=0`` leaves an arm
    with a prior value but no effective pulls, and the UCB width divides by
    ``n_eff == 0`` (ROADMAP queue C)."""
    for mod in PACKAGES:
        sel = mod.AdaptiveFormatSelector(mod.AdaptiveConfig(prior_weight=0))
        with pytest.raises(ZeroDivisionError):
            sel.choose("b", "latency", "csr", FORMATS, prior_value=1.0)


class _Agg:
    def __init__(self, mean):
        self.stats = type("S", (), {"mean": mean})()


class _FakeRecorder:
    """Duck-typed stand-in for a telemetry recorder: warm_start reads only arms()."""

    def arms(self):
        return {("b", "latency", "csr"): _Agg(0.3), ("b", "latency", "ell"): _Agg(0.2),
                ("c", "energy", "sell"): _Agg(1.0)}


def test_warm_start_is_duck_typed_and_equal():
    results = []
    for mod in PACKAGES:
        sel = mod.AdaptiveFormatSelector()
        sel.update("b", "latency", "csr", 0.5)  # an arm with real pulls is not re-seeded
        seeded = sel.warm_start(_FakeRecorder())
        results.append((seeded, sel.summary(), sel.incumbent("c", "energy"),
                        sel.choose("b", "latency", "csr", FORMATS)))
    assert results[0] == results[1]
    assert results[1][0] == 2


def test_disable_falls_back_to_the_ports_default_format():
    sel = adaptive.AdaptiveFormatSelector()
    sel.choose("b", "latency", "ell", FORMATS)
    sel.disable("b", "latency", "ell")
    from repro_torch.sparse.registry import default_format

    assert sel.incumbent("b", "latency") == default_format() == "csr"
    sel.disable("missing", "latency", "csr")  # unknown cell: a no-op
    assert sel.incumbent("missing", "latency") is None


def test_telemetry_package_exports_only_the_ported_names():
    """Every name the reference's telemetry package exports, from the port's
    own modules (recorder, feedback and adaptive are all ported)."""
    import repro.telemetry as ref_tel
    import repro_torch.telemetry as tel

    assert sorted(tel.__all__) == sorted(ref_tel.__all__)
    for name in ("TelemetryRecorder", "FeedbackLoop", "MeasurementRecord"):
        assert getattr(tel, name).__module__.startswith("repro_torch.telemetry.")


# --------------------------------------------------------- the solver policy
def test_policy_bins_prior_and_metric_names_equal_reference():
    ours, ref = AdaptiveSpmvPolicy(), RefPolicy()
    assert (ours.threshold, ours.phase_edges, ours.n_phases) == (
        ref.threshold, ref.phase_edges, ref.n_phases)
    for d in (0.0, 0.019, 0.02, 0.03, 0.0999, 0.1, 0.25, 0.49, 0.5, 0.9, 1.0):
        assert ours.phase_of(d) == ref.phase_of(d)
        assert ours.prior_kind(d) == ref.prior_kind(d)
    assert (SPMV, SPMSPV) == ("spmv", "spmspv")
    from repro_torch.obs.metrics import get_metrics

    for name in ("solver_policy_spmv_total", "solver_policy_spmspv_total",
                 "spmv_bandit_explore_total", "spmv_bandit_exploit_total",
                 "spmv_drift_promotions_total"):
        assert get_metrics().instruments("counter", name), name


def test_policy_with_selector_decides_like_the_reference():
    """The same density sequence and measured times through both packages'
    policy + selector: identical routing, phases and exploration flags."""
    rng = np.random.default_rng(5)
    densities = np.concatenate([np.geomspace(1e-4, 0.9, 30), rng.uniform(0, 1, 30)])
    runs = []
    for Policy, sel_mod in ((RefPolicy, ref_adaptive), (AdaptiveSpmvPolicy, adaptive)):
        pol = Policy(selector=sel_mod.AdaptiveFormatSelector(), bucket="web")
        t = np.random.default_rng(9)
        for d in densities:
            dec = pol.choose(float(d))
            # SpMSpV costs ~ density, SpMV a constant: crossover near 0.3
            pol.update(dec, (3.0 * d if dec.kind == SPMSPV else 1.0) * t.uniform(0.95, 1.05))
        runs.append(([(x.kind, x.density, x.phase, x.exploratory) for x in pol.decisions],
                     pol.selector.summary()))
    assert runs[0] == runs[1]


def test_policy_bandit_learns_crossover():
    """The reference's phase-bandit test, in the port: measured times
    overturn the threshold prior inside one density phase."""
    pol = AdaptiveSpmvPolicy(selector=adaptive.AdaptiveFormatSelector())
    density = 0.05  # below threshold: prior says SpMSpV
    assert pol.prior_kind(density) == SPMSPV
    for _ in range(40):
        decision = pol.choose(density)
        pol.update(decision, 1.0 if decision.kind == SPMSPV else 0.1)
    finals = [pol.choose(density).kind for _ in range(8)]
    assert finals.count(SPMV) > finals.count(SPMSPV), finals
