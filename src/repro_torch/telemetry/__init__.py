"""Telemetry + adaptive reoptimization: the predict→measure→relearn loop.

Auto-SpMV's premise is that the classifier is only as good as its dataset of
measured outcomes (§5.4, §6.1) — yet a cached plan, once wrong, would be
served forever. ``adaptive`` is the part of that loop that exists in the
port so far: a UCB bandit layered over the classifier's prior, with a
bounded exploration budget and a sustained-drift detector that evicts stale
``TuningCache`` entries, and the bandit cell keys for row blocks
(``block_arm_bucket``) and solver density phases (``phase_arm_bucket``).
The iterative solvers' SpMV↔SpMSpV policy (``repro_torch.solvers.adaptive``)
runs on it.

Not in the port yet (ROADMAP.md, queue A item 4): the ``recorder``
(per-request measurement records with restart-surviving persistence) and the
``feedback`` loop (telemetry exported as tuning records, incremental refit).
Their names are not exported here; importing them raises ``ImportError``.
"""

from repro_torch.telemetry.adaptive import (
    AdaptiveConfig,
    AdaptiveFormatSelector,
    ArmState,
    CellState,
    block_arm_bucket,
    phase_arm_bucket,
)

__all__ = [
    "AdaptiveConfig",
    "AdaptiveFormatSelector",
    "ArmState",
    "CellState",
    "block_arm_bucket",
    "phase_arm_bucket",
]
