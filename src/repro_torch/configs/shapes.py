"""Assigned workload shapes (arch x shape grid, 4 shapes per LM arch).

``train_*`` is a training step over the stated sequence length and global
batch; ``prefill_*`` a full-sequence serving prefill; ``decode_*`` /
``long_*`` one serving step (one new token against a KV cache or state of
the stated length). ``long_500k`` requires sub-quadratic sequence mixing
and is only run for the SSM/hybrid archs — full-attention archs report the
documented skip. Plain data, carried over from the reference package with
the same names, numbers and skip reasons.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class WorkloadShape:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, WorkloadShape] = {
    "train_4k": WorkloadShape("train_4k", "train", 4_096, 256),
    "prefill_32k": WorkloadShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": WorkloadShape("decode_32k", "decode", 32_768, 128),
    "long_500k": WorkloadShape("long_500k", "decode", 524_288, 1),
}

SHAPE_NAMES = tuple(SHAPES)

# families whose sequence mixing is sub-quadratic end-to-end
_SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason). The only skip rule: long_500k on pure full-attention
    archs (all ten assigned archs are decoder-only, so decode shapes apply
    everywhere else)."""
    if shape_name == "long_500k" and cfg.family not in _SUBQUADRATIC_FAMILIES:
        return False, (
            "long_500k skipped: pure full-attention arch (O(S) KV decode state "
            "at 500k exceeds the shape's intent; see DESIGN.md §5)"
        )
    return True, ""


def cells_for(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPE_NAMES if applicable(cfg, s)[0]]
