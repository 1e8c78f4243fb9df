"""Distribution substrate: logical-axis sharding rules + partition hints.

``sharding.py`` maps the logical axis vocabulary of ``models/param.py``
(vocab/embed/heads/kv/ffn/...) onto mesh axes (FSDP over the data axes, TP
over the model axis) with divisibility and no-reuse guards, and places
tensors on a local mesh (``.to(device)``) or a ``DeviceMesh`` (DTensor).
``partition.py`` provides the ambient-context ``hint`` that model code
sprinkles on activations; outside a ``sharding_context``, and on plain
tensors, it is an identity, so the same model code runs unmodified on one
device.
"""

from repro_torch.dist.partition import hint, sharding_context
from repro_torch.dist.sharding import (
    RULE_SETS,
    abstract_mesh,
    batch_sharding,
    build_sharding,
    spec_for,
)

__all__ = [
    "RULE_SETS",
    "abstract_mesh",
    "batch_sharding",
    "build_sharding",
    "hint",
    "sharding_context",
    "spec_for",
]
