"""Logical-axis -> mesh-axis sharding rules (FSDP + TP).

The logical vocabulary is documented in ``models/param.py``. Placement:

* data-like logical axes (``batch``, ``embed``) shard over every non-model
  mesh axis, in mesh order — ``("data",)`` on a 2D mesh, ``("pod", "data")``
  on a multi-pod mesh (ZeRO-3-style weight sharding over the full data
  extent);
* tensor-parallel logical axes (``vocab``, ``heads``, ``kv``, ``ffn``,
  ``rnn``) shard over the ``model`` axis;
* everything else (``experts``, ``layers``, ``seq``, ``None``) replicates.

Two guards make the mapping total: a dimension that does not divide the
mesh extent replicates instead (kv=8 on a 16-way model axis), and a mesh
axis is never assigned twice in one spec (the second ``embed`` of a square
weight replicates).

PyTorch has two kinds of mesh where JAX has one, and ``spec_for`` reads
only axis names and sizes, so it takes both and an abstract one:

* ``LocalMesh`` — one process drives every device it names (``spmv_mesh``,
  ``launch.mesh.make_host_mesh``); a tensor is placed with ``.to(device)``;
* ``torch.distributed.device_mesh.DeviceMesh`` — one rank per device (the
  production 16 x 16 and 2 x 16 x 16 meshes); a tensor is placed as a
  DTensor with the placements the spec gives (``placements_for``);
* ``AbstractMesh`` (``abstract_mesh``) — sizes and names only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

import torch

MODEL_AXIS = "model"

# logical axis -> placement class: "data" (all non-model axes), "model", or
# None (replicated). A rule set is a plain dict so variants can override.
TRAIN_RULES: dict[str, str | None] = {
    "batch": "data",
    "embed": "data",
    "vocab": MODEL_AXIS,
    "heads": MODEL_AXIS,
    "kv": MODEL_AXIS,
    "ffn": MODEL_AXIS,
    "rnn": MODEL_AXIS,
    "experts": None,
    "layers": None,
    "seq": None,
}

# Inference keeps weights TP-sharded but replicates embed (no ZeRO gather on
# the decode path; the per-chip weight residency is paid once).
INFER_RULES: dict[str, str | None] = dict(TRAIN_RULES, embed=None)

# Partitioned SpMV (repro_torch.partition.executor): the stacked per-block
# sparse storage shards its leading "blocks" axis over the data axes (one
# row block per device); the dense X vector replicates, because every block
# may gather arbitrary columns; per-block Y keeps the "blocks" axis sharded
# so output shards stay local to the device that produced them.
SPMV_RULES: dict[str, str | None] = {
    "blocks": "data",
    "rows": None,
    "cols": None,
}

RULE_SETS: dict[str, dict[str, str | None]] = {
    "train": TRAIN_RULES,
    "infer": INFER_RULES,
    "spmv": SPMV_RULES,
}


class PartitionSpec(tuple):
    """One entry per leading tensor dim: ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, first name
    major). A tuple, so it compares entry for entry with JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes only (what ``spec_for`` reads)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class LocalMesh:
    """Devices one process drives, arranged on named axes."""

    def __init__(self, devices: Iterable, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        self.devices = [torch.device(d) for d in devices]
        self.sizes = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if math.prod(self.sizes) != len(self.devices) or len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.devices)} devices do not fill mesh {self.shape}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def __repr__(self) -> str:
        return f"LocalMesh({self.shape}, {[str(d) for d in self.devices]})"


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each shard of a tensor lives."""

    mesh: Any
    spec: PartitionSpec


def abstract_mesh(axis_sizes: Iterable[int], axis_names: Iterable[str]) -> AbstractMesh:
    return AbstractMesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def spmv_mesh(n_blocks: int | None = None, device: str | None = None) -> LocalMesh:
    """1-D ``("data",)`` mesh for the partitioned executor, one row block
    per device: the first ``min(n_blocks, torch.cuda.device_count())`` CUDA
    devices (``device=None`` or ``"cuda"``; raises where there is none), or
    ``n_blocks`` entries of the CPU with ``device="cpu"`` — the analogue of
    ``--xla_force_host_platform_device_count``. It never picks the CPU by
    itself."""
    from repro_torch.kernels.common import resolve_device

    kind = resolve_device(device).type
    if kind == "cpu":
        n = max(1, n_blocks or 1)
        devices = [torch.device("cpu")] * n
    else:
        avail = torch.cuda.device_count()
        n = avail if n_blocks is None else max(1, min(n_blocks, avail))
        devices = [torch.device(kind, i) for i in range(n)]
    return LocalMesh(devices, (n,), ("data",))


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order, for any of the three kinds."""
    if getattr(mesh, "mesh_dim_names", None) is not None:  # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(n for n in axis_names(mesh) if n != MODEL_AXIS)


def spec_for(
    mesh,
    shape: tuple[int, ...],
    axes: tuple[str | None, ...],
    rules: Mapping[str, str | None] | None = None,
) -> PartitionSpec:
    """PartitionSpec for one array given its logical axes.

    Indivisible dims and already-used mesh axes fall back to replication;
    trailing replicated entries are stripped so specs compare canonically.
    """
    rules = TRAIN_RULES if rules is None else rules
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    entries: list[Any] = []
    for dim, logical in zip(shape, axes):
        placement = rules.get(logical) if logical is not None else None
        if placement is None:
            entries.append(None)
            continue
        names = _data_axes(mesh) if placement == "data" else (placement,)
        names = tuple(n for n in names if n in sizes and n not in used)
        extent = math.prod(sizes[n] for n in names) if names else 0
        if not names or dim % extent:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names if len(names) > 1 else names[0])
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(mesh, spec: PartitionSpec, ndim: int) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: one per mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh axis, else
    ``Replicate()``. A dim sharded over several axes (``("pod", "data")``)
    gets ``Shard(d)`` on each of them; DTensor splits over mesh dims in
    mesh order, so the first axis is the major one, as in JAX."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    placements: list = [Replicate() for _ in names]
    for d, entry in enumerate(tuple(spec)[:ndim]):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            placements[names.index(name)] = Shard(d)
    return placements


def place(x: torch.Tensor, sharding) -> torch.Tensor:
    """Put ``x`` where ``sharding`` says: a ``torch.device`` or a
    ``NamedSharding`` over a ``LocalMesh`` (one device: ``.to`` it) or over
    a ``DeviceMesh`` (``distribute_tensor`` with ``placements_for``)."""
    if isinstance(sharding, (str, torch.device)):
        return x.to(sharding)
    mesh = sharding.mesh
    if isinstance(mesh, LocalMesh):
        if len(set(mesh.devices)) != 1:
            raise ValueError(f"a local mesh of several devices places no single tensor: {mesh}")
        return x.to(mesh.devices[0])
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, placements_for(mesh, sharding.spec, x.ndim))


def build_sharding(mesh, spec_tree: Any, rules: Mapping | None = None) -> Any:
    """NamedSharding tree for a ParamSpec tree (same structure)."""
    from repro_torch.models.param import tree_map

    return tree_map(
        lambda s: NamedSharding(mesh, spec_for(mesh, s.shape, s.axes, rules)), spec_tree
    )


def batch_sharding(mesh, batch: Any, rules: Mapping | None = None) -> Any:
    """Shard the leading (batch) axis of every leaf over the data axes."""
    from repro_torch.models.param import tree_map

    def one(leaf):
        shape = tuple(leaf.shape)
        axes = ("batch",) + (None,) * (len(shape) - 1)
        return NamedSharding(mesh, spec_for(mesh, shape, axes, rules))

    return tree_map(one, batch)
