"""Production mesh construction.

FUNCTIONS (not module-level constants), so importing this module never
touches device or process-group state.

* ``make_production_mesh`` — the 16 x 16 (``("data", "model")``) or
  2 x 16 x 16 (``("pod", "data", "model")``) ``DeviceMesh`` over an
  initialised process group of 256 or 512 ranks, one per GPU (``torchrun``
  on a fleet; the dry run's ``FakeStore`` group on one host).
* ``make_host_mesh`` — the degenerate 1 x 1 ``LocalMesh`` on one device,
  where every placement is the identity and tensors stay plain.

The reference also documents XLA flags for TPU fleets (latency-hiding
scheduler, async collective fusion); they have no meaning on CUDA and the
port has no counterpart.
"""

from __future__ import annotations

import math

import torch

from repro_torch.dist.sharding import LocalMesh
from repro_torch.kernels.common import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    import torch.distributed as dist

    ranks = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if ranks < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {ranks}; launch one rank per "
            "GPU with torchrun, or run the dry run (python -m "
            "repro_torch.launch.dryrun), which opens a fake process group of "
            f"{n} ranks"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device: str | torch.device | None = None) -> LocalMesh:
    """Degenerate 1x1 mesh on one local device (``None``: the card)."""
    return LocalMesh([resolve_device(device)], (1, 1), ("data", "model"))
