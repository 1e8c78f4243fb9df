"""Plain-torch oracles for the CUDA kernels.

The canonical per-format implementations live in ``repro_torch.sparse.spmv``;
this module re-exports them under the kernels/ contract (every kernel has a
``ref`` counterpart checked by ``assert_allclose`` in tests) and adds the
dense ground truth.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.sparse.spmv import (  # noqa: F401  (re-exported oracles)
    spmv,
    spmv_bell,
    spmv_csr,
    spmv_ell,
    spmv_sell,
)


def spmv_dense(dense: np.ndarray, x, *, device=None) -> torch.Tensor:
    """Ground truth: dense matvec (float32, full precision) on ``device``."""
    device = resolve_device(device)
    a = torch.as_tensor(np.asarray(dense), dtype=torch.float32, device=device)
    return a @ torch.as_tensor(x, dtype=torch.float32, device=device)
