"""Plain-torch SpMV per format — the numerical oracles for the CUDA kernels.

Every function computes ``y = A @ x`` for its format with float32
accumulation and matches the dense product to float tolerance. These are
also the implementations ``measure_formats`` times per format. They run on
whatever device the container's tensors live on.
"""

from __future__ import annotations

import torch

from repro_torch.sparse.formats import BELL, CSR, ELL, SELL, SparseFormat


def _as_x(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def spmv_csr(mat: CSR, x) -> torch.Tensor:
    """CSR SpMV via flat gather + ``index_add_`` segmented sum."""
    x = _as_x(x, mat.data)
    prods = mat.data * x[mat.indices.long()]
    y = torch.zeros(mat.shape[0], dtype=x.dtype, device=x.device)
    return y.index_add_(0, mat.row_ids.long(), prods)


def spmv_ell(mat: ELL, x) -> torch.Tensor:
    x = _as_x(x, mat.data)
    return torch.sum(mat.data * x[mat.cols.long()], dim=1)


def spmv_bell(mat: BELL, x) -> torch.Tensor:
    x = _as_x(x, mat.data)
    bc, n_rows = mat.bc, mat.shape[0]
    n_cols_pad = ((x.shape[0] + bc - 1) // bc) * bc
    xp = torch.zeros(n_cols_pad, dtype=x.dtype, device=x.device)
    xp[: x.shape[0]] = x
    xseg = xp.reshape(-1, bc)[mat.block_cols.long()]  # (nbr, maxb, bc)
    y = torch.einsum("ijrc,ijc->ir", mat.data, xseg)
    return y.reshape(-1)[:n_rows]


def spmv_sell(mat: SELL, x) -> torch.Tensor:
    x = _as_x(x, mat.data)
    n_rows = mat.shape[0]
    prods = mat.data * x[mat.cols.long()]
    # padding slots carry row_id == n_rows -> dropped by the extra segment
    y = torch.zeros(n_rows + 1, dtype=x.dtype, device=x.device)
    return y.index_add_(0, mat.row_ids.long(), prods)[:n_rows]


_DISPATCH = {CSR: spmv_csr, ELL: spmv_ell, BELL: spmv_bell, SELL: spmv_sell}


def spmv(mat: SparseFormat, x) -> torch.Tensor:
    """Format-dispatching SpMV.

    Routed through the registry so an overwritten or plugin spec's
    ``reference`` is honored; the static table only serves containers the
    registry does not know (e.g. a seed format that was unregistered)."""
    from repro_torch.sparse.registry import spec_for

    try:
        spec = spec_for(mat)
    except TypeError:
        fn = _DISPATCH.get(type(mat))
        if fn is None:
            raise
        return fn(mat, x)
    return spec.reference(mat, x)


def spmm_ell(mat: ELL, X) -> torch.Tensor:
    """ELL SpMM (multi-vector SpMV, ``X: (n_cols, k)``): gather the rows of
    X per stored slot, contract the width. Returns ``(R, k)``, padded rows
    included, as the reference's oracle does."""
    X = _as_x(X, mat.data)
    Xg = X[mat.cols.long()]  # (n_rows, width, k)
    return torch.einsum("rw,rwk->rk", mat.data, Xg)
