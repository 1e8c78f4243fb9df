"""Parameter-spec trees: shapes + logical axes, materialised as tensors.

Models are plain functions over nested trees of dicts and tuples whose
leaves are tensors — the same nesting and layouts as the reference
package's pytrees (``head``/``groups``/``tail`` tuples of dicts, group
params stacked on a leading ``n_groups`` axis, ``wq: (d, h, dh)``,
``wo: (h, dh, d)``, ``w_gate: (d, f)``), so a leaf of one maps 1:1 onto a
leaf of the other (``params_from_numpy``).

Logical axis vocabulary (mapped to mesh axes by repro_torch.dist.sharding):
  "vocab"    embedding rows / logits columns        -> model
  "embed"    d_model dim of weight matrices         -> data (FSDP / ZeRO-3)
  "heads"    fused attention-head dim               -> model
  "kv"       kv-head dim                            -> model if divisible
  "ffn"      feed-forward hidden                    -> model
  "experts"  expert dim of MoE weight stacks        -> (none; expert-TP via ffn)
  "rnn"      recurrent state width                  -> model
  "layers"   stacked layer-group dim                -> (none)
  None       replicated
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """The tensor dtype of a config dtype name (``"bfloat16"`` etc.)."""
    return _DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0  # stddev multiplier for normal init
    dtype: str | None = None  # override the config param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of dicts, tuples and lists of
    the same structure (``None`` subtrees stay ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure with ``leaves`` in its leaf order (``tree_leaves``)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stack_specs(tree: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked (group) leading dim to every spec in the tree."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n, *s.shape), axes=(axis_name, *s.axes)), tree
    )


def abstract_params(tree: Any, default_dtype: str) -> Any:
    """Meta-tensor tree (shape and dtype, no storage) — what the dry run
    places on a mesh; PyTorch's ``ShapeDtypeStruct``."""
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype or default_dtype), device="meta"),
        tree,
    )


def axes_tree(tree: Any) -> Any:
    """Logical-axes tree (same structure, tuples at leaves)."""
    return tree_map(lambda s: s.axes, tree)


def init_params(
    tree: Any,
    generator: torch.Generator | None,
    default_dtype: str,
    device: str | torch.device | None = None,
) -> Any:
    """Materialise real parameters on ``device`` (``None`` = the card).

    Normal leaves draw float32 from ``generator`` (which must live on
    ``device``; a tree of zeros/ones leaves needs none) and scale by the
    reference's rule ``std = scale / sqrt(fan_in)`` with
    ``fan_in = shape[-2]`` — for ``wq: (d, h, dh)`` that is ``h``, not ``d``;
    keeping the rule keeps every activation scale and pruned-matrix
    statistic the reference has. The numbers differ from the reference's
    (another generator); tests carry weights across with
    ``params_from_numpy``."""
    device = resolve_device(device)

    def one(spec: ParamSpec):
        dtype = torch_dtype(spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if generator is None:
            raise ValueError("a normal-initialised leaf needs a torch.Generator")
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / max(fan_in, 1) ** 0.5
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return (w * std).to(dtype)

    return tree_map(one, tree)


def params_from_numpy(tree: Any, device: str | torch.device | None = None) -> Any:
    """Carry a parameter (or cache) tree of numpy arrays across as tensors on
    ``device`` (``None`` = the card), same nesting, same layouts, same dtypes
    — the reference's pytree after ``jax.tree.map(np.asarray, params)``
    becomes the port's tree leaf for leaf. bfloat16 arrays (numpy's
    ``ml_dtypes`` type) are carried bit for bit, stacked ``(E, d, f)``
    expert leaves and the float32 router as any other leaf."""
    device = resolve_device(device)
    return tree_map(lambda a: leaf_from_numpy(a, device=device), tree)


def leaf_from_numpy(a, dtype: str | None = None, *, device) -> torch.Tensor:
    """One array as a tensor on ``device``. A bfloat16 array is carried bit
    for bit, whether numpy holds it as ``ml_dtypes.bfloat16`` or as its
    uint16 bits with ``dtype="bfloat16"`` (a checkpoint's form)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def leaf_to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor's host copy and its dtype name; a bfloat16 tensor comes back
    as its uint16 bits (numpy has no bfloat16 of its own). A DTensor is
    gathered whole first."""
    t = t.detach()
    if hasattr(t, "full_tensor"):  # a DTensor
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    a = t.cpu().numpy()
    return a, str(a.dtype)


def params_to_numpy(tree: Any) -> Any:
    """The reverse of ``params_from_numpy``: a tree of tensors as numpy
    arrays, same nesting; bfloat16 leaves as ``ml_dtypes.bfloat16`` (the
    reference's host dtype, imported only when such a leaf occurs)."""

    def one(t):
        a, name = leaf_to_numpy(t)
        if name == "bfloat16":
            import ml_dtypes

            a = a.view(ml_dtypes.bfloat16)
        return a

    return tree_map(one, tree)


def param_count(tree: Any) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        n = 1
        for s in leaf.shape:
            n *= int(s)
        total += n
    return total
