"""Ambient partition hints: ``hint(x, logical_axes)`` inside model code.

Model code annotates activations with logical axes only; the concrete mesh
and rule set come from the innermost ``sharding_context``. With no active
context (unit tests, single-device runs), and for any tensor that is not a
DTensor (a ``LocalMesh`` run keeps plain tensors), ``hint`` returns ``x``
itself, so the same model source serves one card and the fleet. On a
DTensor inside a context it is ``x.redistribute`` to the placements the
rules give: the counterpart of JAX's ``with_sharding_constraint``.

Where GSPMD partitions an op that DTensor has no rule for, the model runs
it through ``local_shards`` (PyTorch's ``local_map`` over the placements
the rules give) and the loss through ``token_nll``. The sites, and what
DTensor lacks at each:

* ``layers.attention``, flash attention: batch and heads merge into one
  bmm dim that DTensor cannot shard over two mesh dims;
* ``layers._project`` / ``_project_out``, the q/k/v/o projections: DTensor
  shards the fused heads x dh dim and cannot unflatten it;
* ``layers.attention``, the decode cache write: no rule for the indexed
  write at the cache's placements;
* ``moe.moe_ffn``, routing and the expert FFN: scatters, sorts and
  ``searchsorted``; the FFN stays sharded over ``ffn`` as tensor
  parallelism, its output a partial sum;
* ``model._embed``, the token lookup: no rule for the backward's
  accumulating ``index_put`` into a sharded table (torch 2.11);
  ``token_lookup`` keeps the table sharded over the vocabulary;
* ``trainer.make_loss_fn``, the per-token NLL: the gather's backward
  builds the logits' global-shaped gradient on every rank; ``token_nll``
  keeps the logits sharded over the vocabulary instead.

On plain tensors each is the same call as without a mesh.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import placements_for, spec_for

_CONTEXT: list[tuple[object, Mapping | None]] = []


@contextmanager
def sharding_context(mesh, rules: Mapping | None = None):
    """Establish the ambient (mesh, rules) pair consumed by ``hint``."""
    _CONTEXT.append((mesh, rules))
    try:
        yield
    finally:
        _CONTEXT.pop()


def current_context() -> tuple[object, Mapping | None] | None:
    return _CONTEXT[-1] if _CONTEXT else None


def _dtensor_context(tensors) -> tuple[object, Mapping | None] | None:
    """The innermost context where a DTensor is among ``tensors``, else
    ``None`` (DTensor is imported only then)."""
    ctx = current_context()
    if ctx is None:
        return None
    from torch.distributed.tensor import DTensor

    return ctx if any(isinstance(t, DTensor) for t in tensors) else None


def hint(x: torch.Tensor, axes: tuple[str | None, ...]) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axes; identity with no context
    and on a plain tensor."""
    ctx = _dtensor_context([x])
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = spec_for(mesh, tuple(x.shape), axes, rules)
    return x.redistribute(mesh, placements_for(mesh, spec, x.ndim))


def local_shards(fn: Callable, *args: tuple[torch.Tensor, tuple], out: tuple | None = None,
                 n_out: int = 1):
    """``fn(*tensors)`` run on each rank's shards, for an op that is
    parallel over the dims its arguments' logical axes shard. ``args`` are
    ``(tensor, logical axes)`` pairs; ``out`` is ``(shape, logical axes)``
    of the result (default: the first argument's); ``n_out`` > 1 when
    ``fn`` returns a tuple of that many tensors, placed alike.

    Inside a context, with a DTensor among the arguments, each argument is
    brought to the placements its axes give (a plain tensor, which every
    rank holds whole, joins replicated) and ``fn`` runs on the local
    tensors. On each mesh dim the result is sharded as ``out`` says; where
    ``out`` is not sharded but an argument is, ``fn`` contracted the split
    dim and the result is a partial sum. An argument's gradient is sharded
    as the argument is, and a partial sum where the argument is replicated
    but the work is split. Otherwise it is ``fn(*tensors)``."""
    tensors = [t for t, _ in args]
    ctx = _dtensor_context(tensors)
    if ctx is None:
        return fn(*tensors)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, rules = ctx

    def placed(shape, axes):
        return tuple(placements_for(mesh, spec_for(mesh, tuple(shape), axes, rules), len(shape)))

    ins = [placed(t.shape, axes) for t, axes in args]
    shape, axes = out if out is not None else (args[0][0].shape, args[0][1])
    outs = [p if isinstance(p, Shard) else
            Partial() if any(isinstance(a[i], Shard) for a in ins) else Replicate()
            for i, p in enumerate(placed(shape, axes))]
    grads = [tuple(p if isinstance(p, Shard) or isinstance(o, Replicate) else Partial()
                   for p, o in zip(pl, outs)) for pl in ins]
    dts = [_as_dtensor(t, mesh) for t in tensors]
    return local_map(fn, out_placements=outs if n_out == 1 else (outs,) * n_out,
                     in_placements=tuple(ins), in_grad_placements=tuple(grads),
                     device_mesh=mesh, redistribute_inputs=True)(*dts)


def _vocab_offset(mesh, vocab: list[int], local_rows: int) -> int:
    """The first vocabulary row of this rank's slice over the mesh dims
    ``vocab`` (the first major)."""
    coord, block = mesh.get_coordinate(), 0
    for i in vocab:
        block = block * mesh.size(i) + coord[i]
    return block * local_rows


def _as_dtensor(t: torch.Tensor, mesh):
    """A DTensor as it is; a plain tensor, which every rank holds whole, as
    a replicated one."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def token_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. On a DTensor table the rows stay where they lie
    (Megatron's vocab-parallel embedding): each rank looks up the tokens
    its vocabulary slice holds, zeros for the rest, and the result is a
    partial sum over the mesh dims that shard the vocabulary."""
    if _dtensor_context([table, tokens]) is None:
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = current_context()[0]
    table, tokens = _as_dtensor(table, mesh), _as_dtensor(tokens, mesh)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    rows = [Replicate() if i in vocab else p for i, p in enumerate(tokens.placements)]
    slices = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    grads = [Shard(0) if i in vocab else Partial() if p.is_shard() else p
             for i, p in enumerate(rows)]
    n_local = table.shape[0] // max(1, math.prod(mesh.size(i) for i in vocab))
    offset = _vocab_offset(mesh, vocab, n_local)

    def lookup(tb, tk):
        idx = tk.long() - offset
        hit = (idx >= 0) & (idx < tb.shape[0])
        return torch.where(hit[..., None], tb[idx.clamp(0, tb.shape[0] - 1)], 0)

    out = [Partial() if i in vocab else p for i, p in enumerate(rows)]
    return local_map(lookup, out_placements=out, in_placements=(slices, rows),
                     in_grad_placements=(grads, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-log softmax(logits)[labels]`` per token. On a DTensor the logits
    stay where they lie (Megatron's vocab-parallel cross entropy): each
    rank takes its vocabulary slice's max, its sum of exponentials and the
    label's logit where the slice holds it, and the mesh dims that shard
    the vocabulary reduce the three (a max, then two sums)."""
    if _dtensor_context([logits]) is None:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, v = logits.device_mesh, logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(v)]
    rows = tuple(Replicate() if i in vocab else p for i, p in enumerate(logits.placements))
    offset = _vocab_offset(mesh, vocab, logits.to_local().shape[-1])

    def partial(op):  # a list: local_map reads a tuple as one entry per output
        return [Partial(op) if i in vocab else p for i, p in enumerate(rows)]

    def local_max(lg):
        return lg.detach().amax(-1)

    def local_terms(lg, lb, mx):
        idx = lb.long() - offset
        hit = (idx >= 0) & (idx < lg.shape[-1])
        picked = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.exp(lg - mx[..., None]).sum(-1), torch.where(hit, picked, 0.0)

    labels = _as_dtensor(labels, mesh).redistribute(mesh, rows)
    mx = local_map(local_max, out_placements=partial("max"), device_mesh=mesh)(logits)
    mx = mx.redistribute(mesh, rows)
    total, picked = local_map(local_terms, out_placements=(partial("sum"), partial("sum")),
                              device_mesh=mesh)(logits, labels, mx)
    return (torch.log(total.redistribute(mesh, rows)) + mx
            - picked.redistribute(mesh, rows))
