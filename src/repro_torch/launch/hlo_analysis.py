"""Collective-traffic extraction, from HLO text or from DTensor's own ops.

``parse_collectives`` reads compiled per-device HLO text and sums operand
sizes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute (assignment formula), plus a ring-model estimate of
actual per-device link bytes; the same text gives the same ops as the
reference's parser. The port compiles no HLO: ``CollectiveRecorder`` is a
dispatch mode that records, as the same ``CollectiveOp``s, every
``_c10d_functional`` collective DTensor emits while a step runs (kind,
dtype, per-device operand bytes, group size), and ``summarize_collectives``
reads either list.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

# `%name = bf16[8,128]{1,0} all-gather(...)` — result type then op
_OP_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^\s]*\s*(?:,\s*[a-z0-9]+\[[^\]]*\][^\s]*\s*)*(?:\))?\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)(?:-start)?\("
)
_GROUPS_LITERAL_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


@dataclass
class CollectiveOp:
    kind: str
    dtype: str
    result_bytes: int
    operand_bytes: int
    group_size: int

    @property
    def ring_link_bytes(self) -> float:
        """Per-device bytes on the busiest link under a ring schedule."""
        g, n = self.group_size, self.operand_bytes
        if g <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * n * (g - 1) / g
        if self.kind == "all-gather":
            return float(n) * (g - 1)
        if self.kind == "reduce-scatter":
            return n * (g - 1) / g
        if self.kind == "all-to-all":
            return n * (g - 1) / g
        return float(n)  # collective-permute


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d.strip():
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        result_bytes = _shape_bytes(dtype, dims)
        g = 1
        lit = _GROUPS_LITERAL_RE.search(line)
        if lit:
            g = len([x for x in lit.group(1).split(",") if x.strip()])
        else:
            iota = _GROUPS_IOTA_RE.search(line)
            if iota:
                g = int(iota.group(2))
        if kind == "all-gather":
            operand = result_bytes // max(g, 1)
        elif kind == "reduce-scatter":
            operand = result_bytes * g
        else:
            operand = result_bytes
        ops.append(CollectiveOp(kind, dtype, result_bytes, operand, g))
    return ops


def summarize_collectives(ops: list[CollectiveOp]) -> dict:
    by_kind: dict[str, dict] = defaultdict(lambda: {"count": 0, "operand_bytes": 0, "ring_link_bytes": 0.0})
    for op in ops:
        s = by_kind[op.kind]
        s["count"] += 1
        s["operand_bytes"] += op.operand_bytes
        s["ring_link_bytes"] += op.ring_link_bytes
    total_operand = sum(s["operand_bytes"] for s in by_kind.values())
    total_ring = sum(s["ring_link_bytes"] for s in by_kind.values())
    return {
        "by_kind": dict(by_kind),
        "operand_bytes": total_operand,
        "ring_link_bytes": total_ring,
        "n_ops": sum(s["count"] for s in by_kind.values()),
    }


# ------------------------------------------------------- DTensor collectives
# _c10d_functional op -> HLO kind (the coalesced forms carry lists)
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_HLO_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32",
    torch.float32: "f32", torch.int64: "s64", torch.float64: "f64",
}


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(group_name).size()


def collectives_of(func, args: tuple, kwargs: dict) -> list[CollectiveOp]:
    """The ``CollectiveOp``s of one ``_c10d_functional`` call (one per
    tensor of a coalesced call; none for any other op). Bytes are per
    device, as the HLO parser's are: an all-gather's operand is the local
    shard, a reduce-scatter's the local input."""
    if func.namespace != "_c10d_functional":
        return []
    kind = _FUNCTIONAL_KINDS.get(func._schema.name.split("::")[-1])
    if kind is None:
        return []
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    g = _group_size(named["group_name"])
    first = next(iter(named.values()))
    ops = []
    for t in first if isinstance(first, (list, tuple)) else [first]:
        n = t.numel() * t.element_size()
        result = {"all-gather": n * g, "reduce-scatter": n // max(g, 1)}.get(kind, n)
        ops.append(CollectiveOp(kind, _HLO_DTYPES.get(t.dtype, str(t.dtype)), result, n, g))
    return ops


class CollectiveRecorder(TorchDispatchMode):
    """Records the collectives DTensor emits while the mode is active.

    Like ``CommDebugMode`` it lets every op with a DTensor argument through
    (``NotImplemented``), so DTensor lowers it to local ops and
    ``_c10d_functional`` collectives, which the mode then sees."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        self.ops.extend(collectives_of(func, args, kwargs))
        return func(*args, **kwargs)
