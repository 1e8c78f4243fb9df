"""Checkpoint manager: atomic, keep-K, with the reference's on-disk layout.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``. Writes go to a
``tmp_`` directory first and are renamed atomically, so a preemption during
save never corrupts the latest checkpoint. Arrays are stored whole
(copied to the host). Leaf keys are the reference's: dict keys and sequence
indices joined by ``"//"`` (``0//groups//0//attn//wq``), so a checkpoint
written by either package restores into the other. bfloat16 leaves
round-trip via a uint16 view (npz has no bf16 dtype), manifest dtype
``"bfloat16"``.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.dist.sharding import place
from repro_torch.models.param import leaf_from_numpy, leaf_to_numpy, tree_unflatten
from repro_torch.utils.logging import get_logger

log = get_logger("checkpoint")

_SEP = "//"


def _flatten_with_paths(tree: Any, path: tuple = ()) -> dict[str, Any]:
    """``{key: leaf}`` over dicts, tuples and lists, in ``tree_leaves``
    order; a key joins the dict keys and sequence indices on the way down."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        return {_SEP.join(str(p) for p in path): tree}
    flat: dict[str, Any] = {}
    for k, sub in items:
        flat.update(_flatten_with_paths(sub, path + (k,)))
    return flat


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: dict | None = None) -> Path:
        t0 = time.perf_counter()
        tmp = self.dir / f"tmp_{step}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = _flatten_with_paths(tree)
        arrays, manifest = {}, {"step": step, "extra": extra or {}, "leaves": {}}
        for key, leaf in flat.items():
            arr, dtype = leaf_to_numpy(leaf)
            arrays[key] = arr
            manifest["leaves"][key] = {"dtype": dtype, "shape": list(arr.shape)}
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        log.info("saved step %d (%d leaves, %.2fs)", step, len(flat), time.perf_counter() - t0)
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if p.is_dir()
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        target_like: Any,
        step: int | None = None,
        shardings: Any = None,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``target_like`` (a tree of tensors),
        each leaf in its stored dtype. Where ``shardings`` (same structure)
        has a leaf — a ``dist.sharding.NamedSharding`` or a ``torch.device``
        — the leaf is placed by it (``dist.sharding.place``: on a
        ``DeviceMesh`` a DTensor; the mesh may differ from the one that
        saved); elsewhere it goes on the device of the matching leaf of
        ``target_like``. Returns (tree, the ``extra`` saved with it)."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat_target = _flatten_with_paths(target_like)
        flat_shard = _flatten_with_paths(shardings) if shardings is not None else {}
        leaves = []
        with np.load(path / "arrays.npz") as blob:
            for key, like in flat_target.items():
                if key not in manifest["leaves"]:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = blob[key]
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != target {tuple(like.shape)}")
                sharding = flat_shard.get(key)
                leaf = leaf_from_numpy(arr, manifest["leaves"][key]["dtype"],
                                       device="cpu" if sharding is not None else like.device)
                leaves.append(leaf if sharding is None else place(leaf, sharding))
        log.info("restored step %d from %s (%.2fs)", step, path, time.perf_counter() - t0)
        return tree_unflatten(target_like, leaves), manifest["extra"]
