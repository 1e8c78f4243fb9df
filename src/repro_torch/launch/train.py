"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--device cuda|cpu] [options]``.

Runs the reduced config by default (``--full``: the published one) on one
device, ``--device`` (default ``cuda``; the launcher raises when the card
is absent rather than training on the CPU), inside a ``sharding_context``
of the 1 x 1 host mesh, where tensors stay plain and every ``hint`` is the
identity. ``--production-mesh`` trains on ``make_production_mesh()``
instead (256/512 ranks, one per GPU, launched with torchrun): parameters
and optimizer state placed by ``build_sharding``, batches by
``batch_sharding``, as DTensors; with fewer ranks the mesh raises, as the
reference's does without 256 devices, and the dry run
(``repro_torch.launch.dryrun``) exercises that path instead.
``main(argv)`` returns the ``Trainer`` (its ``history``, its checkpoint
manager).
"""

from __future__ import annotations

import argparse
from contextlib import nullcontext

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.dist.partition import sharding_context
from repro_torch.dist.sharding import (
    LocalMesh,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    build_sharding,
    mesh_shape,
    place,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model_specs
from repro_torch.models.param import torch_dtype, tree_map
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.train.trainer import init_train_state
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the reduced (CPU-scale) config [default]")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-frac", type=float, default=0.0)
    ap.add_argument("--dispatch-format", default=None,
                    help="MoE dispatch: ell|sell|dense (Auto-SpMV run-time knob)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda)")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = get_config(args.arch, reduced_config=args.reduced)
    if args.dispatch_format and cfg.n_experts:
        cfg = cfg.replace(dispatch_format=args.dispatch_format)
    device = resolve_device(args.device)
    mesh = (make_production_mesh(device_type=device.type) if args.production_mesh
            else make_host_mesh(device))
    log.info("arch=%s device=%s mesh=%s params~%.1fM", cfg.name, device, mesh_shape(mesh),
             cfg.param_counts()["total"] / 1e6)

    opt_cfg = AdamWConfig(
        learning_rate=cosine_schedule(args.lr, args.warmup, args.steps),
        state_dtype=cfg.opt_state_dtype,
    )
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size,
        seq_len=args.seq_len,
        global_batch=args.batch,
        seed=args.seed,
        embed_dim=cfg.d_model if cfg.train_input == "embeds" or cfg.prefix_len else 0,
        prefix_len=cfg.prefix_len,
    )
    train_cfg = TrainConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        compress_frac=args.compress_frac,
    )
    cd = torch_dtype(cfg.compute_dtype)
    sharded = not isinstance(mesh, LocalMesh)  # a DeviceMesh: DTensors

    def to_device(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v).to(device)
            if k == "embeds" or k == "prefix_embeds":
                t = t.to(cd)
            out[k] = t
        if sharded:
            out = tree_map(place, out, batch_sharding(mesh, out))
        return out

    # on a DeviceMesh the model's own plain tensors (positions, masks) join
    # DTensor ops replicated
    if sharded:
        from torch.distributed.tensor.experimental import implicit_replication
    with sharding_context(mesh), implicit_replication() if sharded else nullcontext():
        step_fn = make_train_step(cfg, opt_cfg, compress_frac=train_cfg.compress_frac)
        trainer = Trainer(cfg, data_cfg, opt_cfg, train_cfg,
                          jit_step=step_fn, to_device=to_device, device=device)
        params, opt_state = init_train_state(
            cfg, opt_cfg, seed=args.seed, compress_frac=train_cfg.compress_frac, device=device
        )
        if sharded:
            param_sh = build_sharding(mesh, model_specs(cfg))
            params = tree_map(place, params, param_sh)
            replicated = NamedSharding(mesh, PartitionSpec())
            opt_state = {k: tree_map(place, v, param_sh) if k in ("m", "v", "error")
                         else place(v, replicated) for k, v in opt_state.items()}
        params, opt_state = trainer.run(params, opt_state)
    if trainer.history:
        first, last = trainer.history[0]["loss"], trainer.history[-1]["loss"]
        log.info("done: loss %.4f -> %.4f over %d steps", first, last, len(trainer.history))
    return trainer


if __name__ == "__main__":
    main()
