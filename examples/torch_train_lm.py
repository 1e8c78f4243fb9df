"""End-to-end training script on the PyTorch port: train an LM for a few
hundred steps with checkpoint/resume.

  PYTHONPATH=src python examples/torch_train_lm.py --arch deepseek-moe-16b \
      --steps 200 --preset small
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --preset tiny --steps 4

Presets scale the reduced config so wall-time stays sane; the same script
runs the full config through ``python -m repro_torch.launch.train --full``.
For MoE archs, the Auto-SpMV run-time mode selects the dispatch format from
the routing histogram after a calibration forward. The flow, flags, presets
and printed lines are ``examples/train_lm.py``'s; ``--device`` (default:
the card, raising where there is none) is where the model trains.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.moe import select_dispatch_format
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import init_train_state

PRESETS = {
    # d_model, layers-multiplier, seq, batch  (~params of the tiny end-to-end run)
    "tiny": dict(d_model=64, seq=64, batch=4),
    "small": dict(d_model=128, seq=128, batch=8),
    "medium": dict(d_model=256, seq=256, batch=8),
}


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b", choices=sorted(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--compress-frac", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p = PRESETS[args.preset]

    cfg = get_config(args.arch, reduced_config=True)
    cfg = cfg.replace(
        d_model=p["d_model"],
        n_heads=max(2, p["d_model"] // 32),
        n_kv_heads=max(1, min(cfg.n_kv_heads, p["d_model"] // 32)),
        head_dim=32,
        d_ff=2 * p["d_model"] if cfg.d_ff else 0,
        d_ff_expert=p["d_model"] // 2 if cfg.d_ff_expert else 0,
        attn_chunk=64,
        vocab_size=2048 if cfg.vocab_size > 2048 else cfg.vocab_size,
    )
    print(f"training {cfg.name} preset={args.preset}: "
          f"{cfg.param_counts()['total']/1e6:.1f}M params, "
          f"{args.steps} steps, seq={p['seq']}, batch={p['batch']}")

    # Auto-SpMV run-time mode for MoE dispatch: run one calibration forward
    # with the default (ell) format, read the routing histogram, pick the format.
    opt_cfg = AdamWConfig(
        learning_rate=cosine_schedule(args.lr, 20, args.steps),
        state_dtype=cfg.opt_state_dtype,
    )
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=p["seq"], global_batch=p["batch"],
        seed=args.seed,
        embed_dim=cfg.d_model if (cfg.train_input == "embeds" or cfg.prefix_len) else 0,
        prefix_len=cfg.prefix_len,
    )
    if cfg.n_experts:
        from repro_torch.data.pipeline import SyntheticLMDataset
        from repro_torch.train.trainer import make_loss_fn

        params, _ = init_train_state(cfg, opt_cfg, seed=args.seed, device=device)
        batch = SyntheticLMDataset(data_cfg).batch_at(0)
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with torch.no_grad():
            _, aux = make_loss_fn(cfg)(params, batch)
        fmt = select_dispatch_format(aux["tokens_per_expert"])
        print(f"Auto-SpMV dispatch-format selection: routing histogram -> {fmt!r}")
        cfg = cfg.replace(dispatch_format=fmt)

    train_cfg = TrainConfig(
        steps=args.steps, log_every=20, ckpt_every=max(args.steps // 2, 50),
        ckpt_dir=args.ckpt_dir, compress_frac=args.compress_frac,
    )
    trainer = Trainer(cfg, data_cfg, opt_cfg, train_cfg, device=device)
    params, opt_state = init_train_state(
        cfg, opt_cfg, seed=args.seed, compress_frac=args.compress_frac, device=device
    )
    trainer.run(params, opt_state)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
    return trainer


if __name__ == "__main__":
    main()
