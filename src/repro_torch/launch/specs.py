"""Abstract input specs + step builders for every (arch x workload-shape)
cell, as meta tensors (shape and dtype, no storage): PyTorch's stand-in for
the reference's ``ShapeDtypeStruct``. The dry run places them on a mesh as
fake tensors."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import WorkloadShape
from repro_torch.models import abstract_params, cache_specs, decode_step, model_specs, prefill
from repro_torch.models.param import torch_dtype, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.train.trainer import make_train_step


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    text = S - (cfg.prefix_len or 0)
    batch: dict = {}
    if cfg.train_input == "embeds":
        batch["embeds"] = _meta((B, text, cfg.d_model), torch.bfloat16)
    else:
        batch["tokens"] = _meta((B, text), torch.int32)
    if cfg.prefix_len:
        batch["prefix_embeds"] = _meta((B, cfg.prefix_len, cfg.d_model), torch.bfloat16)
    batch["labels"] = _meta((B, text), torch.int32)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    text = S - (cfg.prefix_len or 0)
    inputs: dict = {}
    if cfg.train_input == "embeds":
        inputs["embeds"] = _meta((B, text, cfg.d_model), torch.bfloat16)
    else:
        inputs["tokens"] = _meta((B, text), torch.int32)
    if cfg.prefix_len:
        inputs["prefix_embeds"] = _meta((B, cfg.prefix_len, cfg.d_model), torch.bfloat16)
    return inputs


def decode_input_specs(cfg: ModelConfig, shape: WorkloadShape) -> dict:
    B = shape.global_batch
    return {
        "tokens": _meta((B, 1), torch.int32),
        "positions": _meta((B, 1), torch.int32),
    }


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return abstract_params(cache_specs(cfg, batch, max_len), cfg.compute_dtype)


def abstract_opt_state(cfg: ModelConfig, param_specs) -> dict:
    dt = torch_dtype(cfg.opt_state_dtype)
    mv = tree_map(lambda s: _meta(s.shape, dt), param_specs)
    return {"m": mv, "v": tree_map(lambda x: x, mv), "step": _meta((), torch.int32)}


def make_step_fn(cfg: ModelConfig, shape: WorkloadShape, *, unroll: bool = False):
    """(step_fn, example_args tree) for the cell's workload kind.

    ``unroll`` is the reference's switch between its scanned lowering and
    the cost-accurate unrolled one. The port's model is eager: layer groups
    and attention chunks are Python loops either way, so both values give
    the same program; the argument is kept so callers read the same.
    """
    if shape.kind == "train":
        opt_cfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
        step = make_train_step(cfg, opt_cfg, unroll_layers=unroll)
        pspecs = model_specs(cfg)
        args = (
            abstract_params(pspecs, cfg.param_dtype),
            abstract_opt_state(cfg, pspecs),
            train_batch_specs(cfg, shape),
        )
        return step, args

    if shape.kind == "prefill":

        def prefill_step(params, cache, inputs):
            logits, cache, _ = prefill(params, cfg, cache, unroll_layers=unroll, **inputs)
            return logits[:, -1, :], cache  # serving keeps last-token logits

        args = (
            abstract_params(model_specs(cfg), cfg.param_dtype),
            abstract_cache(cfg, shape.global_batch, shape.seq_len),
            prefill_input_specs(cfg, shape),
        )
        return prefill_step, args

    if shape.kind == "decode":

        def serve_step(params, cache, tokens, positions):
            return decode_step(params, cfg, cache, tokens, positions, unroll_layers=unroll)

        d = decode_input_specs(cfg, shape)
        args = (
            abstract_params(model_specs(cfg), cfg.param_dtype),
            abstract_cache(cfg, shape.global_batch, shape.seq_len),
            d["tokens"],
            d["positions"],
        )
        return serve_step, args

    raise ValueError(shape.kind)


def model_flops(cfg: ModelConfig, shape: WorkloadShape) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for
    inference, N = active params in matmuls (embedding-gather rows excluded,
    the logits matmul included)."""
    counts = cfg.param_counts()
    n_compute = counts["active"] - counts["embed"] + cfg.vocab_size * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_compute * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_compute * tokens
    return 2.0 * n_compute * shape.global_batch  # decode: one token per seq
