"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, as tests/test_launch_clis.py drives the reference's: reduced configs,
loss finite, the checkpoint written; its flags are the reference's plus
``--device``. ``--production-mesh`` raises the mesh's error without 256
ranks, and trains under a fake 256-rank process group."""

import numpy as np
import pytest

from repro.launch import train as ref_train
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import main as train_main


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_flags_are_the_references_minus_the_mesh_plus_device():
    ref, port = _flags(ref_train.build_argparser()), _flags(launch_train.build_argparser())
    assert port == ref | {"--device"} and "--production-mesh" in port
    ref_defaults = vars(ref_train.build_argparser().parse_args(["--arch", "qwen3-0.6b"]))
    port_defaults = vars(launch_train.build_argparser().parse_args(["--arch", "qwen3-0.6b"]))
    assert port_defaults.pop("device") is None and port_defaults["production_mesh"] is False
    assert port_defaults == ref_defaults


def test_production_mesh_raises_the_mesh_error_without_256_ranks(tmp_path):
    """As the reference's CLI raises on a machine without 256 devices."""
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 ranks, found 0"):
        train_main(["--arch", "qwen3-0.6b", "--device", "cpu", "--production-mesh",
                    "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # it raised before any step or checkpoint


def test_production_mesh_trains_under_a_fake_process_group(tmp_path):
    """The whole --production-mesh path on the CPU: a fake 256-rank group
    (collectives move nothing, so the numbers are not a fleet's), the 16 x
    16 mesh, parameters, moments and batches as DTensors placed by the
    rules, two steps under the sharding context, a checkpoint gathered
    whole. Run in a subprocess, which owns the process group."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        from repro_torch.launch.dryrun import fake_process_group
        from repro_torch.launch.train import main
        with fake_process_group(256):
            tr = main(["--arch", "qwen3-0.6b", "--device", "cpu", "--production-mesh",
                       "--steps", "2", "--seq-len", "32", "--batch", "16",
                       "--ckpt-dir", {str(tmp_path)!r}, "--ckpt-every", "2"])
            print(len(tr.history), tr.ckpt.latest_step())
    """)
    import os
    import pathlib

    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1] / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-2:] == ["2", "2"]
    assert "mesh={'data': 16, 'model': 16}" in r.stderr


def test_train_cli_runs_and_improves(tmp_path):
    trainer = train_main([
        "--arch", "qwen3-0.6b", "--device", "cpu",
        "--steps", "4",
        "--seq-len", "32",
        "--batch", "2",
        "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "4",
    ])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert trainer.ckpt.latest_step() == 4


def test_train_cli_moe_with_dispatch_override(tmp_path):
    trainer = train_main([
        "--arch", "deepseek-moe-16b", "--device", "cpu",
        "--steps", "2",
        "--seq-len", "32",
        "--batch", "2",
        "--dispatch-format", "sell",
        "--ckpt-dir", str(tmp_path),
    ])
    assert trainer.cfg.dispatch_format == "sell"
    assert len(trainer.history) == 2


@pytest.mark.parametrize("arch", ["musicgen-large", "paligemma-3b"])
def test_train_cli_casts_embeddings_to_the_compute_dtype(tmp_path, arch, monkeypatch):
    """Embedding inputs reach the step in ``compute_dtype`` (bf16 here)."""
    from repro_torch import configs

    real = configs.get_config
    monkeypatch.setattr(launch_train, "get_config",
                        lambda a, **kw: real(a, **kw).replace(compute_dtype="bfloat16"))
    seen = {}
    real_step = launch_train.make_train_step

    def spy(*a, **kw):
        step = real_step(*a, **kw)

        def run(p, o, batch):
            seen.update({k: v.dtype for k, v in batch.items()})
            return step(p, o, batch)

        return run

    monkeypatch.setattr(launch_train, "make_train_step", spy)
    trainer = train_main(["--arch", arch, "--device", "cpu", "--steps", "1", "--seq-len", "16",
                          "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert np.isfinite(trainer.history[0]["loss"])
    import torch

    for key in ("embeds", "prefix_embeds"):
        if key in seen:
            assert seen[key] == torch.bfloat16
    assert seen["labels"] == torch.int32 and ("embeds" in seen or "prefix_embeds" in seen)


def test_train_cli_resumes_from_its_checkpoint(tmp_path):
    train_main(["--arch", "xlstm-1.3b", "--device", "cpu", "--steps", "2", "--seq-len", "16",
                "--batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    trainer = train_main(["--arch", "xlstm-1.3b", "--device", "cpu", "--steps", "3",
                          "--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in trainer.history] == [2]
    assert trainer.ckpt.all_steps() == [2, 3]


def test_train_cli_refuses_the_card_where_there_is_none(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen3-0.6b", "--steps", "1", "--ckpt-dir", str(tmp_path)])
