"""The port's dry-run counts per device against the reference's, on small
cells both packages can run here: ``qwen3-0.6b`` and the reduced
``deepseek-moe-16b`` (``ell`` dispatch) at a tiny width (d 64, 4 heads /
1 KV head x 16, d_ff 128, vocabulary 8,192, experts of 32), a ``train`` and
a ``decode`` step of 4 sequences of 32 tokens, on a (2, 2) ``("data",
"model")`` mesh under the ``train`` rules.

The reference lowers and compiles each step on four forced host devices
(``_lower_compile``, unrolled, as its cost pass does) and reads XLA's
``memory_analysis`` and ``cost_analysis``; the port runs ``run_step`` on
fake DTensors over a fake 4-rank group. Each runs in a subprocess.

* Argument bytes per device are the same parameters, moments and inputs
  placed by the same rules: equal exactly.
* FLOPs per device: within 10 % (the port counts its local matmuls, XLA
  every op of the program; measured 0.935-0.999 of the reference's).
* Temp bytes per device: the port's is the peak of live local bytes in
  eager order, the reference's XLA's buffer assignment, so only the upper
  side is held: at most 1.25x the reference's in training (measured 0.63
  and 0.99), 2.5x in decode (measured 1.39 and 2.20; the collectives
  match the reference's within 3 %, the rest of the gap is not located).
  A workaround that gathers a vocabulary-sharded tensor whole shows here:
  the embedding table gathered whole put decode at 3.28x and 5.19x.
* Bytes accessed per device: at most 2x the reference's (measured
  0.62-1.88; eager ops read and write every intermediate, a fused
  program does not).
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

CELLS = [(arch, kind) for arch in ("qwen3-0.6b", "deepseek-moe-16b")
         for kind in ("train", "decode")]
SETUP = textwrap.dedent("""
    import json, sys
    CELLS = {cells!r}

    def tiny(configs, arch):
        c = configs.get_config(arch, reduced_config=True)
        base = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
                    vocab_size=8192, attn_chunk=16)
        if c.n_experts:
            base.update(d_ff_expert=32, dispatch_format="ell")
        return c.replace(**base)
""").format(cells=CELLS)
REFERENCE = SETUP + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.configs.shapes import WorkloadShape
    from repro.launch import dryrun

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {}
    for arch, kind in CELLS:
        shape = WorkloadShape(name="tiny", kind=kind, seq_len=32, global_batch=4)
        compiled, _ = dryrun._lower_compile(tiny(configs, arch), shape, mesh, unroll=True)
        ma, ca = compiled.memory_analysis(), compiled.cost_analysis()
        out[f"{arch}/{kind}"] = {
            "argument_bytes": int(ma.argument_size_in_bytes),
            "temp_bytes": int(ma.temp_size_in_bytes),
            "flops": float(ca["flops"]), "bytes": float(ca["bytes accessed"])}
    print(json.dumps(out))
""")
PORT = SETUP + textwrap.dedent("""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs
    from repro_torch.configs.shapes import WorkloadShape
    from repro_torch.launch.dryrun import fake_process_group, run_step

    out = {}
    for arch, kind in CELLS:
        shape = WorkloadShape(name="tiny", kind=kind, seq_len=32, global_batch=4)
        with fake_process_group(4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            r = run_step(tiny(configs, arch), shape, mesh, device_type="cpu")
        out[f"{arch}/{kind}"] = {k: r[k] for k in ("argument_bytes", "temp_bytes", "flops",
                                                   "bytes")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def counts():
    """(reference, port): cell -> per-device counts, both runs at once."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(pathlib.Path(__file__).resolve().parents[1] / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for code in (REFERENCE, PORT)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return tuple(json.loads(o.strip().splitlines()[-1]) for o, _ in outs)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_argument_bytes_equal_the_references(counts, arch, kind):
    ref, port = (c[f"{arch}/{kind}"] for c in counts)
    assert port["argument_bytes"] == ref["argument_bytes"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flops_within_ten_percent_of_the_references(counts, arch, kind):
    ref, port = (c[f"{arch}/{kind}"] for c in counts)
    assert port["flops"] == pytest.approx(ref["flops"], rel=0.10)


TEMP_BOUND = {"train": 1.25, "decode": 2.5}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_temp_bytes_within_a_bound_of_the_references(counts, arch, kind):
    ref, port = (c[f"{arch}/{kind}"] for c in counts)
    assert 0 < port["temp_bytes"] <= TEMP_BOUND[kind] * ref["temp_bytes"]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_bytes_accessed_at_most_twice_the_references(counts, arch, kind):
    ref, port = (c[f"{arch}/{kind}"] for c in counts)
    assert 0 < port["bytes"] <= 2 * ref["bytes"]
