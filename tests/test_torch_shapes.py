"""The port's workload-shape set (``repro_torch.configs.shapes``) against the
reference's: the same shapes, names and order, and the same skip rule and
reasons for every assigned architecture, full and reduced."""

import dataclasses

import pytest

from repro import configs as ref_configs
from repro.configs import shapes as ref_shapes
from repro_torch import configs
from repro_torch.configs import shapes


def test_shapes_equal_the_reference():
    assert shapes.SHAPE_NAMES == ref_shapes.SHAPE_NAMES == tuple(shapes.SHAPES)
    assert {n: dataclasses.astuple(s) for n, s in shapes.SHAPES.items()} == {
        n: dataclasses.astuple(s) for n, s in ref_shapes.SHAPES.items()}
    assert configs.SHAPES is shapes.SHAPES and configs.cells_for is shapes.cells_for
    with pytest.raises(dataclasses.FrozenInstanceError):
        shapes.SHAPES["train_4k"].seq_len = 1


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_applicable_and_cells_follow_the_reference(arch, reduced):
    cfg = configs.get_config(arch, reduced_config=reduced)
    ref_cfg = ref_configs.get_config(arch, reduced_config=reduced)
    for name in shapes.SHAPE_NAMES:
        assert shapes.applicable(cfg, name) == ref_shapes.applicable(ref_cfg, name)
    cells = shapes.cells_for(cfg)
    assert cells == ref_shapes.cells_for(ref_cfg)
    sub_quadratic = cfg.family in ("ssm", "hybrid")
    assert ("long_500k" in cells) == sub_quadratic
    assert cells[:3] == ["train_4k", "prefill_32k", "decode_32k"]
    if not sub_quadratic:
        runs, reason = shapes.applicable(cfg, "long_500k")
        assert not runs and reason.startswith("long_500k skipped: pure full-attention arch")
