"""The LM stack of the port: configs' models as plain functions over
parameter trees of tensors (``param.py``, ``layers.py``, ``model.py``) and
the sparse inference engine (``sparse_linear.py``). Block kinds ``attn``,
``local``, ``moe`` (``moe.py``) and the recurrent ``rec``, ``mlstm`` and
``slstm`` (``recurrent.py``)."""

from repro_torch.models.model import (
    block_specs,
    cache_specs,
    decode_step,
    forward,
    init_cache,
    model_specs,
    prefill,
)
from repro_torch.models.param import (
    ParamSpec,
    abstract_params,
    axes_tree,
    init_params,
    param_count,
    params_from_numpy,
    stack_specs,
)

__all__ = [
    "block_specs",
    "cache_specs",
    "decode_step",
    "forward",
    "init_cache",
    "model_specs",
    "prefill",
    "ParamSpec",
    "abstract_params",
    "axes_tree",
    "init_params",
    "param_count",
    "params_from_numpy",
    "stack_specs",
]
