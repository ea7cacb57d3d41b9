"""Load the reference's parameters into the port's ``Model``.

The JAX ``Model.init`` returns a pytree whose per-layer leaves are stacked
on a leading layer axis, one stack per segment (e.g.
``segments[0]["attn"]["wq"]`` is (L, d, H, dh), ``segments[0]["mixer"]["a_log"]``
(L, di, S)). ``params_from_jax`` takes
that tree as NumPy arrays and returns the port's state dict, layer by layer
in segment order; ``Model.load_state_dict`` then copies it onto the model's
device and parameter dtype. The tests use it so both packages compute from
identical weights.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, name + ".")
        else:
            yield name, np.asarray(val)


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX dense-, ssm- or hybrid-model params (NumPy leaves) -> the port's
    state dict. Tied embeddings have no ``out_embed`` on either side."""
    if cfg.family not in ("dense", "ssm", "hybrid"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    sd: Dict[str, torch.Tensor] = {}
    for key in ("embed", "out_embed"):
        if key in np_tree:
            sd[key] = torch.from_numpy(np.array(np_tree[key]))
    for name, arr in _leaves(np_tree["final_norm"], "final_norm."):
        sd[name] = torch.from_numpy(np.array(arr))
    layer = 0
    for seg in np_tree["segments"]:
        leaves = list(_leaves(seg))
        n = leaves[0][1].shape[0]
        for i in range(n):
            for name, arr in leaves:
                sd[f"layers.{layer}.{name}"] = torch.from_numpy(np.array(arr[i]))
            layer += 1
    if layer != cfg.num_layers:
        raise ValueError(f"tree holds {layer} layers, config {cfg.num_layers}")
    return sd
