"""Carry the JAX package's parameters into the port.

The JAX model keeps per-period parameters stacked on a leading ``periods``
axis (``params["stack"]["sub<i>"]``, one entry per element of the layer
pattern) after an unstacked ``prefix`` list.  The port keeps one flat list
of layers in execution order (:func:`repro_torch.models.model.layer_specs`).
The tree comes in as numpy arrays (``jax.tree.map(np.asarray, params)``);
bfloat16 arrays (numpy's ``ml_dtypes`` bfloat16) become torch bfloat16
bit for bit.  MoE leaves (the experts on the axis after the periods')
come across as any other leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def params_from_jax(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """JAX ``init_params`` tree (numpy leaves) -> the port's params."""
    _, periods, pattern = cfg.layer_pattern()
    out = {k: tensor_from_numpy(tree[k], device)
           for k in ("embed", "final_norm", "lm_head") if k in tree}
    layers = [_tree(p, lambda a: tensor_from_numpy(a, device))
              for p in tree.get("prefix", [])]
    for p in range(periods):
        for i in range(len(pattern)):
            layers.append(_tree(tree["stack"][f"sub{i}"],
                                lambda a: tensor_from_numpy(a[p], device)))
    out["layers"] = layers
    return out
