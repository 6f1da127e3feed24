"""Model-parameter checkpointing.

Counterpart of ``correrender_tpu/models/checkpoint.py``: a parameter
tree saves as an ``.npz`` with flat key paths (``encoder/0/w``, ...), the
JAX package's layout, so a preset saved by either package loads in the
other and gives the same arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(params, prefix=""):
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(params, torch.Tensor):
        out[prefix.rstrip("/")] = params.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(params)
    return out


def save_params(path: str, params) -> None:
    """Save a tree of tensors (or arrays) as an ``.npz`` checkpoint."""
    np.savez_compressed(path, **_flatten(params))


def load_params(path: str, like):
    """Load an ``.npz`` checkpoint into the structure of ``like``: each
    leaf a tensor on the device of ``like``'s leaf (the CPU where that
    leaf is not a tensor)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}

    def rebuild(template, prefix=""):
        if isinstance(template, dict):
            return {k: rebuild(v, f"{prefix}{k}/")
                    for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return type(template)(rebuild(v, f"{prefix}{i}/")
                                  for i, v in enumerate(template))
        key = prefix.rstrip("/")
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        device = (template.device if isinstance(template, torch.Tensor)
                  else None)
        return torch.from_numpy(flat[key]).to(device)

    return rebuild(like)
