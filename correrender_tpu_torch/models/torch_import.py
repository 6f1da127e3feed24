"""Import published PyTorch correlation networks onto the SRN.

Counterpart of ``correrender_tpu/models/torch_import.py``. The reference
ships its VMV'23 / SSDBM'24 networks as TorchScript modules (reference
src/Calculators/PyTorchCorrelationCalculator.cpp:261-277: an
encoder/decoder pair with a symmetrizer between them). This module maps
the weights of such an archive, read without unpickling code by
:mod:`correrender_tpu_torch.io.torchscript`, onto
:class:`~correrender_tpu_torch.models.mine.CorrelationSRN`.

Structure is inferred from the weights themselves: linear layers are
grouped by name prefix (``encoder*`` / ``decoder*``, else the first
and second module groups found), ordered by their layer index, and
the symmetrizer arity follows from decoder-input vs encoder-output
width (2x ⇒ AddDiff, 1x ⇒ Add/Mul — reference SymmetrizerType.hpp:
33-35).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from correrender_tpu_torch.models.encodings import FrequencyEncoding
from correrender_tpu_torch.models.mine import CorrelationSRN
from correrender_tpu_torch.models.vmlp import MLP


def _layer_groups(weights: dict) -> dict:
    """Group ``...<idx>.weight/.bias`` keys into ordered layer lists."""
    groups: dict = {}
    for key, arr in weights.items():
        # bfloat16 weights come back as tensors (numpy has no bfloat16).
        if key == "__meta__" or not isinstance(arr,
                                               (np.ndarray, torch.Tensor)):
            continue
        m = re.match(r"^(.*?)\.?(\d+)?\.(weight|bias)$", key)
        if not m:
            continue
        prefix, idx, kind = m.groups()
        prefix = re.sub(r"\.(net|layers|linears|model)$", "", prefix)
        entry = groups.setdefault(prefix, {})
        entry.setdefault(int(idx or 0), {})[kind] = arr
    return {
        p: [layers[i] for i in sorted(layers)]
        for p, layers in groups.items()
        if any("weight" in l for l in layers.values())
    }


def _float32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.from_numpy(np.array(a, np.float32))


def _to_mlp_params(layers) -> list:
    """Torch ``(out, in)`` Linear stacks → ``{"w": (in, out)}``."""
    params = []
    for layer in layers:
        w = _float32(layer["weight"])
        b = layer.get("bias")
        b = torch.zeros(w.shape[0]) if b is None else _float32(b)
        params.append({"w": w.T.contiguous(), "b": b})
    return params


def _pick(groups: dict, want: str, fallback_index: int):
    for name in groups:
        if want in name.lower():
            return groups[name]
    names = sorted(groups)
    if len(names) > fallback_index:
        return groups[names[fallback_index]]
    raise ValueError(
        f"torch archive has no '{want}' module group "
        f"(found: {sorted(groups)})"
    )


def _mlp_like(params, activation):
    # The MLP config assumes one uniform hidden width (the published
    # models are uniform); reject archives that are not, so a
    # config-rebuilt model can never silently mismatch the imported
    # parameter shapes.
    hidden_widths = {p["w"].shape[1] for p in params[:-1]}
    if len(hidden_widths) > 1:
        raise ValueError(
            "imported MLP has non-uniform hidden widths "
            f"{sorted(hidden_widths)}; MLP config supports one"
        )
    return MLP(
        in_features=params[0]["w"].shape[0],
        hidden=params[0]["w"].shape[1],
        out_features=params[-1]["w"].shape[1],
        num_layers=len(params) - 1,
        activation=activation,
    )


def srn_from_torch_archive(path: str, symmetrizer: str | None = None,
                           activation: str = "relu"):
    """Load a published encoder/decoder archive → (model, params), the
    parameters float32 tensors on the CPU.

    Args:
      path: ``.pt``/``.pth`` archive (TorchScript or state-dict zip).
      symmetrizer: override the inferred symmetrizer ("add" |
        "add_diff" | "mul"); widths only disambiguate AddDiff, so Mul
        models need this set explicitly.
      activation: hidden activation of the published MLPs (weights
        cannot encode it; the reference nets use ReLU).
    """
    from correrender_tpu_torch.io.torchscript import read_torch_weights

    groups = _layer_groups(read_torch_weights(path))
    enc_params = _to_mlp_params(_pick(groups, "encoder", 0))
    dec_params = _to_mlp_params(_pick(groups, "decoder", 1))

    enc_in = enc_params[0]["w"].shape[0]
    latent = enc_params[-1]["w"].shape[1]
    dec_in = dec_params[0]["w"].shape[0]
    if symmetrizer is None:
        symmetrizer = "add_diff" if dec_in == 2 * latent else "add"
    elif symmetrizer == "add_diff" and dec_in != 2 * latent:
        raise ValueError(
            f"add_diff needs decoder input {2 * latent}, got {dec_in}"
        )
    if enc_in % 6:
        raise ValueError(
            f"encoder input width {enc_in} does not match a 3-D "
            "frequency encoding (6 features per frequency)"
        )
    model = CorrelationSRN(
        encoding=FrequencyEncoding(dims=3, num_frequencies=enc_in // 6),
        encoder=_mlp_like(enc_params, activation),
        decoder=_mlp_like(dec_params, activation),
        symmetrizer=symmetrizer,
    )
    return model, {"encoding": {}, "encoder": enc_params,
                   "decoder": dec_params}
