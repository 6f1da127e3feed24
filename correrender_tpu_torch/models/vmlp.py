"""MLP with the reference's activation set.

Counterpart of ``correrender_tpu/models/vmlp.py`` (reference
src/Calculators/VMLP/Network.hpp, activations {None, ReLU, Snake,
SnakeAlt} at :49-53). The MLP is an ``nn.Module`` holding its
configuration; its parameters are passed in, in the JAX package's layout:
a list of ``{"w": (in, out), "b": (out,)}``, computed as ``x @ w + b``,
so JAX checkpoints and presets load without transposes. Parameters
stacked on a leading axis (``w`` of ``(P, in, out)``) evaluate P
independent networks on ``(P, n, in)`` inputs in one batched product.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _snake(x, a=1.0):
    return x + torch.sin(a * x) ** 2 / a


def _snake_alt(x, a=1.0):
    return (x + (1.0 - torch.cos(2.0 * a * x)) / (2.0 * a)) * 0.5


ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "snake": _snake,
    "snake_alt": _snake_alt,
}


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class MLP(nn.Module):
    """MLP spec: ``init(generator, device) -> params``,
    ``forward(params, x) -> y``."""

    def __init__(self, in_features: int, hidden: int = 64,
                 out_features: int = 1, num_layers: int = 3,
                 activation: str = "relu", output_activation: str = "none",
                 compute_dtype: str = "float32"):
        super().__init__()
        self.in_features = in_features
        self.hidden = hidden
        self.out_features = out_features
        self.num_layers = num_layers  # hidden layers
        self.activation = activation
        self.output_activation = output_activation
        self.compute_dtype = compute_dtype  # "float32" | "bfloat16"

    def init(self, generator=None, device=None):
        sizes = ([self.in_features] + [self.hidden] * self.num_layers
                 + [self.out_features])
        return [{"w": (torch.randn(sizes[i], sizes[i + 1],
                                   generator=generator)
                       * math.sqrt(2.0 / sizes[i])).to(device),
                 "b": torch.zeros(sizes[i + 1], device=device)}
                for i in range(len(sizes) - 1)]

    def forward(self, params, x):
        act = ACTIVATIONS[self.activation]
        out_act = ACTIVATIONS[self.output_activation]
        # bfloat16 as the JAX package computes it: h and w rounded to
        # bfloat16, their product accumulated in float32
        # (preferred_element_type), b added in float32, and the hidden
        # activations rounded back to bfloat16.
        bf16 = self.compute_dtype == "bfloat16"
        h = x.to(torch.float32)
        if bf16:
            h = _round_bf16(h)
        last = len(params) - 1
        for i, layer in enumerate(params):
            w = _round_bf16(layer["w"]) if bf16 else layer["w"]
            h = h @ w + layer["b"].unsqueeze(-2)
            if i < last:
                h = act(h)
                if bf16:
                    h = _round_bf16(h)
            else:
                h = out_act(h)
        return h
