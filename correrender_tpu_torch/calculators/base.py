"""Calculator base class and type registry.

Counterpart of ``correrender_tpu/calculators/base.py``. Type ids mirror
the reference's ``CALCULATOR_TYPE_IDS`` (src/Calculators/Calculator.hpp:
58-77), so state files stay compatible. The neural ids, which the port
lacks, raise ``KeyError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from correrender_tpu_torch.core.fields import FieldType

#: Reference Calculator.hpp:66-71 (state-file compatibility).
CALCULATOR_TYPE_IDS = [
    "velocity",
    "vector_magnitude",
    "vorticity",
    "helicity",
    "binary_operator",
    "noise_reduction",
    "ensemble_mean",
    "ensemble_spread",
    "set_predicate",
    "residual_color",
    "correlation",
    "correlation_torch",
    "correlation_tiny_cuda_nn",
    "correlation_quick_mlp",
    "correlation_vmlp",
    "dkl_calculator",
]

CALCULATOR_NAMES = {
    "velocity": "Velocity Calculator",
    "vector_magnitude": "Vector Magnitude Calculator",
    "vorticity": "Vorticity Calculator",
    "helicity": "Helicity Calculator",
    "binary_operator": "Binary Operator",
    "noise_reduction": "Noise Reduction",
    "ensemble_mean": "Ensemble Mean",
    "ensemble_spread": "Ensemble Spread",
    "set_predicate": "Set Predicate",
    "residual_color": "Residual Color Calculator",
    "correlation": "Correlation Calculator",
    "correlation_torch": "PyTorch Similarity Calculator",
    "correlation_tiny_cuda_nn": "tiny-cuda-nn Similarity Calculator",
    "correlation_quick_mlp": "QuickMLP Similarity Calculator",
    "correlation_vmlp": "VMLP Similarity Calculator",
    "dkl_calculator": "KL-Divergence Calculator",
}

#: The ROADMAP item that ports each reference type id the port lacks.
NOT_PORTED = dict.fromkeys(
    ("correlation_torch", "correlation_tiny_cuda_nn",
     "correlation_quick_mlp", "correlation_vmlp"), "A.12")

#: Working-set budget of a member-stack Z-slab (the JAX DKL calculator's).
SLAB_BUDGET_BYTES = 256 << 20

_TYPE_REGISTRY: Dict[str, Callable] = {}


def register_calculator_type(type_id: str):
    """Class decorator registering a calculator under a type id."""

    def wrap(cls):
        _TYPE_REGISTRY[type_id] = cls
        cls.type_id = type_id
        return cls

    return wrap


def known_calculator_types() -> frozenset:
    """Every type id :func:`calculator_from_settings` accepts."""
    return frozenset(_TYPE_REGISTRY)


def calculator_from_settings(type_id: str, settings: dict):
    """Instantiate a calculator from a state-file settings map (the
    factory dispatch of ``MainAppState.cpp:163-197``)."""
    cls = _TYPE_REGISTRY.get(type_id)
    if cls is None:
        if type_id in NOT_PORTED:
            raise KeyError(
                f"calculator type {type_id!r} is not ported yet (ROADMAP "
                f"{NOT_PORTED[type_id]}); ported: {sorted(_TYPE_REGISTRY)}")
        raise KeyError(f"unknown calculator type {type_id!r}; known: "
                       f"{sorted(_TYPE_REGISTRY)}")
    settings = dict(settings)
    continuous = bool(settings.pop("continuous_recompute", False))
    calc = cls.from_settings(settings)
    calc.continuous_recompute = continuous
    return calc


class Calculator:
    """Base of derived-field calculators.

    Subclasses set :attr:`output_name` / :attr:`output_type` and implement
    :meth:`compute(time, member) -> (Z, Y, X)` from fields of the bound
    :class:`~correrender_tpu_torch.core.fields.VolumeData`, on its device.
    """

    type_id = "invalid"
    output_type = FieldType.SCALAR

    def __init__(self, output_name: str | None = None):
        self._output_name = output_name
        self.volume_data = None
        # Recompute the output every frame even when nothing is dirty
        # (reference CorrelationCalculator.hpp:123); persisted in states.
        self.continuous_recompute = False

    @property
    def output_name(self) -> str:
        return self._output_name or self.default_output_name()

    def default_output_name(self) -> str:
        return CALCULATOR_NAMES.get(self.type_id, self.type_id)

    def bind(self, volume_data):
        self.volume_data = volume_data

    def compute(self, time: int, member: int):
        raise NotImplementedError

    def input_fields(self):
        """Field names this calculator reads, for
        ``VolumeData.mark_dirty``'s propagation; a ``None`` entry means
        the dataset's first field, and ``None`` (no conventional
        attributes) means every field."""
        names = []
        found = False
        for attr in ("field_name", "field_name_ref", "field_name_a",
                     "field_name_b", "u", "v", "w"):
            if hasattr(self, attr):
                found = True
                names.append(getattr(self, attr))
        return names if found else None

    # -- settings (the reference's SettingsMap) ---------------------------

    @classmethod
    def from_settings(cls, settings: dict):
        return cls(**cls.settings_to_kwargs(settings))

    @classmethod
    def settings_to_kwargs(cls, settings: dict) -> dict:
        return dict(settings)

    def get_settings(self) -> dict:
        return {}


def stack_slabs(stack: torch.Tensor):
    """``(z0, slab)`` over Z-slabs of a ``(Z, Y, X, n)`` member stack, each
    upcast to float32 and at most ``SLAB_BUDGET_BYTES`` of it (at least
    one plane): the per-voxel member reductions run slab by slab, so a
    bfloat16 stack is never copied whole."""
    zs, ys, xs, n = stack.shape
    planes = max(int(SLAB_BUDGET_BYTES // (4 * n * ys * xs)), 1)
    for z0 in range(0, zs, planes):
        yield z0, stack[z0:z0 + planes].to(torch.float32)
