"""Symmetrizers: order-invariant combination of two encoder outputs.

Counterpart of ``correrender_tpu/models/symmetrizer.py`` (reference
src/Calculators/SymmetrizerType.hpp:33-35 {Add, AddDiff, Mul}):
correlation is a symmetric function of (reference, query), so the
decoder's input must not change when the two are swapped.
"""

from __future__ import annotations

import torch


def _add(ea, eb):
    return ea + eb


def _add_diff(ea, eb):
    return torch.cat([ea + eb, torch.abs(ea - eb)], dim=-1)


def _mul(ea, eb):
    return ea * eb


SYMMETRIZERS = {"add": _add, "add_diff": _add_diff, "mul": _mul}


def symmetrize(ea: torch.Tensor, eb: torch.Tensor, kind: str = "add"):
    return SYMMETRIZERS[kind](ea, eb)


def symmetrizer_output_features(in_features: int, kind: str) -> int:
    return in_features * (2 if kind == "add_diff" else 1)
