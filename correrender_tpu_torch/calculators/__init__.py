"""Calculators: derived virtual fields (the reference's L3 layer).

Counterpart of ``correrender_tpu/calculators``. Importing the package
registers every calculator type with ``calculators.base``, so
``calculator_from_settings`` finds it.
"""

from correrender_tpu_torch.calculators.base import (
    Calculator,
    CALCULATOR_TYPE_IDS,
    CALCULATOR_NAMES,
    calculator_from_settings,
    register_calculator_type,
)
from correrender_tpu_torch.calculators.correlation import (
    CorrelationCalculator,
    correlate_field,
)
from correrender_tpu_torch.calculators.ensemble import (
    EnsembleMeanCalculator,
    EnsembleSpreadCalculator,
)
from correrender_tpu_torch.calculators.binop import BinaryOperatorCalculator
from correrender_tpu_torch.calculators.noise import NoiseReductionCalculator
from correrender_tpu_torch.calculators.velocity import (
    VelocityCalculator,
    VelocityMagnitudeCalculator,
    VorticityCalculator,
    HelicityCalculator,
)
from correrender_tpu_torch.calculators.set_predicate import (
    SetPredicateCalculator,
)
from correrender_tpu_torch.calculators.residual_color import (
    ResidualColorCalculator,
)
from correrender_tpu_torch.calculators.dkl_calculator import DKLCalculator
from correrender_tpu_torch.calculators.neural import (
    NeuralCorrelationCalculator,
)

__all__ = [
    "Calculator",
    "CALCULATOR_TYPE_IDS",
    "CALCULATOR_NAMES",
    "calculator_from_settings",
    "register_calculator_type",
    "CorrelationCalculator",
    "correlate_field",
    "EnsembleMeanCalculator",
    "EnsembleSpreadCalculator",
    "BinaryOperatorCalculator",
    "NoiseReductionCalculator",
    "VelocityCalculator",
    "VelocityMagnitudeCalculator",
    "VorticityCalculator",
    "HelicityCalculator",
    "SetPredicateCalculator",
    "ResidualColorCalculator",
    "DKLCalculator",
    "NeuralCorrelationCalculator",
]
