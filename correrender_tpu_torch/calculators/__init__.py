"""Correlation-field calculators (the reference's L3 layer).

Importing the package registers every ported calculator type with
``calculators.base``, so ``calculator_from_settings`` finds it.
"""

from correrender_tpu_torch.calculators import correlation  # noqa: F401
