"""Diagram support: so far the reference's 38 named colormaps
(``colormaps.py``, a copy of the JAX package's numpy module)."""
