"""Correlation-field calculators."""
