"""Fixtures and image metrics."""
