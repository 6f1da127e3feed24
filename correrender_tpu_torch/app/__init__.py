"""Application entry points: the BASELINE configurations."""
