"""Correlation measures and their CUDA kernels."""
