"""Micro-probes of single kernels, outside the build's paths."""
