"""Measurement scripts of the port; each needs a CUDA card."""
