"""Factorizations and hand-written GPU kernels of the port."""
