"""Factorization routines, dtype policies, metrics and kernels."""
