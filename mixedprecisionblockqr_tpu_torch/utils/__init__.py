"""Utilities: data generation, Euroc Jacobian IO, metric logging, FLOPs
model, health checks and device timing.

The JAX package imports ``datagen``, ``flops``, ``logging`` and ``timing``
here; the port loads them on first access instead, since ``timing`` needs
the kernel layouts, whose modules import ``utils.device``."""

import importlib

__all__ = ["datagen", "flops", "logging", "timing"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
