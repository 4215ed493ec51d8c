"""Where an entry point runs.

The public entry points run on the card unless the caller asks for the
CPU: a ``torch.Tensor`` stays on its own device (``device=`` moves it), and
anything else (a numpy array, a list) goes to ``device=`` or, when none is
given, to ``cuda``.  Without a CUDA device such an input raises instead of
running on the CPU unasked.
"""

from __future__ import annotations

import torch


def as_device_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor on the device the rule above picks."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this entry point runs on the GPU by "
                "default; pass device='cpu' (or a CPU tensor) to run it on "
                "the CPU"
            )
        device = "cuda"
    return torch.as_tensor(x, device=device)
