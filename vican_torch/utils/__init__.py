"""Device selection and numerics settings shared by the solver entry points."""
from __future__ import annotations

import torch

from .timing import PhaseTimer

__all__ = ["PhaseTimer", "resolve_device", "no_tf32"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Without a card, ``None`` raises instead of carrying on on the CPU: the
    CPU is taken only when the caller names it (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def no_tf32() -> None:
    """Turn TF32 off for matmuls and convolutions.

    The solver's graph products and eigensolves need true float32 (the JAX
    package pins ``Precision.HIGHEST`` for the same reason, core.py:47-49);
    TF32 keeps ~3 decimal digits and breaks the certificate and the
    rotations' accuracy.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
