"""Where the port's entry points run: the CUDA card unless told otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "device_kind", "as_device_kind"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the port runs on a CUDA card by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def device_kind(device=None) -> str:
    """The hardware key measurements are valid for: the CUDA device's name
    (``torch.cuda.get_device_name``) for a card, ``"cpu"`` for the CPU.
    ``device=None`` is the port's default device, the CUDA card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def as_device_kind(device) -> str:
    """A string is already a device kind; a device (or ``None``, the
    default device) gives its :func:`device_kind`."""
    return device if isinstance(device, str) else device_kind(device)
