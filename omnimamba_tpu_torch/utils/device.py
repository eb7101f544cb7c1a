"""Device resolution for the port's entry points.

Entry points default to ``device="cuda"``. A missing card is an error, not a
reason to run on the CPU: the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names a CUDA
    device and PyTorch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    return dev


def require_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on a device of ``device``'s type."""
    for name, t in tensors.items():
        if t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device} but device={str(device)!r} was requested"
            )
