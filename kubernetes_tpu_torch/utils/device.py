"""Device choice for the port's entry points.

Every entry point takes an explicit ``device``. ``None`` means the card: it
resolves to ``cuda`` and raises when no CUDA device is present, so a caller
that forgot to say ``device="cpu"`` never silently runs the plain versions.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:0`` name the same card when the current device is
    0: compare by type and the resolved index."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    ia = a.index if a.index is not None else torch.cuda.current_device()
    ib = b.index if b.index is not None else torch.cuda.current_device()
    return ia == ib


def check_on(device: torch.device, **tensors: Optional[torch.Tensor]) -> None:
    """Raise unless every given tensor lies on ``device``."""
    for name, t in tensors.items():
        if t is not None and not same_device(t.device, device):
            raise ValueError(f"{name} is on {t.device}, expected {device}")
