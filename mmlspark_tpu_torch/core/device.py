"""Device resolution for the port's public entry points.

The port runs on the CUDA card. ``device=None`` means ``cuda``; the
CPU is used only when a caller asks for it (``device="cpu"``, as the
tests do). Without a card, the default raises: a silent CPU fallback
would hide that the kernels never ran.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class DeviceUnavailable(RuntimeError):
    """The card was asked for (``device=None`` or ``"cuda"``) and there
    is none. Callers that downgrade on other errors (the serving binned
    plane) let this one through."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when a CUDA device is asked for and
    there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
