"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
missing card is an error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``). Raises when a CUDA device is
    asked for (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s (cuda or cpu)" % dev)
    return dev

