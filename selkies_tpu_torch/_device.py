"""Device resolution for the port's entry points.

Every constructor that owns tensors takes an explicit ``device``. ``None``
means the card: the port runs on CUDA unless the caller asks for the CPU
(the tests do, with ``device="cpu"``). With no card and no device asked
for, construction raises — the port never carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (or RuntimeError without a card); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "selkies_tpu_torch needs a CUDA device; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

