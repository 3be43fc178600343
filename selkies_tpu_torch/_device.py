"""Device resolution for the port's entry points.

Every constructor that owns tensors takes an explicit ``device``. ``None``
means the card: the port runs on CUDA unless the caller asks for the CPU
(the tests do, with ``device="cpu"``). With no card and no device asked
for, construction raises — the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


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


def encoder_stream(device: torch.device) -> "Optional[torch.cuda.Stream]":
    """The one CUDA stream every encoder on ``device`` runs on (``None`` on
    the CPU), made at first use.

    One stream per card, not per encoder: PyTorch's caching allocator hands
    a freed block only to later allocations on the stream it was freed on,
    so blocks freed on a closed encoder's own stream would stay reserved
    for good. On one shared stream they go back to the pool the next
    encoder draws from."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _streams_lock:
        stream = _streams.get(device)
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            _streams[device] = stream
        return stream


@contextlib.contextmanager
def on_device(device: torch.device, stream=None):
    """``device`` current and ``stream`` (by default the device's encoder
    stream) its current stream, for the block: every launch, allocation
    and copy made inside goes to that device, whichever device was
    current before. A no-op on the CPU. The lanes of a mesh enter it per
    shard, so a shard's work runs on the shard's device."""
    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    if stream is None:
        stream = encoder_stream(device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def adopt_frame(frame: torch.Tensor, device: torch.device,
                stream: "Optional[torch.cuda.Stream]") -> torch.Tensor:
    """Take over a uint8 frame tensor (or a stacked batch of frames) that
    a caller made on ``device``, for an encoder that works on ``stream``
    (its device's encoder stream; ``None`` on the CPU).

    A tensor on another device, or of another type, raises ``ValueError``:
    nothing is copied behind the caller's back. On the card the caller
    wrote the frame on its current stream, while the encoder reads it on
    ``stream``; so ``stream`` waits for the work queued so far on the
    caller's stream, and the frame's memory is marked as in use on
    ``stream`` (``record_stream``), so that the caching allocator does not
    hand it to a later allocation before the encoder's reads are done.
    Call it from the thread that made the frame: the current stream is
    per thread. Both steps only enqueue; neither waits for the device."""
    if frame.device != torch.device(device):
        raise ValueError(f"frame tensor on {frame.device}; the encoder "
                         f"runs on {device}")
    if frame.dtype != torch.uint8:
        raise ValueError(f"frame tensor of {frame.dtype}; uint8 expected")
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(frame.device))
        frame.record_stream(stream)
    return frame
