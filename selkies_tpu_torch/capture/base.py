"""Frame-source interface (copy of ``selkies_tpu/capture/base.py``).

The reference's capture is pixelflux's XShm+XDamage C++ thread delivering
encoded stripes via callback (consumed at selkies.py:2897-2904). Here capture
and encode are decoupled: a :class:`FrameSource` yields raw RGB frames; the
capture manager feeds them to the TPU encoder. The synthetic source is the
deterministic "fake device layer" the test strategy calls for (SURVEY.md §4).
"""

from __future__ import annotations

import abc
from typing import Optional

import numpy as np


class FrameSource(abc.ABC):
    """Produces uint8 RGB frames of a fixed geometry."""

    def __init__(self, width: int, height: int, fps: float = 60.0) -> None:
        self.width = width
        self.height = height
        self.fps = fps

    @abc.abstractmethod
    def next_frame(self) -> Optional[np.ndarray]:
        """The next [H, W, 3] uint8 frame, or None if none is due yet."""

    def start(self) -> None:  # pragma: no cover - default no-op
        pass

    def stop(self) -> None:  # pragma: no cover - default no-op
        pass
