"""Plain references the benchmark judges the program's output against.

Each configuration names its module here (the ``reference`` key of its
file). A reference is plain PyTorch and NumPy: it imports nothing of the
program, of its JAX original or of JAX, and takes nothing the program
made; it reads the program's delivered bytes only to judge them.

Every reference module offers the same entry point, whatever its profile,
so a new profile is one new module here and no change to the harness:

* ``make(config, device, precision="float32")`` returns a reference with
* ``judge_session(session, positions)``: one verdict ``{"ok", "why",
  "paintover"}`` for each position of ``session.encoded`` asked for, and
* ``encode_session(session)``: the messages of every encoded frame, as
  the profile sends them when nothing else (a paint-over) is due; the
  control runs this in a lower precision.

A ``Session`` is what one display's encoder was handed, in the order it
took it: every frame it encoded since the session began (not only the
delivered ones), each with the source frame it encoded, so a reference
that keeps state across frames (an H.264 reference plane) rebuilds that
state from the frames actually encoded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Encoded:
    """One frame the session's encoder took: the source frame ``k`` it
    encoded, the frame id it went out under, how its span ended
    (``acked``, ``empty``, or a drop), and its delivered messages (None
    where the client kept none: outside the window, or never delivered)."""

    k: int
    frame_id: int
    terminal: str
    messages: Optional[List[bytes]] = None


@dataclass
class Session:
    """One display's session: ``frame(k)`` makes source frame k again, and
    ``encoded`` lists every frame its encoder took, in order."""

    display: str
    frame: Callable[[int], np.ndarray]
    encoded: List[Encoded] = field(default_factory=list)
