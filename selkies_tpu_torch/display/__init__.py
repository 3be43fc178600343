"""Display plane: modelines, layout, xrandr orchestration, DPI (the
port's copy of ``selkies_tpu/display/``).

The reference's display manager (selkies.py:216-470, 2616-2779) rebuilt as
three separable pieces: pure GTF math (:mod:`.modeline`), pure layout
geometry (:mod:`.layout`), and the xrandr/DPI command layer with injectable
runners (:mod:`.xrandr`, :mod:`.dpi`).
"""

from .dpi import DpiManager
from .layout import (Layout, Placement, compute_layout, even, fit_res,
                     parse_res)
from .modeline import Modeline, gtf_modeline
from .xrandr import XrandrManager, subprocess_runner, xrandr_available

__all__ = [
    "DpiManager", "Layout", "Modeline", "Placement", "XrandrManager",
    "compute_layout", "even", "fit_res", "gtf_modeline", "parse_res",
    "subprocess_runner", "xrandr_available",
]
