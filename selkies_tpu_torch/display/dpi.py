"""DPI and cursor-size management across desktop environments.

Parity with the reference's ``set_dpi``/``set_cursor_size``
(selkies.py:687,750): push the value through every mechanism a session
might honor — xrdb ``Xft.dpi``, XFCE's xfconf, MATE/GNOME gsettings —
ignoring the ones that aren't present.  Same injectable runner protocol as
:mod:`.xrandr`.
"""

from __future__ import annotations

import logging
import shutil
from typing import Sequence, Tuple

from .xrandr import Runner, subprocess_runner

logger = logging.getLogger("selkies_tpu_torch.display")


def _have(tool: str) -> bool:
    return shutil.which(tool) is not None


class DpiManager:
    def __init__(self, runner: Runner = subprocess_runner) -> None:
        self.runner = runner

    def _run(self, argv: Sequence[str]) -> bool:
        rc, _ = self.runner(argv)
        return rc == 0

    def set_dpi(self, dpi: int) -> bool:
        """Returns True if at least one mechanism accepted the value."""
        if not 16 <= dpi <= 1024:
            raise ValueError(f"implausible dpi {dpi}")
        ok = False
        if _have("xrdb"):
            # xrdb -merge reads stdin; use -query-less direct file approach:
            # echo via sh keeps the runner protocol argv-only
            ok |= self._run(["sh", "-c",
                             f"echo 'Xft.dpi: {dpi}' | xrdb -merge"])
        if _have("xfconf-query"):
            ok |= self._run(["xfconf-query", "-c", "xsettings",
                             "-p", "/Xft/DPI", "-s", str(dpi), "--create",
                             "-t", "int"])
        if _have("gsettings"):
            # GNOME/MATE express DPI as a scale factor over 96
            factor = f"{dpi / 96.0:.2f}"
            ok |= self._run(["gsettings", "set",
                             "org.gnome.desktop.interface",
                             "text-scaling-factor", factor])
            ok |= self._run(["gsettings", "set",
                             "org.mate.interface",
                             "window-scaling-factor", str(max(1, dpi // 96))])
        if not ok:
            logger.info("no DPI mechanism available (headless?)")
        return ok

    def set_cursor_size(self, size: int) -> bool:
        if not 1 <= size <= 1024:
            raise ValueError(f"implausible cursor size {size}")
        ok = False
        if _have("xfconf-query"):
            ok |= self._run(["xfconf-query", "-c", "xsettings",
                             "-p", "/Gtk/CursorThemeSize", "-s", str(size),
                             "--create", "-t", "int"])
        if _have("gsettings"):
            ok |= self._run(["gsettings", "set",
                             "org.gnome.desktop.interface", "cursor-size",
                             str(size)])
        if _have("xrdb"):
            ok |= self._run(["sh", "-c",
                             f"echo 'Xcursor.size: {size}' | xrdb -merge"])
        return ok
