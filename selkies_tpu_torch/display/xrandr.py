"""xrandr orchestration: modes, resizes, logical monitors.

Command half of the reference's display manager (``resize_display``
selkies.py:278, ``reconfigure_displays`` xrandr plumbing
selkies.py:2723-2751): ensure a mode exists (GTF ``--newmode`` +
``--addmode``), apply it, and carve the framebuffer into logical monitors
with ``--setmonitor``.  All shelling goes through an injectable ``runner``
so tests exercise the full command grammar without an X server.
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess
from typing import Callable, List, Optional, Sequence, Tuple

from .layout import Layout
from .modeline import gtf_modeline

logger = logging.getLogger("selkies_tpu_torch.display")

#: runner(argv) → (returncode, stdout)
Runner = Callable[[Sequence[str]], Tuple[int, str]]


def subprocess_runner(argv: Sequence[str]) -> Tuple[int, str]:
    try:
        proc = subprocess.run(list(argv), capture_output=True, text=True,
                              timeout=10)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("%s failed: %s", argv[0], e)
        return 127, ""
    if proc.returncode != 0:
        logger.debug("%s rc=%d stderr=%s", " ".join(argv), proc.returncode,
                     proc.stderr.strip())
    return proc.returncode, proc.stdout


def xrandr_available() -> bool:
    return shutil.which("xrandr") is not None


class XrandrManager:
    """Stateless-ish wrapper over one X display's RandR configuration."""

    def __init__(self, runner: Runner = subprocess_runner,
                 display: Optional[str] = None) -> None:
        self.runner = runner
        self.display = display

    def _xrandr(self, *args: str) -> Tuple[int, str]:
        argv = ["xrandr"]
        if self.display:
            argv += ["-d", self.display]
        return self.runner(argv + list(args))

    # -- queries -----------------------------------------------------------

    def connected_outputs(self) -> List[str]:
        rc, out = self._xrandr("--query")
        if rc != 0:
            return []
        return [line.split()[0] for line in out.splitlines()
                if " connected" in line]

    def output_modes(self, output: str) -> List[str]:
        """Mode names listed under ``output`` in ``xrandr --query``."""
        rc, out = self._xrandr("--query")
        if rc != 0:
            return []
        modes: List[str] = []
        collecting = False
        for line in out.splitlines():
            if not line.startswith((" ", "\t")):
                collecting = line.split()[0] == output if line.split() else False
                continue
            if collecting:
                m = re.match(r"\s+(\S+)", line)
                if m:
                    modes.append(m.group(1))
        return modes

    # -- mode management ---------------------------------------------------

    def ensure_mode(self, output: str, width: int, height: int,
                    refresh: float = 60.0) -> str:
        """Create (GTF) + attach the mode if missing; returns the mode name."""
        mode = gtf_modeline(width, height, refresh)
        existing = self.output_modes(output)
        # a native WxH mode is fine too (e.g. real monitors)
        plain = f"{width}x{height}"
        if plain in existing:
            return plain
        if mode.name not in existing:
            rc, _ = self._xrandr("--newmode", *mode.xrandr_args())
            # rc!=0 usually means the mode already exists in the screen
            # resources but isn't attached — addmode below still works
            if rc not in (0, 1):
                logger.warning("newmode %s failed rc=%d", mode.name, rc)
            rc, _ = self._xrandr("--addmode", output, mode.name)
            if rc != 0:
                raise RuntimeError(f"addmode {mode.name} on {output} failed")
        return mode.name

    def delete_mode(self, output: str, mode_name: str) -> None:
        self._xrandr("--delmode", output, mode_name)
        self._xrandr("--rmmode", mode_name)

    # -- application -------------------------------------------------------

    def resize(self, width: int, height: int, refresh: float = 60.0,
               output: Optional[str] = None) -> str:
        """Single-display resize (reference resize_display selkies.py:278)."""
        outputs = self.connected_outputs()
        if output is None:
            if not outputs:
                raise RuntimeError("no connected outputs")
            output = outputs[0]
        mode_name = self.ensure_mode(output, width, height, refresh)
        rc, _ = self._xrandr("--output", output, "--mode", mode_name)
        if rc != 0:
            raise RuntimeError(f"xrandr --output {output} --mode {mode_name} "
                               f"failed")
        return mode_name

    def list_monitors(self) -> List[str]:
        rc, out = self._xrandr("--listmonitors")
        if rc != 0:
            return []
        names = []
        for line in out.splitlines()[1:]:
            m = re.match(r"\s*\d+:\s+([+*]*)(\S+)", line)
            if m:
                names.append(m.group(2))
        return names

    def apply_layout(self, layout: Layout, refresh: float = 60.0) -> None:
        """Extended-desktop reconfiguration (selkies.py:2723-2751):
        clear stale logical monitors, grow the framebuffer, then declare one
        ``--setmonitor`` logical monitor per placement."""
        for name in self.list_monitors():
            if name.startswith("selkies-"):
                self._xrandr("--delmonitor", name)

        outputs = self.connected_outputs()
        if not outputs:
            raise RuntimeError("no connected outputs")
        primary_out = outputs[0]
        # the real output spans the whole framebuffer; logical monitors
        # carve it up for the window manager.  The mode must actually be
        # activated on the output — otherwise xrandr rejects any --fb
        # smaller than the stale active CRTC mode.
        mode_name = self.ensure_mode(primary_out, layout.fb_width,
                                     layout.fb_height, refresh)
        rc, _ = self._xrandr("--output", primary_out, "--mode", mode_name)
        if rc != 0:
            logger.warning("--output %s --mode %s failed", primary_out,
                           mode_name)
        rc, _ = self._xrandr("--fb",
                             f"{layout.fb_width}x{layout.fb_height}")
        if rc != 0:
            logger.warning("--fb %dx%d failed", layout.fb_width,
                           layout.fb_height)
        for i, p in enumerate(layout.placements):
            geom = (f"{p.width}/{p.width}x{p.height}/{p.height}"
                    f"+{p.x}+{p.y}")
            self._xrandr("--setmonitor", f"selkies-{p.display_id}", geom,
                         primary_out if i == 0 else "none")
