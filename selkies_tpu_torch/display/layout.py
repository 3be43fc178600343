"""Pure multi-display layout computation.

The geometry half of the reference's ``reconfigure_displays``
(selkies.py:2616-2779): given 1-2 logical displays and the secondary's
position relative to the primary (right/left/up/down), produce per-display
framebuffer offsets and the combined framebuffer size for xrandr
``--fb`` / ``--setmonitor``.  Also the resolution sanitizers
(``fit_res``/``parse_res``, selkies.py:216-276).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

POSITIONS = ("right", "left", "up", "down")


def even(v: int) -> int:
    """Video planes are 4:2:0 — dimensions must be even (selkies.py:3104)."""
    return max(2, v - (v % 2))


def parse_res(res: str) -> Tuple[int, int]:
    """'1920x1080' → (1920, 1080), even-aligned."""
    try:
        w_s, h_s = res.lower().split("x")
        w, h = int(w_s), int(h_s)
    except (ValueError, AttributeError):
        raise ValueError(f"invalid resolution {res!r}")
    if w <= 0 or h <= 0:
        raise ValueError(f"invalid resolution {res!r}")
    return even(w), even(h)


def fit_res(w: int, h: int, max_w: int, max_h: int) -> Tuple[int, int]:
    """Scale down into (max_w, max_h) preserving aspect (selkies.py:216)."""
    if w <= max_w and h <= max_h:
        return even(w), even(h)
    scale = min(max_w / w, max_h / h)
    return even(int(w * scale)), even(int(h * scale))


@dataclass(frozen=True)
class Placement:
    display_id: str
    width: int
    height: int
    x: int
    y: int


@dataclass(frozen=True)
class Layout:
    fb_width: int
    fb_height: int
    placements: List[Placement]

    def offset_of(self, display_id: str) -> Tuple[int, int]:
        for p in self.placements:
            if p.display_id == display_id:
                return p.x, p.y
        raise KeyError(display_id)


def compute_layout(displays: Dict[str, Tuple[int, int]],
                   position: str = "right") -> Layout:
    """Place displays into one framebuffer.

    ``displays`` maps display_id → (w, h); the display whose id is
    "primary" anchors the layout, every other display stacks to
    ``position`` of it (the reference supports exactly 2 displays; this
    generalizes by stacking along the chosen axis in insertion order).
    """
    if not displays:
        raise ValueError("no displays")
    if position not in POSITIONS:
        raise ValueError(f"position must be one of {POSITIONS}")
    ids = sorted(displays, key=lambda d: (d != "primary", d))
    sizes = {d: (even(displays[d][0]), even(displays[d][1])) for d in ids}

    placements: List[Placement] = []
    if position in ("right", "left"):
        order = ids if position == "right" else list(reversed(ids))
        x = 0
        for d in order:
            w, h = sizes[d]
            placements.append(Placement(d, w, h, x, 0))
            x += w
        fb_w = x
        fb_h = max(h for _, h in sizes.values())
    else:
        order = ids if position == "down" else list(reversed(ids))
        y = 0
        for d in order:
            w, h = sizes[d]
            placements.append(Placement(d, w, h, 0, y))
            y += h
        fb_w = max(w for w, _ in sizes.values())
        fb_h = y
    placements.sort(key=lambda p: (p.display_id != "primary", p.display_id))
    return Layout(fb_width=fb_w, fb_height=fb_h, placements=placements)
