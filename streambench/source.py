"""The benchmark's seeded frame sources and their capture log.

The server calls ``SourceFactory`` where it would build a display's
capture source (``DataStreamingServer(source_factory=...)``). Each source
it builds is seeded with ``seed + n``, n the order in which the server
built it (the display's index when no display restarts), and every frame
it hands out is logged with the monotonic time of the call, so a frame's
flight-recorder span (whose ``capture`` interval contains that call) names
the pixels it carried. ``frame(instance, k)`` makes the same pixels again
for the reference.

Content patterns (the background and the patterns are a copy of the
port's ``capture/synthetic.py``, so the program may change its own):

* ``scroll``: the background moves up ``scroll_rows`` rows a frame, with
  wrap-around, so every stripe changes every frame. A frame is a view into
  a doubled background, so handing one out costs no copy.
* ``desktop``: the static background with one moving block. The served
  frames come from a ring of ``RING`` buffers, each redrawn where the
  block was and is (a frame is read by the lane's tick that takes it,
  within a frame or two of its capture; the ring outlasts that eightfold).
* ``static``: the background, unchanged.
* ``text``: a page of text that scrolls like ``scroll``: a dark code
  pane beside a white document, anti-aliased glyphs 8x16 pixels a cell
  (see ``text_page``). It stands for the screen content of the JCT-VC
  screen-content test class "text and graphics with motion" (TGM), whose
  scrolled web pages, documents and consoles are what remote desktops
  mostly show; the wallpaper of ``scroll`` is its low-entropy opposite.

After ``stop_at`` (monotonic seconds) ``next_frame`` returns None: the
server's capture loop then submits nothing, and frames already in flight
finish.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

PATTERNS = ("scroll", "desktop", "static", "text")
#: patterns that scroll a page of one frame's height
SCROLLING = ("scroll", "text")
#: desktop frames in flight at once (see the module's docstring)
RING = 16


def background(width: int, height: int, seed: int) -> np.ndarray:
    """The wallpaper with window rectangles of ``SyntheticSource``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    bg = np.stack(
        [
            120 + 60 * np.sin(xx / 181.0) * np.cos(yy / 127.0),
            110 + 60 * np.cos(xx / 149.0),
            140 + 50 * np.sin(yy / 167.0),
        ],
        axis=-1,
    )
    for _ in range(6):  # window rectangles with 2px borders
        x0 = rng.integers(0, max(1, width - 80))
        y0 = rng.integers(0, max(1, height - 60))
        w = rng.integers(60, min(400, width))
        h = rng.integers(40, min(300, height))
        x1, y1 = min(width, x0 + w), min(height, y0 + h)
        bg[y0:y1, x0:x1] = rng.integers(180, 250, size=3)
        bg[y0:y1, x0:x0 + 2] = bg[y0:y1, x1 - 2:x1] = 60
    return np.clip(bg, 0, 255).astype(np.uint8)


#: a text cell's size: glyphs 8 pixels wide on lines 16 pixels apart
CELL_W, CELL_H = 8, 16
#: the glyph atlas is drawn at this multiple of its size and averaged down,
#: which leaves anti-aliased edges on its diagonal and curved strokes
_SUPER = 3
#: the "font" and the page's lines: the same whatever the run's seed
_FONT_SEED = 1
_LAYOUT_SEED = 2
_N_GLYPHS = 94
#: the code pane (background, syntax colours) and the document (background,
#: text, link colours)
_CODE_BG = (30, 30, 30)
_CODE_FG = ((212, 212, 212), (86, 156, 214), (206, 145, 120),
            (106, 153, 85), (197, 134, 192))
_DOC_BG = (255, 255, 255)
_DOC_FG = ((32, 33, 36), (26, 13, 171))


def glyph_atlas(n: int = _N_GLYPHS, seed: int = _FONT_SEED) -> np.ndarray:
    """[n + 1, CELL_H, CELL_W] float32 coverage in [0, 1]; glyph 0 is the
    space. Each glyph is two to four strokes of a one-pixel pen: stems and
    bars on the pixel grid, diagonals and bowls drawn at ``_SUPER`` times
    the size and averaged down."""
    rng = np.random.default_rng(seed)
    s = _SUPER
    hs, ws = CELL_H * s, CELL_W * s
    yy, xx = np.mgrid[0:hs, 0:ws].astype(np.float32) + 0.5
    atlas = np.zeros((n + 1, hs, ws), np.float32)
    # the glyph box: x 1..6, y from the ascender line 3 (x-height line 6)
    # to the baseline 13, descenders to 15
    for g in range(1, n + 1):
        top = 3 if rng.random() < 0.5 else 6
        bottom = 15 if rng.random() < 0.15 else 13
        c = atlas[g]
        for _ in range(rng.integers(2, 5)):
            kind = rng.integers(0, 4)
            if kind == 0:                                  # stem
                x = int(rng.integers(1, 7))
                c[top * s:bottom * s, x * s:(x + 1) * s] = 1
            elif kind == 1:                                # bar
                y = int(rng.choice([top, (top + 13) // 2, 12]))
                x0 = int(rng.integers(1, 4))
                x1 = int(rng.integers(x0 + 2, 8))
                c[y * s:(y + 1) * s, x0 * s:x1 * s] = 1
            elif kind == 2:                                # diagonal
                x0, x1 = (float(v) for v in rng.uniform(1, 7, 2))
                y0, y1 = top * s, bottom * s
                t = np.clip((yy - y0) / (y1 - y0), 0, 1)
                d = np.abs(xx - (x0 + (x1 - x0) * t) * s)
                c[(d <= s / 2) & (yy >= y0) & (yy < y1)] = 1
            else:                                          # bowl
                cy = (top + 13) / 2 * s if top == 3 else 9.5 * s
                ry = (13 - top) / 2 * s if top == 3 else 3.5 * s
                r = np.hypot((xx - 4 * s) / (3 * s), (yy - cy) / ry)
                c[np.abs(r - 1) <= 0.5 / 3] = 1
    return atlas.reshape(n + 1, CELL_H, s, CELL_W, s).mean(axis=(2, 4))


def _text_lines(rows: int, cols: int):
    """The page's lines, the same for every seed: glyph ids [rows, cols]
    and colours [rows, cols, 3] of a code pane (the left quarter) beside a
    document, each line words of one to ten glyphs, ragged, with blank
    lines between paragraphs."""
    rng = np.random.default_rng(_LAYOUT_SEED)
    split = cols // 4
    ids = np.zeros((rows, cols), np.int64)
    fg = np.zeros((rows, cols, 3), np.float32)
    for r in range(rows):
        for c0, c1, code in ((0, split, True), (split, cols, False)):
            if rng.random() < 0.15:                        # blank line
                continue
            indent = 1 + (int(rng.integers(0, 4)) * 2 if code else 1)
            end = c0 + int((c1 - c0) * rng.uniform(0.5, 0.97))
            c = c0 + indent
            while c < end:
                n = int(min(rng.integers(1, 11), end - c))
                ids[r, c:c + n] = rng.integers(1, _N_GLYPHS + 1, n)
                if code:
                    colour = _CODE_FG[int(rng.integers(0, len(_CODE_FG)))]
                else:
                    colour = _DOC_FG[int(rng.random() < 0.06)]
                fg[r, c:c + n] = colour
                c += n + 1
    return ids, fg, split


def text_page(width: int, height: int, seed: int) -> np.ndarray:
    """[height, width, 3] uint8: the lines of ``_text_lines`` drawn with
    ``glyph_atlas``, the code pane's lines and the document's each in an
    order drawn from ``seed``. Every seed shows the same lines, so every
    seed's page codes to about the same bytes: the seed changes the order
    of the work, not its amount."""
    rows, cols = -(-height // CELL_H), -(-width // CELL_W)
    ids, fg, split = _text_lines(rows, cols)
    rng = np.random.default_rng(seed)
    for sl in (np.s_[:, :split], np.s_[:, split:]):
        order = rng.permutation(rows)
        ids[sl], fg[sl] = ids[sl][order], fg[sl][order]
    bg = np.empty((rows, cols, 3), np.float32)
    bg[:, :split] = _CODE_BG
    bg[:, split:] = _DOC_BG
    a = glyph_atlas()[ids].transpose(0, 2, 1, 3).reshape(
        rows * CELL_H, cols * CELL_W)[..., None]
    up = (lambda x: np.repeat(np.repeat(x, CELL_H, 0), CELL_W, 1))
    page = up(bg) * (1 - a) + up(fg) * a
    return np.rint(page[:height, :width]).astype(np.uint8)


class Pattern:
    """Frame k of one seeded source, made the same way every time."""

    def __init__(self, width: int, height: int, seed: int, pattern: str,
                 scroll_rows: int = 4) -> None:
        if pattern not in PATTERNS:
            raise ValueError(f"unknown content pattern {pattern!r}")
        self.width, self.height = width, height
        self.pattern = pattern
        self.scroll_rows = int(scroll_rows)
        bg = (text_page if pattern == "text" else background)(width, height,
                                                              seed)
        self._bg = bg
        # frame k of a scrolling pattern is rows s..s+H of the doubled
        # page, s = scroll_rows * k mod H: np.roll(bg, -s, axis=0) as a view
        self._bg2 = np.concatenate([bg, bg]) if pattern in SCROLLING else None
        self._ring: List[Optional[Tuple[int, np.ndarray]]] = [None] * RING

    def _block(self, k: int) -> Tuple[slice, slice]:
        h, w = self.height, self.width
        bw, bh = max(8, w // 12), max(8, h // 12)
        x = int((np.sin(k * 0.13) * 0.45 + 0.5) * (w - bw))
        y = int((np.cos(k * 0.11) * 0.45 + 0.5) * (h - bh))
        return slice(y, y + bh), slice(x, x + bw)

    def frame(self, k: int) -> np.ndarray:
        """Frame k, made anew."""
        if self.pattern in SCROLLING:
            s = (self.scroll_rows * k) % self.height
            return self._bg2[s:s + self.height]
        if self.pattern == "static":
            return self._bg
        f = self._bg.copy()
        f[self._block(k)] = (230, 60, 60)
        return f

    def served(self, k: int) -> np.ndarray:
        """Frame k as the source hands it out: the same pixels as
        ``frame(k)``, a desktop frame redrawn in a ring buffer."""
        if self.pattern != "desktop":
            return self.frame(k)
        slot = self._ring[k % RING]
        if slot is None:
            f = self.frame(k)
        else:
            old_k, f = slot
            ys, xs = self._block(old_k)
            f[ys, xs] = self._bg[ys, xs]
            f[self._block(k)] = (230, 60, 60)
        self._ring[k % RING] = (k, f)
        return f


class LoggedSource:
    """One display's capture source, as the server's capture loop uses it
    (``start``/``next_frame``/``stop``)."""

    def __init__(self, factory: "SourceFactory", instance: int,
                 pattern: Pattern, fps: float) -> None:
        self._factory = factory
        self.instance = instance
        self.pattern = pattern
        self.width, self.height, self.fps = pattern.width, pattern.height, fps
        self._k = 0

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def next_frame(self) -> Optional[np.ndarray]:
        t = time.monotonic()
        if t >= self._factory.stop_at:
            return None
        k = self._k
        self._k = k + 1
        self._factory.log.append((t, self.instance, k))
        return self.pattern.served(k)


class SourceFactory:
    """The ``source_factory`` the benchmark hands the server."""

    def __init__(self, seed: int, pattern: str, scroll_rows: int = 4) -> None:
        self.seed = int(seed)
        self.pattern_name = pattern
        self.scroll_rows = int(scroll_rows)
        self.stop_at = float("inf")
        #: (monotonic time of the call, source instance, frame index)
        self.log: List[Tuple[float, int, int]] = []
        self.sources: List[LoggedSource] = []

    def pattern(self, instance: int) -> Pattern:
        src = self.sources[instance]
        return src.pattern

    def __call__(self, width: int, height: int, fps: float,
                 x: int = 0, y: int = 0) -> LoggedSource:
        n = len(self.sources)
        pat = Pattern(width, height, self.seed + n, self.pattern_name,
                      self.scroll_rows)
        src = LoggedSource(self, n, pat, fps)
        self.sources.append(src)
        return src
