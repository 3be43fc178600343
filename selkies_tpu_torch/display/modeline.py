"""VESA GTF modeline computation (pure math, no subprocesses).

The reference shells out to ``cvt``/``gtf`` and falls back to a built-in
formula to mint xrandr modelines for arbitrary client resolutions
(selkies.py:373 generate_xrandr_gtf_modeline); here the GTF formula is
implemented directly so the display manager never depends on those tools.
"""

from __future__ import annotations

from dataclasses import dataclass

# VESA GTF standard constants
_CELL_GRAN = 8
_MIN_PORCH = 1           # lines
_V_SYNC_RQD = 3          # lines
_H_SYNC_PERCENT = 8.0    # % of line period
_MIN_VSYNC_BP = 550.0    # µs
_M = 600.0               # gradient %/kHz
_C = 40.0                # offset %
_K = 128.0               # blanking-formula scaling
_J = 20.0                # scaling-factor weighting
_C_PRIME = (_C - _J) * _K / 256.0 + _J
_M_PRIME = _K / 256.0 * _M


@dataclass(frozen=True)
class Modeline:
    name: str
    pclk_mhz: float
    hdisp: int
    hsync_start: int
    hsync_end: int
    htotal: int
    vdisp: int
    vsync_start: int
    vsync_end: int
    vtotal: int

    @property
    def refresh_hz(self) -> float:
        return self.pclk_mhz * 1e6 / (self.htotal * self.vtotal)

    def xrandr_args(self) -> list:
        """Arguments for ``xrandr --newmode``."""
        return [self.name, f"{self.pclk_mhz:.2f}",
                str(self.hdisp), str(self.hsync_start),
                str(self.hsync_end), str(self.htotal),
                str(self.vdisp), str(self.vsync_start),
                str(self.vsync_end), str(self.vtotal),
                "-HSync", "+VSync"]

    def __str__(self) -> str:
        return " ".join(["Modeline", f'"{self.name}"'] + self.xrandr_args()[1:])


def gtf_modeline(width: int, height: int, refresh: float = 60.0) -> Modeline:
    """GTF timing for ``width``×``height`` at ``refresh`` Hz.

    Matches the classic ``gtf`` utility output (e.g. 1920×1080@60 →
    172.80 MHz, htotal 2576, vtotal 1118).
    """
    if width <= 0 or height <= 0 or refresh <= 0:
        raise ValueError("dimensions and refresh must be positive")
    h_pixels = round(width / _CELL_GRAN) * _CELL_GRAN
    v_lines = height

    # estimate line period, then refine against the requested field rate
    h_period_est = ((1.0 / refresh) - _MIN_VSYNC_BP / 1e6) \
        / (v_lines + _MIN_PORCH) * 1e6
    v_sync_bp = round(_MIN_VSYNC_BP / h_period_est)
    total_v_lines = v_lines + v_sync_bp + _MIN_PORCH
    v_field_est = 1.0 / h_period_est / total_v_lines * 1e6
    h_period = h_period_est / (refresh / v_field_est)

    ideal_duty_cycle = _C_PRIME - (_M_PRIME * h_period / 1000.0)
    h_blank = round(
        h_pixels * ideal_duty_cycle / (100.0 - ideal_duty_cycle)
        / (2.0 * _CELL_GRAN)) * 2 * _CELL_GRAN
    total_pixels = h_pixels + h_blank
    pclk_mhz = total_pixels / h_period

    h_sync = round(_H_SYNC_PERCENT / 100.0 * total_pixels / _CELL_GRAN) \
        * _CELL_GRAN
    h_front = h_blank // 2 - h_sync

    name = f"{width}x{height}_{refresh:.2f}"
    return Modeline(
        name=name,
        pclk_mhz=round(pclk_mhz, 2),
        hdisp=h_pixels,
        hsync_start=h_pixels + h_front,
        hsync_end=h_pixels + h_front + h_sync,
        htotal=total_pixels,
        vdisp=v_lines,
        vsync_start=v_lines + _MIN_PORCH,
        vsync_end=v_lines + _MIN_PORCH + _V_SYNC_RQD,
        vtotal=total_v_lines,
    )
