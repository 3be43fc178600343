"""The port's display plane (``selkies_tpu_torch/display/``) against the JAX
package's ``selkies_tpu/display/``: GTF modelines, layout geometry, the
resolution sanitizers, and the xrandr and DPI command grammar through a
recording runner (no X server, no subprocess). Every result is held equal
to the JAX module's on the same inputs."""

import dataclasses
import itertools

import pytest

import selkies_tpu.display as jdisp
import selkies_tpu_torch.display as tdisp


# ---------------------------------------------------------------------------
# modeline


SIZES = [(640, 480), (803, 601), (1024, 768), (1366, 768), (1920, 1080),
         (2560, 1440), (3840, 2160), (136, 64)]
REFRESH = [24.0, 30.0, 59.94, 60.0, 75.0, 120.0, 144.0]


@pytest.mark.parametrize("w,h", SIZES, ids=lambda v: str(v))
def test_gtf_modeline_equals_jax(w, h):
    for r in REFRESH:
        got, want = tdisp.gtf_modeline(w, h, r), jdisp.gtf_modeline(w, h, r)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), (w, h, r)
        assert got.xrandr_args() == want.xrandr_args()
        assert str(got) == str(want)
        assert got.refresh_hz == want.refresh_hz


def test_gtf_1080p60_is_the_gtf_utility_and_nonsense_raises():
    m = tdisp.gtf_modeline(1920, 1080, 60)
    assert (m.pclk_mhz, m.htotal, m.vtotal) == (172.80, 2576, 1118)
    for bad in ((0, 1080, 60), (1920, 0, 60), (1920, 1080, -5)):
        with pytest.raises(ValueError):
            tdisp.gtf_modeline(*bad)
        with pytest.raises(ValueError):
            jdisp.gtf_modeline(*bad)


# ---------------------------------------------------------------------------
# layout and sanitizers


def test_parse_and_fit_res_equal_jax():
    for res in ("1921x1081", "640X480", "1366x768", "2x2", "8192x8192"):
        assert tdisp.parse_res(res) == jdisp.parse_res(res)
    for bad in ("", "x", "axb", "-2x100", "0x0", None):
        with pytest.raises(ValueError):
            tdisp.parse_res(bad)
        with pytest.raises(ValueError):
            jdisp.parse_res(bad)
    for args in itertools.product((800, 1366, 3840), (600, 768, 2160),
                                  (1920, 1280), (1080, 1200)):
        assert tdisp.fit_res(*args) == jdisp.fit_res(*args)
    assert [tdisp.even(v) for v in range(0, 9)] == \
        [jdisp.even(v) for v in range(0, 9)]


def _layout_tuple(lay):
    return (lay.fb_width, lay.fb_height,
            [dataclasses.astuple(p) for p in lay.placements])


DISPLAY_SETS = [
    {"primary": (1920, 1080)},
    {"primary": (1920, 1080), "display2": (1280, 720)},
    {"display2": (1366, 768), "primary": (2560, 1440),
     "display3": (801, 601)},
    {"primary": (1024, 768), "display4": (640, 480), "display2": (1920, 1080),
     "display3": (1366, 768)},
]


@pytest.mark.parametrize("position", ["right", "left", "up", "down"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_compute_layout_equals_jax(position, n):
    displays = DISPLAY_SETS[n - 1]
    got = tdisp.compute_layout(displays, position)
    want = jdisp.compute_layout(displays, position)
    assert _layout_tuple(got) == _layout_tuple(want)
    for d in displays:
        assert got.offset_of(d) == want.offset_of(d)


def test_compute_layout_rejections_equal_jax():
    for args in (({},), ({"primary": (64, 48)}, "diagonal")):
        with pytest.raises(ValueError):
            tdisp.compute_layout(*args)
        with pytest.raises(ValueError):
            jdisp.compute_layout(*args)


# ---------------------------------------------------------------------------
# xrandr and DPI command grammar (recording runner)

XRANDR_QUERY = """\
Screen 0: minimum 8 x 8, current 1920 x 1080, maximum 16384 x 16384
DVI-D-0 connected primary 1920x1080+0+0 (normal left inverted) 530mm x 300mm
   1920x1080     60.00*+  59.94
   1280x720      60.00
HDMI-0 disconnected (normal left inverted right x axis y axis)
"""

LISTMONITORS = """\
Monitors: 2
 0: +*selkies-primary 1920/530x1080/300+0+0  DVI-D-0
 1: +selkies-display2 1280/340x720/190+1920+0
"""


class RecordingRunner:
    def __init__(self, fail=()):
        self.calls = []
        self.fail = set(fail)

    def __call__(self, argv):
        self.calls.append(list(argv))
        if any(f in argv for f in self.fail):
            return 1, ""
        if "--query" in argv:
            return 0, XRANDR_QUERY
        if "--listmonitors" in argv:
            return 0, LISTMONITORS
        return 0, ""


def _xrandr_ops(mod):
    """Drive one XrandrManager of ``mod`` through every operation; returns
    (results, argv of every call)."""
    r = RecordingRunner()
    mgr = mod.XrandrManager(runner=r, display=":1")
    lay = mod.compute_layout({"primary": (1920, 1080), "display2": (1366, 768),
                              "display3": (800, 600)}, "right")
    out = [mgr.connected_outputs(), mgr.output_modes("DVI-D-0"),
           mgr.output_modes("HDMI-0"), mgr.ensure_mode("DVI-D-0", 1920, 1080),
           mgr.ensure_mode("DVI-D-0", 1366, 768, 75.0),
           mgr.resize(1280, 720), mgr.resize(2560, 1440, output="DVI-D-0"),
           mgr.list_monitors()]
    mgr.delete_mode("DVI-D-0", "1366x768_75.00")
    mgr.apply_layout(lay, refresh=30.0)
    return out, r.calls


def test_xrandr_manager_argv_equal_jax():
    got, got_calls = _xrandr_ops(tdisp)
    want, want_calls = _xrandr_ops(jdisp)
    assert got == want
    assert got_calls == want_calls
    assert ["xrandr", "-d", ":1", "--fb", "4086x1080"] in got_calls


def test_xrandr_failures_raise_alike():
    for mod in (tdisp, jdisp):
        mgr = mod.XrandrManager(runner=RecordingRunner(fail={"--addmode"}))
        with pytest.raises(RuntimeError):
            mgr.ensure_mode("DVI-D-0", 1600, 900)
        mgr = mod.XrandrManager(runner=lambda argv: (0, ""))
        with pytest.raises(RuntimeError):
            mgr.resize(800, 600)


def _dpi_ops(mod, monkeypatch, have):
    calls = []

    def runner(argv):
        calls.append(list(argv))
        return 0, ""

    monkeypatch.setattr(mod.dpi, "_have", lambda tool: tool in have)
    mgr = mod.DpiManager(runner=runner)
    out = [mgr.set_dpi(120), mgr.set_dpi(96), mgr.set_cursor_size(48)]
    for bad in (lambda: mgr.set_dpi(5), lambda: mgr.set_cursor_size(0)):
        with pytest.raises(ValueError):
            bad()
    return out, calls


@pytest.mark.parametrize("have", [
    ("xrdb", "xfconf-query", "gsettings"), ("xrdb",), ("gsettings",), ()],
    ids=lambda h: "+".join(h) or "none")
def test_dpi_manager_argv_equal_jax(monkeypatch, have):
    got = _dpi_ops(tdisp, monkeypatch, have)
    want = _dpi_ops(jdisp, monkeypatch, have)
    assert got == want
