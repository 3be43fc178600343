"""A whole run on the CPU, past the look for a card: sound, it comes out
correct; with the timed path broken underneath (the lane encoder's
harvest), it comes out not correct, once for each fault a one-card JPEG
lane can have."""

import dataclasses
import time

import pytest

from streambench import harness

CELL = "jpeg-q40-1080p60.lane8-scroll"
CELLS = [CELL, "jpeg-q40-1080p60.lane8-text"]


def run(seed=20260001, cell=CELL):
    return harness.run_cell(cell, seed, 2.5, False, time.monotonic(),
                            device="cpu", geometry=(256, 128), displays=2)


def altered(out):
    """A byte of each session's first stripe flipped where it is made."""
    res = []
    for stripes in out:
        if stripes:
            s = stripes[0]
            jpeg = bytearray(s.jpeg)
            jpeg[-3] ^= 0x10
            stripes = [dataclasses.replace(s, jpeg=bytes(jpeg))] + stripes[1:]
        res.append(stripes)
    return res


class Stale:
    """Each session gets the previous tick's answer again."""

    def __init__(self):
        self.last = None

    def __call__(self, out):
        prev, self.last = self.last, out
        return prev if prev is not None else out


def half_left_out(out):
    """Every other session of the batch gets nothing."""
    return [s if n % 2 == 0 else [] for n, s in enumerate(out)]


@pytest.fixture
def broken(monkeypatch):
    """Breaks the lane's harvest from the window's start on (a display
    that delivers nothing would hold the set-up until its time-out)."""
    from selkies_tpu_torch.parallel.mesh import MeshStripeEncoder

    def arm(fault):
        real_harvest = MeshStripeEncoder.harvest
        real_window = harness.Run._window
        armed = []

        def harvest(self, p):
            out, session_bytes = real_harvest(self, p)
            return (fault(out) if armed else out), session_bytes

        async def window(self):
            armed.append(True)
            await real_window(self)

        monkeypatch.setattr(MeshStripeEncoder, "harvest", harvest)
        monkeypatch.setattr(harness.Run, "_window", window)

    return arm


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell=cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["metrics"]["served_fps"]["value"] > 0
    assert out["host"]["probe_ms"] > 0
    assert out["diagnostics"]["counters"]["host_fallback_stripes_total"] >= 0


def test_the_reference_gets_each_whole_session_in_order(monkeypatch):
    """A reference sees every frame its session encoded since the session
    began, in order, whatever it judges: what a reference that keeps state
    across frames needs, so that a new profile is one new reference
    module."""
    seen = []

    class Recording:
        def judge_session(self, session, positions):
            seen.append((session, list(positions)))
            return [{"ok": True, "why": "", "paintover": 0}
                    for _ in positions]

    class Module:
        @staticmethod
        def make(config, device):
            return Recording()

    monkeypatch.setattr(harness, "reference_module", lambda name: Module)
    out = run()
    assert out["correct"], out["checks"]
    assert len(seen) == 2
    for session, positions in seen:
        enc = session.encoded
        # frames dropped at submit before the lane took one were never
        # encoded; the session starts at the first it took
        assert enc[0].frame_id == 1
        # a frame that coded to nothing (at 128 rows the scroll repeats
        # every 32 frames) goes out under no id
        ids = [e.frame_id for e in enc if e.terminal != "empty"]
        assert ids == list(range(1, len(ids) + 1))
        assert all(e.frame_id == -1 for e in enc if e.terminal == "empty")
        assert all(a.k < b.k for a, b in zip(enc, enc[1:]))
        assert len(enc) > 30 and positions
        assert all(enc[p].messages for p in positions)
        assert enc[0].messages is None      # set-up's frames kept no bytes
        assert session.frame(enc[-1].k).shape == (128, 256, 3)


@pytest.mark.parametrize("fault", [altered, Stale, half_left_out],
                         ids=["altered_answer", "previous_answer",
                              "half_the_batch_left_out"])
def test_broken_run_is_not_correct(broken, fault):
    broken(fault() if fault is Stale else fault)
    out = run()
    assert not out["correct"], out["checks"]
