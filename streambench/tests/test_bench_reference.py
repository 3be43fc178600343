"""The plain reference equals the program's CPU path byte for byte (the
test imports the program; the reference does not)."""

import numpy as np
import pytest
import torch

from streambench import harness
from streambench.source import Pattern

W, H = 256, 136          # a partial last stripe and edge padding
CELL = "jpeg-q40-1080p60.lane8-scroll"


def reference(w=W, h=H, precision="float32"):
    res = harness.resolve(CELL)
    cfg = {**res["config"], "width": w, "height": h}
    return harness.reference_module(cfg["reference"]).make(
        cfg, device="cpu", precision=precision)


def frames(pattern, n, seed=3):
    pat = Pattern(W, H, seed, pattern)
    return [np.ascontiguousarray(pat.frame(k)) for k in range(n)]


@pytest.mark.parametrize("pattern", ["scroll", "desktop", "text"])
def test_solo_encoder_bytes(pattern):
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    enc = JpegStripeEncoder(W, H, quality=40, paintover_quality=90,
                            device="cpu")
    ref = reference()
    prev = None
    for k, f in enumerate(frames(pattern, 4)):
        got = [bytes((0x03, 0)) + int(k + 1).to_bytes(2, "big")
               + s.y_start.to_bytes(2, "big") + s.jpeg
               for s in enc.encode_frame(f)]
        assert ref.encode_frame(f, prev, k + 1) == got
        assert ref.judge_frame(f, prev, k + 1, got)["ok"]
        prev = f


def test_lane_bytes():
    from selkies_tpu_torch.parallel.mesh import (MeshStripeEncoder,
                                                 parse_mesh_spec)

    mesh = parse_mesh_spec("session:1", [torch.device("cpu")])
    enc = MeshStripeEncoder(mesh, 2, W, H, quality=40, paintover_quality=90)
    ref = reference()
    a, b = frames("text", 3, seed=5), frames("desktop", 3, seed=6)
    prev = [None, None]
    for k in range(3):
        out, _bytes = enc.encode_frames([a[k], b[k]])
        for n, f in enumerate((a[k], b[k])):
            got = [bytes((0x03, 0)) + (k + 1).to_bytes(2, "big")
                   + s.y_start.to_bytes(2, "big") + s.jpeg for s in out[n]]
            v = ref.judge_frame(f, prev[n], k + 1, got)
            assert v["ok"], v["why"]
            prev[n] = f


def test_paint_over_stripes_are_judged_at_their_table():
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder

    enc = JpegStripeEncoder(W, H, quality=40, paintover_quality=90,
                            paint_over_trigger_frames=2, device="cpu")
    ref = reference()
    f = frames("static", 1)[0]
    prev, painted = None, 0
    for k in range(5):
        got = [bytes((0x03, 0)) + (k + 1).to_bytes(2, "big")
               + s.y_start.to_bytes(2, "big") + s.jpeg
               for s in enc.encode_frame(f)]
        v = ref.judge_frame(f, prev, k + 1, got)
        assert v["ok"], v["why"]
        painted += v["paintover"]
        prev = f
    assert painted == ref.n_stripes


def test_missing_and_altered_stripes_are_caught():
    ref = reference()
    f0, f1 = frames("scroll", 2)
    msgs = ref.encode_frame(f1, f0, 9)
    assert ref.judge_frame(f1, f0, 9, msgs)["ok"]
    assert not ref.judge_frame(f1, f0, 9, msgs[1:])["ok"]
    bad = bytearray(msgs[0])
    bad[-5] ^= 0x01
    assert not ref.judge_frame(f1, f0, 9, [bytes(bad)] + msgs[1:])["ok"]
    assert not ref.judge_frame(f1, f0, 10, msgs)["ok"]
    # the previous frame's bytes for this one
    assert not ref.judge_frame(f1, f0, 9, ref.encode_frame(f0, None, 9))["ok"]


@pytest.mark.parametrize("cell", [CELL, "jpeg-q40-1080p60.lane8-text"])
def test_control_in_bfloat16_is_not_correct(cell):
    """The control, the reference in bfloat16, fails the comparison on
    every frame; the float32 reference passes its own."""
    from streambench.control import readings

    res = harness.resolve(cell)
    for seed in (1, 2, 3):
        c = readings(res, seed, 2, "bfloat16", "cpu", (W, H), 2)
        assert c["compared"] == 4 and c["mismatched"] == 4
        r = readings(res, seed, 2, "float32", "cpu", (W, H), 2)
        assert r["mismatched"] == 0


def test_a_session_is_judged_against_the_frame_encoded_before():
    """``judge_session``, the entry point every reference offers: a
    frame is judged against the one the session encoded before it, not
    the one before it in the source."""
    from streambench.reference import Encoded, Session

    ref = reference()
    pat = Pattern(W, H, 7, "desktop")
    session = Session("d0", pat.frame, [Encoded(k, n + 1, "acked")
                                        for n, k in enumerate([0, 1, 9, 10])])
    for e, msgs in zip(session.encoded, ref.encode_session(session)):
        e.messages = msgs
    assert all(v["ok"] for v in ref.judge_session(session, range(4)))
    # the block moved from where frame 1 had it: frame 9's stripes are
    # those that changed since frame 1, not since frame 8
    assert session.encoded[2].messages != ref.encode_frame(
        pat.frame(9), pat.frame(8), 3)
    session.encoded[1] = Encoded(8, 2, "acked")
    assert not ref.judge_session(session, [2])[0]["ok"]


def scalar_scan(y, cb, cr):
    """The scan coded one symbol at a time (T.81 F.1.2), the check on the
    reference's array coder."""
    from streambench.reference.jpeg_tables import std_tables

    dc_l, ac_l, dc_c, ac_c = std_tables()
    bits = []

    def put(value, n):
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def size(v):
        return abs(int(v)).bit_length()

    def block(zz, pred, dc_tab, ac_tab):
        diff = int(zz[0]) - pred
        s = size(diff)
        put(*dc_tab.codes[s])
        put(diff if diff > 0 else diff + (1 << s) - 1, s)
        run = 0
        for v in zz[1:].tolist():
            if v == 0:
                run += 1
                continue
            while run >= 16:
                put(*ac_tab.codes[0xF0])
                run -= 16
            s = size(v)
            put(*ac_tab.codes[(run << 4) | s])
            put(v if v > 0 else v + (1 << s) - 1, s)
            run = 0
        if run:
            put(*ac_tab.codes[0x00])
        return int(zz[0])

    pred = [0, 0, 0]
    for mr in range(y.shape[0] // 2):
        for mc in range(y.shape[1] // 2):
            for dy in (0, 1):
                for dx in (0, 1):
                    pred[0] = block(y[2 * mr + dy, 2 * mc + dx], pred[0],
                                    dc_l, ac_l)
            pred[1] = block(cb[mr, mc], pred[1], dc_c, ac_c)
            pred[2] = block(cr[mr, mc], pred[2], dc_c, ac_c)
    bits += [1] * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out)


@pytest.mark.parametrize("scale", [0.3, 4.0, 60.0, 900.0])
def test_array_coder_equals_the_scalar_coder(scale):
    """Long zero runs (ZRLs), a last coefficient at 63 (no EOB), every
    category up to 10 for AC and 11 for a DC difference, 0xFF bytes."""
    from streambench.reference.jpeg import encode_scan_420

    rng = np.random.default_rng(int(scale * 10))
    for _ in range(20):
        by, bx = 2 * int(rng.integers(1, 4)), 2 * int(rng.integers(1, 5))

        def coeffs(a, b):
            keep = rng.random((a, b, 64)) < rng.random()
            x = np.rint(rng.laplace(0, scale, (a, b, 64)) * keep)
            x[..., 0] = rng.integers(-1023, 1024, (a, b))
            return x.clip(-1023, 1023).astype(np.int16)

        y, cb, cr = coeffs(by, bx), coeffs(by // 2, bx // 2), \
            coeffs(by // 2, bx // 2)
        assert encode_scan_420(y, cb, cr) == scalar_scan(y, cb, cr)
