"""CAVLC fuzzer: crafted level arrays through the port's native coder and
a decoder, and the device-CAVLC differential mode.

Mode 1 (``python -m selkies_tpu_torch.tools.cavlc_fuzz [n]``) drives the
port's native coder (``native/cavlc.cpp``, ``h264_encode_picture``) with
synthetic quantized luma levels, so that every (totalCoeff, trailingOnes,
nC class, total_zeros, run_before) table entry is used, decodes the
stream with OpenCV's decoder and compares the picture with the
:class:`~selkies_tpu_torch.ops.h264_transform.NumpyMirror`
reconstruction. It needs ``cv2`` and no device.

Mode 2 (``--device``, on the card; ``--device=cpu`` on the CPU) fuzzes the
port's device CAVLC packer (``encoder/device_cavlc.py``) against the
native coder over random P-frame level tensors: the full residual surface
(luma, chroma DC and AC), random motion vectors (the skip and mvd paths),
|level| > 127 and magnitudes past the escape code. Every stripe that is
not flagged must be bit-identical; every overflowed stripe must be flagged
(the encoder then recodes it on the host from its exact levels). The
arrays for a seed are the ones the repository's ``tools/cavlc_fuzz.py``
draws::

    python -m selkies_tpu_torch.tools.cavlc_fuzz --device 300
    python -m selkies_tpu_torch.tools.cavlc_fuzz --device=cpu 50
    python -m selkies_tpu_torch.tools.cavlc_fuzz 100
"""

import os
import sys
import tempfile

import numpy as np

from ..encoder.h264 import make_pps, make_sps
from ..native import cavlc_lib
from ..ops.h264_transform import NumpyMirror


def mirror_recon_luma(levels, qp, pred=128):
    """Decoder-side luma reconstruction of P-style plain 4x4 levels
    (n, 16, 4, 4)."""
    d = NumpyMirror.dequant4(levels, qp)
    r = NumpyMirror.inverse_dct4(d)
    return r + pred  # the caller clips


def assemble_plane(blocks, mb_w, mb_h):
    """(n, 16, 4, 4) → (H, W): a raster 4x4 grid inside raster MBs."""
    v = blocks.reshape(mb_h, mb_w, 4, 4, 4, 4)
    v = v.transpose(0, 2, 4, 1, 3, 5)
    return v.reshape(mb_h * 16, mb_w * 16)


def encode_two_frames(luma_levels, mb_w, mb_h, qp):
    """SPS, PPS, a flat IDR and one P frame of ``luma_levels`` (zero
    motion), as one Annex-B stream from the native coder."""
    lib = cavlc_lib()
    n = mb_w * mb_h
    zero_mv = np.zeros((n, 2), np.int32)
    zero_luma = np.zeros((n, 16, 16), np.int32)
    zero_ldc = np.zeros((n, 16), np.int32)
    zero_cdc = np.zeros((n, 2, 4), np.int32)
    zero_cac = np.zeros((n, 2, 4, 16), np.int32)
    cap = 1 << 22
    buf = np.empty(cap, np.uint8)
    # IDR: all-zero levels → flat 128
    sz = lib.h264_encode_picture(1, mb_w, mb_h, qp, 0, 0, zero_mv, zero_luma,
                                 zero_ldc, zero_cdc, zero_cac, buf, cap, 0)
    idr = bytes(buf[:sz])
    ll = np.ascontiguousarray(luma_levels.reshape(n, 16, 16), np.int32)
    sz = lib.h264_encode_picture(0, mb_w, mb_h, qp, 1, 0, zero_mv, ll,
                                 zero_ldc, zero_cdc, zero_cac, buf, cap, 0)
    p = bytes(buf[:sz])
    return make_sps(mb_w * 16, mb_h * 16) + make_pps() + idr + p


def decode_stream(data):
    import cv2  # lazy: the device mode needs no decoder

    fd, path = tempfile.mkstemp(suffix=".h264")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
        frames = []
        while True:
            ok, y = cap.read()
            if not ok:
                break
            frames.append(y.copy())
        cap.release()
    finally:
        os.unlink(path)
    return frames


def random_levels(rng, n_mb, density, magnitude):
    lv = rng.integers(-magnitude, magnitude + 1, (n_mb, 16, 4, 4))
    mask = rng.random((n_mb, 16, 4, 4)) < density
    return (lv * mask).astype(np.int32)


def check_seed(seed, qp=26, mb_w=2, mb_h=2, density=None, magnitude=None):
    """Mode 1, one seed: (ok, why, levels)."""
    rng = np.random.default_rng(seed)
    density = density if density is not None else rng.uniform(0.05, 0.9)
    magnitude = magnitude if magnitude is not None else int(rng.integers(1, 9))
    levels = random_levels(rng, mb_w * mb_h, density, magnitude)
    stream = encode_two_frames(levels, mb_w, mb_h, qp)
    frames = decode_stream(stream)
    if len(frames) != 2:
        return False, f"decoded {len(frames)} frames", levels
    expect = np.clip(
        mirror_recon_luma(levels, qp).astype(np.int64), -10**9, 10**9)
    expect = np.clip(assemble_plane(expect, mb_w, mb_h), 0, 255)
    got = frames[1].astype(np.int64)
    if not np.array_equal(got, expect):
        diff = int(np.abs(got - expect).max())
        return False, f"pixel mismatch max {diff}", levels
    return True, "", levels


def random_p_frame(rng, S, n_mb, density, magnitude, mv_range=12):
    """Random level tensors of a P frame of S stripes, shaped as the
    device encoder's."""
    def sparse(shape, mag):
        lv = rng.integers(-mag, mag + 1, shape)
        return (lv * (rng.random(shape) < density)).astype(np.int32)

    mv = rng.integers(-mv_range, mv_range + 1, (S, n_mb, 2)).astype(np.int32)
    if rng.random() < 0.3:
        mv[:] = 0                        # all-skip / skip-run paths
    elif rng.random() < 0.3:
        mv[:] = mv[:, :1]                # uniform motion → long skip runs
    luma = sparse((S, n_mb, 16, 4, 4), magnitude)
    cdc = sparse((S, n_mb, 2, 2, 2), magnitude)
    cac = sparse((S, n_mb, 2, 4, 4, 4), magnitude)
    cac[..., 0, 0] = 0                   # the device zeroes the AC DC slot
    return mv, luma, cdc, cac


def check_device_seed(seed, mb_w=None, mb_h=None, S=2, qp=None,
                      frame_num=None, max_stripe_bytes=65536, device=None):
    """Mode 2, one seed: the device pack on ``device`` (None: the card,
    raising without one) and the host slice header against the native
    coder. Returns (ok, why, n_overflow).

    Overflowed stripes are not compared (the encoder recodes them from
    their exact levels with the native coder, the reference itself) but
    must be flagged, so that the fallback engages; nor are they coded
    here (a full 1080p picture of dense escape-sized levels passes the
    native coder's 4 MB buffer)."""
    import torch

    from .._device import resolve_device
    from ..encoder import device_cavlc as dcav
    from ..encoder.h264 import encode_picture_nals_np

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    mb_w = mb_w if mb_w is not None else int(rng.integers(2, 7))
    mb_h = mb_h if mb_h is not None else int(rng.integers(1, 4))
    qp = qp if qp is not None else int(rng.integers(10, 48))
    frame_num = frame_num if frame_num is not None else int(
        rng.integers(1, 16))
    density = rng.uniform(0.02, 0.9)
    # |level| > 127 and past the escape code (> ~2064) both come up often
    magnitude = int(rng.choice([1, 2, 8, 30, 127, 200, 2063, 2500]))
    n_mb = mb_w * mb_h
    mv, luma, cdc, cac = random_p_frame(rng, S, n_mb, density, magnitude)

    words, t_bits, base_words, ovf = [x.cpu().numpy() for x in (
        dcav.pack_p_frame_words(
            *[torch.from_numpy(a).to(dev) for a in (mv, luma, cdc, cac)],
            torch.ones(S, dtype=torch.bool, device=dev),
            mb_w=mb_w, mb_h=mb_h, max_stripe_bytes=max_stripe_bytes))]
    payload = np.stack(
        [(words >> 24) & 0xFF, (words >> 16) & 0xFF,
         (words >> 8) & 0xFF, words & 0xFF], -1).astype(np.uint8).reshape(-1)

    ldc = np.zeros((n_mb, 4, 4), np.int32)
    for s in range(S):
        if ovf[s]:
            continue
        ref = encode_picture_nals_np(
            mv[s], luma[s], ldc, cdc[s], cac[s], is_idr=False,
            mb_w=mb_w, mb_h=mb_h, qp=qp, frame_num=frame_num)
        start = int(base_words[s]) * 4
        nbits = int(t_bits[s])
        got = dcav.assemble_p_slice(
            payload[start:start + ((nbits + 31) // 32) * 4],
            nbits, qp, frame_num)
        if got != ref:
            return False, f"stripe {s} bit mismatch", int(ovf.sum())
    return True, "", int(ovf.sum())


def main_device(n, device=None):
    fails, n_ovf = [], 0
    for seed in range(n):
        ok, why, ovf = check_device_seed(seed, device=device)
        n_ovf += ovf
        if not ok:
            fails.append((seed, why))
            print(f"seed {seed}: FAIL ({why})")
    print(f"{n - len(fails)}/{n} passed ({n_ovf} overflow stripes "
          "took the flagged fallback)")
    return 1 if fails else 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    modes = [a for a in argv if a.split("=")[0] == "--device"]
    args = [a for a in argv if a not in modes]
    n = int(args[0]) if args else 500
    if modes:
        device = modes[-1].partition("=")[2] or None
        return main_device(n, device)
    fails = []
    for seed in range(n):
        ok, why, _ = check_seed(seed)
        if not ok:
            fails.append((seed, why))
            print(f"seed {seed}: FAIL ({why})")
    print(f"{n - len(fails)}/{n} passed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
