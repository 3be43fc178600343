"""JPEG-stripe profile on PyTorch (counterpart of ``selkies_tpu/encoder/jpeg.py``).

The frame is split into horizontal stripes; one device step per frame does
damage detection, RGB→YCbCr, 4:2:0, the fused DCT+quant+zigzag kernel
(one launch for Y, Cb and Cr) and the Huffman packer, and leaves one
``[meta | bitstream]`` buffer the host fetches with a single read. The host
then ships only the stripes that changed (damage gating), and re-emits a
static stripe once at the paint-over quality after
``paint_over_trigger_frames`` static frames.

Stripes whose device pack overflowed its word budget are host-coded with
:mod:`.entropy_py` — part of the function, not a fallback: the output bytes
are the same either way, and ``host_fallback_stripes_total`` counts them.

``entropy="host"`` is the host rung: the same device step without the
packer (one DCT+quant launch per frame), then the coefficient planes are
fetched and every emitted stripe is coded by the native scan coder
(``native/entropy.cpp``). Its stripe bytes equal the device rung's.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import adopt_frame, encoder_stream, resolve_device
from ..native import entropy_lib
from ..ops.color import rgb_to_ycbcr, subsample_420
from ..ops.dct_quant import dct8_quant_zigzag
from ..ops.quant import quality_scaled_tables
from . import entropy_py
from .device_entropy import (DeviceEntropyPacker, stuff_bytes,
                             words_to_stripe_bytes)
from .jfif import EOI, jfif_headers
from .jpeg_tables import std_tables
from .staging import StagingRing

#: device packer's block budget in the streaming step (selkies_tpu/encoder/
#: jpeg.py:123): 16 words (512 bits); a block beyond it, or a stripe beyond
#: :func:`max_stripe_bytes`, is flagged and host-coded, bit-exact either way
BLOCK_WORDS = 16


def max_stripe_bytes(stripe_h: int, pad_w: int) -> int:
    """The device packer's byte budget of a ``stripe_h`` x ``pad_w`` stripe:
    4 bits a pixel (a 1920x64 stripe 61,440 B; dense text codes to ~1.5 at
    q40), never below the JAX package's fixed 16 KB, so a small geometry
    keeps its budget and its host-coded stripes, and at most 128 KB less a
    word: the plain packer indexes a stripe's words in 15 bits."""
    return min(max(1 << 14, stripe_h * pad_w // 2), (1 << 17) - 4)

META_WORDS_PER_STRIPE = 4  # nbytes, base_words, overflow, damage


@dataclass(frozen=True)
class StripeOutput:
    """One encoded stripe ready for protocol packing."""

    y_start: int
    height: int
    jpeg: bytes
    is_paintover: bool


def encode_body(frame: torch.Tensor, prev: torch.Tensor,
                recip_y: torch.Tensor, recip_c: torch.Tensor,
                qsel: torch.Tensor, *, stripe_h: int,
                wm_scaled: Optional[torch.Tensor] = None,
                alpha_inv: Optional[torch.Tensor] = None):
    """One whole-frame encode step (the JAX ``_encode_body``).

    Args:
      frame: [H, W, 3] uint8 RGB (H multiple of stripe_h, W multiple of 16).
      prev:  [H, W, 3] uint8 previous frame (damage reference).
      recip_y/recip_c: [nq, 8, 8] f32 reciprocal quant tables (1/table).
      qsel:  [S] int32 per-stripe table index.
      wm_scaled/alpha_inv: optional watermark overlay (premultiplied RGB
        [H, W, 3] and inverse alpha [H, W, 1], int32) blended first.
    Returns:
      yq [H/8, W/8, 64], cbq/crq [H/16, W/16, 64] int16 zigzag coefficients,
      damage [S] int32 max abs pixel delta per stripe, and the (blended)
      frame that becomes the next ``prev``.
    """
    h, w, _ = frame.shape
    s = h // stripe_h
    if wm_scaled is not None:
        blended = (frame.to(torch.int32) * alpha_inv + wm_scaled + 127) // 255
        frame = blended.to(torch.uint8)

    diff = (frame.to(torch.int16) - prev.to(torch.int16)).abs()
    damage = diff.reshape(s, stripe_h * w * 3).amax(dim=1).to(torch.int32)

    y, cb, cr = rgb_to_ycbcr(frame)
    cb = subsample_420(cb)
    cr = subsample_420(cr)

    qsel = qsel.to(torch.int32)
    dev = frame.device
    row_y = qsel[torch.arange(h // 8, device=dev) // (stripe_h // 8)]
    row_c = qsel[torch.arange(h // 16, device=dev) // (stripe_h // 16)]
    yq, cbq, crq = dct8_quant_zigzag(
        [(y, recip_y, row_y), (cb, recip_c, row_c), (cr, recip_c, row_c)])
    return yq, cbq, crq, damage, frame


def encode_body_sessions(frames: torch.Tensor, prev: torch.Tensor,
                         recip_y: torch.Tensor, recip_c: torch.Tensor,
                         qsel: torch.Tensor, *, stripe_h: int):
    """:func:`encode_body` for N sessions at once (the JAX lane ``vmap``s
    ``_encode_body`` over them).

    The session axis folds into the rows: the planes are ``[N*H, W]``
    and ``qsel`` ``[N, S]`` flattens to the per-(session, stripe) table
    index, so one DCT+quant launch carries Y, Cb and Cr of every session.
    Folding is exact because every stage is per pixel, per 2x2 pair or per
    8x8 block, and no block or stripe crosses a session's rows (H is a
    multiple of ``stripe_h``, itself a multiple of 16).

    frames/prev [N, H, W, 3] uint8; returns the folded coefficient planes
    (yq [N*H/8, W/8, 64], cbq/crq [N*H/16, W/16, 64]), damage [N, S] and
    the folded frame batch [N*H, W, 3] (the next ``prev``)."""
    n, h, w, _ = frames.shape
    yq, cbq, crq, damage, new_prev = encode_body(
        frames.reshape(n * h, w, 3), prev.reshape(n * h, w, 3), recip_y,
        recip_c, qsel.reshape(-1), stripe_h=stripe_h)
    return yq, cbq, crq, damage.reshape(n, h // stripe_h), new_prev


class DeviceStep:
    """The per-geometry step: encode body + packer → one fetchable buffer.

    ``__call__`` updates ``prev`` in place with the new frame (the JAX step
    donates it instead) and returns ``(packed, yq, cbq, crq)``; ``packed`` is
    int32 ``[4*S meta words | cap_words packed words]``."""

    def __init__(self, pad_h: int, pad_w: int, stripe_h: int,
                 device: torch.device) -> None:
        self.stripe_h = stripe_h
        self.n_stripes = pad_h // stripe_h
        self.packer = DeviceEntropyPacker(
            pad_h, pad_w, stripe_h, block_words=BLOCK_WORDS,
            max_stripe_bytes=max_stripe_bytes(stripe_h, pad_w),
            device=device)

    def __call__(self, frame, prev, recip_y, recip_c, qsel,
                 wm_scaled=None, alpha_inv=None):
        yq, cbq, crq, damage, new_prev = encode_body(
            frame, prev, recip_y, recip_c, qsel, stripe_h=self.stripe_h,
            wm_scaled=wm_scaled, alpha_inv=alpha_inv)
        prev.copy_(new_prev)
        words, nbytes, base, ovf = self.packer.pack(yq, cbq, crq)
        head = torch.cat([nbytes.to(torch.int32), base.to(torch.int32),
                          ovf.to(torch.int32), damage])
        return torch.cat([head, words]), yq, cbq, crq


def split_meta(head_np: np.ndarray, n_stripes: int):
    """Parse the 4*S metadata words at the front of a packed step buffer."""
    s = n_stripes
    nbytes = head_np[0:s].astype(np.int64)
    base = head_np[s:2 * s].astype(np.int64)
    ovf = head_np[2 * s:3 * s] != 0
    damage = head_np[3 * s:4 * s].astype(np.int64)
    return nbytes, base, ovf, damage


def _entropy_encode_420(y: np.ndarray, cb: np.ndarray,
                        cr: np.ndarray) -> bytes:
    """One stripe's 4:2:0 scan (y [by, bx, 64], cb/cr [by/2, bx/2, 64]
    int16) by the native coder. Its buffer holds the worst case (under 4
    bytes a coefficient, twice that with byte stuffing), so a short buffer
    is a fault and raises."""
    lib = entropy_lib()
    dc_l, ac_l, dc_c, ac_c = std_tables()
    cap = (y.size + cb.size + cr.size) * 8 + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_encode_scan_420(
        np.ascontiguousarray(y, np.int16), np.ascontiguousarray(cb, np.int16),
        np.ascontiguousarray(cr, np.int16), y.shape[0], y.shape[1],
        dc_l.code_arr, dc_l.len_arr, ac_l.code_arr, ac_l.len_arr,
        dc_c.code_arr, dc_c.len_arr, ac_c.code_arr, ac_c.len_arr,
        out, cap)
    if n < 0:
        raise RuntimeError(f"JPEG scan coder ran out of its {cap}-byte buffer")
    return out[:n].tobytes()


def _recip(tables: np.ndarray) -> np.ndarray:
    """f32 reciprocal quant tables, computed once the way the JAX step does
    (``1.0 / tables`` in f32): quantizing multiplies, never divides."""
    return np.float32(1.0) / np.asarray(tables, np.float32)


class JpegStripeEncoder:
    """Stateful per-display JPEG-stripe encoder on one device.

    ``device=None`` runs on the card (and raises without one); the tests
    pass ``device="cpu"``, where the DCT+quant wrapper takes its plain
    PyTorch version.
    """

    def __init__(
        self,
        width: int,
        height: int,
        stripe_height: int = 64,
        quality: int = 40,
        paintover_quality: int = 90,
        use_paint_over_quality: bool = True,
        paint_over_trigger_frames: int = 15,
        damage_threshold: int = 0,
        entropy: str = "device",
        watermark_path: str = "",
        watermark_location: int = -1,
        device=None,
    ) -> None:
        if stripe_height % 16:
            raise ValueError("stripe_height must be a multiple of 16 (4:2:0 MCUs)")
        if entropy not in ("device", "host"):
            raise ValueError(f"unknown entropy mode {entropy!r}")
        self.device = resolve_device(device)
        self.entropy = entropy
        self.width = width
        self.height = height
        # Padded geometry: width to 16 (MCU), height to a stripe multiple.
        self.pad_w = -(-width // 16) * 16
        self.pad_h = -(-height // stripe_height) * stripe_height
        self.stripe_h = stripe_height
        self.n_stripes = self.pad_h // stripe_height
        self.damage_threshold = int(damage_threshold)
        self.use_paint_over_quality = use_paint_over_quality
        self.paint_over_trigger_frames = int(paint_over_trigger_frames)
        #: the stream every device call of this encoder runs on (the async
        #: driver dispatches from its own thread, and PyTorch's current
        #: stream is per thread): the card's one encoder stream, shared by
        #: every encoder on it so their freed memory is reused
        self.stream = encoder_stream(self.device)

        #: overflowed stripes host-coded from their coefficients
        self.host_fallback_stripes_total = 0
        #: host rung: coefficient bytes fetched and host coding wall time
        self.d2h_fetch_bytes_total = 0
        self.host_entropy_ms_total = 0.0

        with self.stream_context():
            self.set_quality(quality, paintover_quality)
            self._prev = torch.zeros((self.pad_h, self.pad_w, 3),
                                     dtype=torch.uint8, device=self.device)
            self._wm_scaled, self._alpha_inv = self._load_watermark(
                watermark_path, watermark_location)
            if entropy == "device":
                self._step = DeviceStep(self.pad_h, self.pad_w,
                                        self.stripe_h, self.device)
                self._packer = self._step.packer
        self._static_frames = np.zeros(self.n_stripes, dtype=np.int64)
        self._painted = np.zeros(self.n_stripes, dtype=bool)
        self._first_frame = True
        self._staging = StagingRing(depth=2, device=self.device)
        self._staging_ticket: Optional[tuple] = None
        self.synchronize()

    # -- device plumbing ---------------------------------------------------

    def stream_context(self):
        """Context that makes this encoder's stream current (no-op on CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        """Wait for the encoder's stream. The stream is shared by every
        encoder on the card, so this also waits for their queued work:
        correct, but slower than waiting for this encoder's alone."""
        if self.stream is not None:
            self.stream.synchronize()

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- configuration -----------------------------------------------------

    def _load_watermark(self, path: str, location: int):
        """Full-frame premultiplied overlay (pixelflux watermark parity).
        Locations: 0 TL, 1 TR, 2 BL, 3 BR (default), 4 center, 5
        middle-left, 6 middle-right."""
        if not path:
            return None, None
        try:
            from PIL import Image

            img = np.asarray(Image.open(path).convert("RGBA"), np.uint16)
        except Exception:
            import logging

            logging.getLogger("selkies_tpu_torch.encoder").warning(
                "watermark %s unreadable; disabled", path)
            return None, None
        wh, ww = img.shape[:2]
        wh, ww = min(wh, self.pad_h), min(ww, self.pad_w)
        img = img[:wh, :ww]
        m = 16  # margin
        positions = {
            0: (m, m),
            1: (m, self.pad_w - ww - m),
            2: (self.pad_h - wh - m, m),
            3: (self.pad_h - wh - m, self.pad_w - ww - m),
            4: ((self.pad_h - wh) // 2, (self.pad_w - ww) // 2),
            5: ((self.pad_h - wh) // 2, m),
            6: ((self.pad_h - wh) // 2, self.pad_w - ww - m),
        }
        y0, x0 = positions.get(int(location), positions[3])
        y0, x0 = max(0, y0), max(0, x0)
        wh = min(wh, self.pad_h - y0)
        ww = min(ww, self.pad_w - x0)
        if wh <= 0 or ww <= 0:
            return None, None
        img = img[:wh, :ww]
        # integer alpha blend: out = (frame*(255-a) + rgb*a + 127) // 255
        a = img[:, :, 3:4].astype(np.int32)
        wm_scaled = np.zeros((self.pad_h, self.pad_w, 3), np.int32)
        wm_scaled[y0:y0 + wh, x0:x0 + ww] = img[:, :, :3] * a
        alpha_inv = np.full((self.pad_h, self.pad_w, 1), 255, np.int32)
        alpha_inv[y0:y0 + wh, x0:x0 + ww] = 255 - a
        return self._to_device(wm_scaled), self._to_device(alpha_inv)

    def set_quality(self, quality: int, paintover_quality: Optional[int] = None):
        self.quality = int(quality)
        if paintover_quality is not None:
            self.paintover_quality = int(paintover_quality)
        ly, lc = quality_scaled_tables(self.quality)
        py, pc = quality_scaled_tables(self.paintover_quality)
        self._set_tables(np.stack([ly, py]).astype(np.float32),
                         np.stack([lc, pc]).astype(np.float32))

    def _set_tables(self, qy: np.ndarray, qc: np.ndarray) -> None:
        """[nq, 8, 8] quant tables (index 0 normal, 1 paint-over)."""
        self._qy_np = tuple(t.astype(np.uint8) for t in qy)
        self._qc_np = tuple(t.astype(np.uint8) for t in qc)
        with self.stream_context():
            self._recip_y = self._to_device(_recip(qy))
            self._recip_c = self._to_device(_recip(qc))
        self._headers: Dict[int, bytes] = {}

    def _stripe_headers(self, qidx: int) -> bytes:
        hdr = self._headers.get(qidx)
        if hdr is None:
            hdr = jfif_headers(
                self.pad_w, self.stripe_h,
                self._qy_np[qidx], self._qc_np[qidx], subsampling="420",
            )
            self._headers[qidx] = hdr
        return hdr

    # -- per-frame ---------------------------------------------------------

    def _pad(self, frame: np.ndarray) -> np.ndarray:
        if frame.shape[0] == self.pad_h and frame.shape[1] == self.pad_w:
            return frame
        return np.pad(
            frame,
            ((0, self.pad_h - frame.shape[0]), (0, self.pad_w - frame.shape[1]), (0, 0)),
            mode="edge",
        )

    def _paint_candidates(self) -> np.ndarray:
        """Paint-over candidacy from *previous* frames' history, so the quant
        table index can ride the same step as the frame."""
        return (
            self.use_paint_over_quality
            & (self._static_frames >= self.paint_over_trigger_frames)
            & ~self._painted
        )

    def _decide_emits(self, damaged: np.ndarray, paint_candidate: np.ndarray):
        """Update damage history; return (emit, is_paint) flag arrays."""
        if self._first_frame:
            damaged = np.ones_like(damaged)
            self._first_frame = False
        emit = np.zeros(self.n_stripes, dtype=bool)
        is_paint = np.zeros(self.n_stripes, dtype=bool)
        for s in range(self.n_stripes):
            if damaged[s]:
                self._static_frames[s] = 0
                self._painted[s] = False
                emit[s] = True
                is_paint[s] = bool(paint_candidate[s])  # quantized w/ HQ table
            else:
                self._static_frames[s] += 1
                if paint_candidate[s]:
                    emit[s] = True
                    is_paint[s] = True
                    self._painted[s] = True
        return emit, is_paint

    def _assemble(self, emit, is_paint, scans) -> List[StripeOutput]:
        out: List[StripeOutput] = []
        for s in range(self.n_stripes):
            if not emit[s]:
                continue
            qidx = 1 if is_paint[s] else 0
            out.append(
                StripeOutput(
                    y_start=s * self.stripe_h,
                    height=self.stripe_h,
                    jpeg=self._stripe_headers(qidx) + scans[s] + EOI,
                    is_paintover=bool(is_paint[s]),
                )
            )
        return out

    @staticmethod
    def total_packed_words(base_np: np.ndarray, nbytes_np: np.ndarray) -> int:
        """Packed-word count of the whole frame (last stripe's base + span)."""
        return int(base_np[-1]) + (int(nbytes_np[-1]) + 3) // 4

    def _scans_from_packed(
        self, words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq,
    ) -> List[bytes]:
        """Per-stripe entropy scans from the device-packed word buffer;
        overflowed stripes are host-coded from their coefficients."""
        yrows, crows = self.stripe_h // 8, self.stripe_h // 16
        raw = words_to_stripe_bytes(words_np, base_np, nbytes_np)
        scans: List[bytes] = [b""] * self.n_stripes
        for s in range(self.n_stripes):
            if not emit[s]:
                continue
            if ovf_np[s]:
                self.host_fallback_stripes_total += 1
                with self.stream_context():
                    ys = yq[s * yrows:(s + 1) * yrows].cpu().numpy()
                    cbs = cbq[s * crows:(s + 1) * crows].cpu().numpy()
                    crs = crq[s * crows:(s + 1) * crows].cpu().numpy()
                scans[s] = entropy_py.encode_scan_420(ys, cbs, crs)
            else:
                scans[s] = stuff_bytes(raw[s])
        return scans

    def _qsel(self, paint_candidate: np.ndarray) -> torch.Tensor:
        """Per-stripe table index on the device. On the card it goes through
        pinned memory with a non-blocking copy: a copy from pageable memory
        would wait for every frame already queued on the stream."""
        t = torch.from_numpy(paint_candidate.astype(np.int32))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def adopt(self, frame):
        """Hand over an RGB frame tensor a caller made on the encoder's
        device (``_device.adopt_frame``), in the caller's thread; a host
        array passes as it is. The tensor must already be padded to
        ``(pad_h, pad_w, 3)``: the encoder pads host frames only. Every
        public entry point calls it once, where the frame leaves its
        caller."""
        if not isinstance(frame, torch.Tensor):
            return frame
        if tuple(frame.shape) != (self.pad_h, self.pad_w, 3):
            raise ValueError(f"frame tensor {tuple(frame.shape)} must be "
                             f"padded to {(self.pad_h, self.pad_w, 3)}")
        return adopt_frame(frame, self.device, self.stream)

    def _frame_input(self, frame) -> torch.Tensor:
        """One frame on the device: a tensor (already handed over) as it
        is; a host frame padded and staged through the ring. encode_frame
        is synchronous, so the previous ticket is released here and the
        two slots ping-pong."""
        if isinstance(frame, torch.Tensor):
            return frame
        self._staging.release(self._staging_ticket)
        staged, self._staging_ticket = self._staging.stage(
            self._pad(np.asarray(frame, dtype=np.uint8)), stream=self.stream)
        return staged

    def encode_frame(self, frame) -> List[StripeOutput]:
        """Encode one [H, W, 3] uint8 RGB frame (a host array, or a tensor
        on the encoder's device padded to ``(pad_h, pad_w, 3)``); returns
        changed stripes only."""
        return self._encode_frame(self.adopt(frame))

    def _encode_frame(self, frame) -> List[StripeOutput]:
        """:meth:`encode_frame` of a frame already handed over."""
        staged = self._frame_input(frame)
        paint_candidate = self._paint_candidates()
        if self.entropy == "host":
            return self._encode_frame_host(staged, paint_candidate)
        with self.stream_context():
            packed, yq, cbq, crq = self._step(
                staged, self._prev, self._recip_y,
                self._recip_c, self._qsel(paint_candidate),
                self._wm_scaled, self._alpha_inv)
            mw = META_WORDS_PER_STRIPE * self.n_stripes
            head_np = packed[:mw].cpu().numpy()
        nbytes_np, base_np, ovf_np, damage_np = split_meta(
            head_np, self.n_stripes)
        emit, is_paint = self._decide_emits(
            damage_np > self.damage_threshold, paint_candidate)
        scans: List[bytes] = [b""] * self.n_stripes
        if emit.any():
            total = self.total_packed_words(base_np, nbytes_np)
            bucket = self._packer.bucket_words(total)
            with self.stream_context():
                words_np = packed[mw:mw + bucket].cpu().numpy()
            scans = self._scans_from_packed(
                words_np, base_np, nbytes_np, ovf_np, emit, yq, cbq, crq)
        return self._assemble(emit, is_paint, scans)

    def _encode_frame_host(self, staged: torch.Tensor,
                           paint_candidate: np.ndarray) -> List[StripeOutput]:
        """The host rung: the device step without the packer, one fetch of
        the coefficient planes and damage, native coding of each emitted
        stripe."""
        with self.stream_context():
            yq, cbq, crq, damage, new_prev = encode_body(
                staged, self._prev, self._recip_y,
                self._recip_c, self._qsel(paint_candidate),
                stripe_h=self.stripe_h, wm_scaled=self._wm_scaled,
                alpha_inv=self._alpha_inv)
            self._prev.copy_(new_prev)
            yq, cbq, crq, damage = (t.cpu().numpy()
                                    for t in (yq, cbq, crq, damage))
        self.d2h_fetch_bytes_total += sum(
            a.nbytes for a in (yq, cbq, crq, damage))
        emit, is_paint = self._decide_emits(
            damage > self.damage_threshold, paint_candidate)
        yrows, crows = self.stripe_h // 8, self.stripe_h // 16
        t0 = time.perf_counter()
        scans = [
            _entropy_encode_420(yq[s * yrows:(s + 1) * yrows],
                                cbq[s * crows:(s + 1) * crows],
                                crq[s * crows:(s + 1) * crows])
            if emit[s] else b""
            for s in range(self.n_stripes)
        ]
        self.host_entropy_ms_total += (time.perf_counter() - t0) * 1000.0
        return self._assemble(emit, is_paint, scans)

    def force_keyframe(self) -> None:
        """Make the next frame emit every stripe (client (re)connect)."""
        self._first_frame = True
        self._static_frames[:] = 0
        self._painted[:] = False

