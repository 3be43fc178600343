"""H.264 Constrained-Baseline encoder of the ``x264enc-striped`` and
``x264enc`` profiles (counterpart of ``selkies_tpu/encoder/h264.py``).

Each horizontal stripe is an independent H.264 sequence with its own
SPS/PPS/IDR chain, so the client runs one decoder per stripe and only
damaged stripes are encoded and shipped. ``fullframe=True`` is the
``x264enc`` profile: one stripe covering the whole frame, which the server
ships as 0x00 full-frame packets.

Split of work:
  * device (``h264_device.py``): color/4:2:0, the motion-search kernel,
    transforms, quant, the decoder-exact reconstruction and, for P frames,
    either the CAVLC pack (``device_cavlc.py``, ``entropy="device"``) or
    the block-sparse pack of the levels (``entropy="host"``);
  * host (``native/cavlc.cpp``): CAVLC for IDR pictures, for P stripes
    whose device pack overflowed and, with ``entropy="host"``, for every
    emitted P stripe; the stripes of one frame are coded in a small thread
    pool (the ctypes call releases the GIL);
  * here: stripe/GOP orchestration, damage gating, paint-over (low-QP P
    frames), SPS/PPS, slice-header glue and the reference-plane state.

Every device call runs on the encoder's one CUDA stream (``stream``). The
fetch of a frame's head is a ``non_blocking`` copy into pinned memory with
an event that :meth:`H264StripeEncoder.harvest` waits on.
:meth:`H264StripeEncoder.dispatch_batch` encodes B frames in one batched
step (``h264_device.encode_frame_p_batch_*``); its frames share one read
of their heads and keep no full buffer, so a frame whose bytes pass the
batch's pinned prefix is coded from its exact levels.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .._device import adopt_frame, encoder_stream, resolve_device
from ..native import cavlc_lib
from . import device_cavlc as dcav
from . import h264_device as dev
from .staging import HostCopy

logger = logging.getLogger("selkies_tpu_torch.encoder.h264")

MB = 16
#: the host tier ships at most 1/CAP_FRAC of a stripe's cells before the
#: stripe overflows to its exact levels (the JAX encoder's default)
CAP_FRAC = 8

_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _entropy_pool() -> concurrent.futures.ThreadPoolExecutor:
    """Shared thread pool for the host coding of one frame's stripes (the
    C coder releases the GIL, so they run concurrently)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4),
                thread_name_prefix="cavlc")
        return _POOL


# ---------------------------------------------------------------------------
# SPS / PPS


class _BitWriter:
    def __init__(self) -> None:
        self.bits: List[int] = []

    def u(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def ue(self, v: int) -> None:
        vp1 = v + 1
        n = vp1.bit_length() - 1
        self.u(0, n)
        self.u(vp1, n + 1)

    def se(self, v: int) -> None:
        self.ue(-2 * v if v <= 0 else 2 * v - 1)

    def rbsp(self) -> bytes:
        bits = self.bits + [1]
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        # emulation prevention
        esc = bytearray()
        zeros = 0
        for b in out:
            if zeros >= 2 and b <= 3:
                esc.append(3)
                zeros = 0
            esc.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(esc)


def _nal(nal_type: int, rbsp: bytes, ref_idc: int = 3) -> bytes:
    return b"\x00\x00\x00\x01" + bytes(((ref_idc << 5) | nal_type,)) + rbsp


def make_sps(width: int, height: int, *, coded_height: Optional[int] = None,
             level_idc: int = 40, full_range: bool = True) -> bytes:
    """Constrained-Baseline SPS for a (possibly cropped) 4:2:0 frame.

    ``coded_height`` (a MB multiple >= height) must match the rows the
    slices code: a partial last stripe still codes full ``stripe_h`` rows,
    and an SPS declaring fewer MB rows is an invalid bitstream."""
    mb_w = (width + 15) // 16
    mb_h = ((coded_height or height) + 15) // 16
    crop_r = (mb_w * 16 - width) // 2
    crop_b = (mb_h * 16 - height) // 2
    bw = _BitWriter()
    bw.u(66, 8)          # profile_idc: Baseline
    bw.u(0b11000000, 8)  # constraint_set0+1 (constrained baseline)
    bw.u(level_idc, 8)
    bw.ue(0)             # sps id
    bw.ue(0)             # log2_max_frame_num_minus4 -> 4-bit frame_num
    bw.ue(2)             # pic_order_cnt_type
    bw.ue(1)             # max_num_ref_frames
    bw.u(0, 1)           # gaps_in_frame_num_value_allowed
    bw.ue(mb_w - 1)
    bw.ue(mb_h - 1)
    bw.u(1, 1)           # frame_mbs_only
    bw.u(1, 1)           # direct_8x8_inference
    if crop_r or crop_b:
        bw.u(1, 1)
        bw.ue(0)
        bw.ue(crop_r)
        bw.ue(0)
        bw.ue(crop_b)
    else:
        bw.u(0, 1)
    # VUI: BT.601 + range so the browser matches the color matrix
    bw.u(1, 1)           # vui_parameters_present
    bw.u(0, 1)           # aspect_ratio_info_present
    bw.u(0, 1)           # overscan_info_present
    bw.u(1, 1)           # video_signal_type_present
    bw.u(5, 3)           # video_format: unspecified
    bw.u(1 if full_range else 0, 1)
    bw.u(1, 1)           # colour_description_present
    bw.u(6, 8)           # primaries: SMPTE 170M
    bw.u(6, 8)           # transfer
    bw.u(6, 8)           # matrix: BT.601
    bw.u(0, 1)           # chroma_loc_info_present
    bw.u(0, 1)           # timing_info_present
    bw.u(0, 1)           # nal_hrd
    bw.u(0, 1)           # vcl_hrd
    bw.u(0, 1)           # pic_struct_present
    bw.u(0, 1)           # bitstream_restriction
    return _nal(7, bw.rbsp())


def make_pps() -> bytes:
    bw = _BitWriter()
    bw.ue(0)     # pps id
    bw.ue(0)     # sps id
    bw.u(0, 1)   # entropy_coding_mode: CAVLC
    bw.u(0, 1)   # bottom_field_pic_order_in_frame_present
    bw.ue(0)     # num_slice_groups_minus1
    bw.ue(0)     # num_ref_idx_l0_default_active_minus1
    bw.ue(0)     # num_ref_idx_l1_default_active_minus1
    bw.u(0, 1)   # weighted_pred
    bw.u(0, 2)   # weighted_bipred_idc
    bw.se(0)     # pic_init_qp_minus26 (slice writer assumes 26)
    bw.se(0)     # pic_init_qs_minus26
    bw.se(0)     # chroma_qp_index_offset (qpc_for assumes 0)
    bw.u(1, 1)   # deblocking_filter_control_present (slices disable it)
    bw.u(0, 1)   # constrained_intra_pred
    bw.u(0, 1)   # redundant_pic_cnt_present
    return _nal(8, bw.rbsp())


# ---------------------------------------------------------------------------
# host entropy


def encode_picture_nals_np(mv, luma, luma_dc, chroma_dc, chroma_ac, *,
                           is_idr: bool, mb_w: int, mb_h: int, qp: int,
                           frame_num: int, idr_pic_id: int = 0) -> bytes:
    """The native CAVLC coder over host-resident level arrays (one
    picture: every MB its own slice for IDR, one slice for P; deblocking
    disabled)."""
    lib = cavlc_lib()
    cap = 1 << 22
    buf = np.empty(cap, np.uint8)
    n = lib.h264_encode_picture(
        1 if is_idr else 0, mb_w, mb_h, qp, frame_num & 0xF, idr_pic_id,
        np.ascontiguousarray(mv, np.int32),
        np.ascontiguousarray(luma, np.int32),
        np.ascontiguousarray(luma_dc, np.int32),
        np.ascontiguousarray(chroma_dc, np.int32),
        np.ascontiguousarray(chroma_ac, np.int32),
        buf, cap, 0)
    if n < 0:
        raise RuntimeError("CAVLC output exceeded capacity")
    return bytes(buf[:n])


# ---------------------------------------------------------------------------
# stripe orchestration


@dataclass
class H264Stripe:
    y_start: int
    width: int          # coded (cropped) width
    height: int         # coded (cropped) height of this stripe
    annexb: bytes
    is_key: bool


@dataclass
class _StripeState:
    y0: int             # luma row offset (unpadded coordinates)
    h: int              # unpadded stripe height (the last may be short)
    frame_num: int = 0
    idr_pic_id: int = 0
    need_idr: bool = True
    static_frames: int = 0
    painted_over: bool = False


@dataclass
class _H264Pending:
    """One dispatched frame."""

    fetch: Optional[HostCopy]   # head (P) or flat16 (IDR) copy, if started
    flat16: Optional[torch.Tensor]       # exact levels on the device
    is_idr: bool
    paint: np.ndarray
    qp: np.ndarray
    buf: Optional[torch.Tensor] = None   # full device buffer (P): CAVLC
                                         # payloads or the sparse levels
    head: Optional[torch.Tensor] = None  # its fetch prefix (P)
    #: a frame of a batched dispatch keeps no full buffer: the batch's
    #: [B, prefix] heads and [B, S, words] exact levels, its row in them,
    #: and one host copy of the heads shared by the batch's frames
    batch_heads: Optional[torch.Tensor] = None
    batch_flat16: Optional[torch.Tensor] = None
    batch_index: int = 0
    batch_cache: Optional[dict] = None


class H264StripeEncoder:
    """Striped (or full-frame) H.264 encoder with damage gating.

    ``fullframe=True`` is the ``x264enc`` profile: one stripe of the whole
    (16-row padded) frame; the 0x00 wire routing is the adapter's
    ``wire_fullframe`` flag, not this class's. ``entropy`` picks the P-frame
    tier: ``"device"`` packs bit-exact CAVLC payloads on the device,
    ``"host"`` ships the block-sparse levels and codes them with the
    native coder; ``None`` reads ``SELKIES_TPU_H264_ENTROPY`` (default
    ``device``). Both give the same bytes.

    ``device=None`` runs on the card (and raises without one); the tests
    pass ``device="cpu"``, where the motion-search wrapper takes its plain
    PyTorch version."""

    def __init__(self, width: int, height: int, *, stripe_height: int = 64,
                 qp: int = 26, paint_over_qp: int = 18,
                 paint_over_trigger_frames: int = 15, search: int = 12,
                 fullframe: bool = False, entropy: Optional[str] = None,
                 device=None) -> None:
        if width % 2 or height % 2:
            raise ValueError("frame dimensions must be even")
        if stripe_height % MB:
            raise ValueError("stripe_height must be a multiple of 16")
        self.device = resolve_device(device)
        self.width = width
        self.height = height
        self.qp = int(np.clip(qp, 0, 51))
        self.paint_over_qp = int(np.clip(paint_over_qp, 0, 51))
        self.paint_over_trigger = paint_over_trigger_frames
        self.search = search
        self.pad_w = (width + MB - 1) // MB * MB
        sh = height if fullframe else stripe_height
        sh = (sh + MB - 1) // MB * MB
        self.stripe_h = sh
        self.stripes: List[_StripeState] = []
        y = 0
        while y < height:
            h = min(sh, height - y)
            self.stripes.append(_StripeState(y0=y, h=h))
            y += h
        #: uniform stripe grid: the padded height is S x stripe_h, so the
        #: whole frame encodes in one step over the stripe axis
        self.n_stripes = len(self.stripes)
        self.pad_h = self.n_stripes * sh
        self._sps_pps: Dict[int, bytes] = {}
        #: the stream every device call of this encoder runs on (the async
        #: driver dispatches from its own thread, and PyTorch's current
        #: stream is per thread): the card's one encoder stream, shared by
        #: every encoder on it so their freed memory is reused
        self.stream = encoder_stream(self.device)

        with self.stream_context():
            u8 = dict(dtype=torch.uint8, device=self.device)
            self._prev_y = torch.zeros((self.pad_h, self.pad_w), **u8)
            self._prev_cb = torch.zeros((self.pad_h // 2, self.pad_w // 2),
                                        **u8)
            self._prev_cr = torch.zeros_like(self._prev_cb)
            self._ref_y = torch.zeros_like(self._prev_y)
            self._ref_cb = torch.zeros_like(self._prev_cb)
            self._ref_cr = torch.zeros_like(self._prev_cr)

        n = (sh // MB) * (self.pad_w // MB)
        self._shapes = [((n, 2), 2 * n), ((n, 16, 4, 4), 256 * n),
                        ((n, 4, 4), 16 * n), ((n, 2, 2, 2), 8 * n),
                        ((n, 2, 4, 4, 4), 128 * n)]
        self._stripe_words = sum(s for _, s in self._shapes)
        #: block-sparse geometry of the host tier (dev._pack_sparse)
        self._pad_words, self._n_cells, self._cap_cells = \
            dev.sparse_geometry(self._stripe_words, CAP_FRAC)

        if entropy is None:
            entropy = os.environ.get("SELKIES_TPU_H264_ENTROPY", "device")
        if entropy not in ("device", "host"):
            raise ValueError(f"entropy must be device|host, got {entropy!r}")
        self.entropy = entropy
        #: transfer geometry: a fixed head, then the content. Two fetch
        #: tiers: static content ships the small prefix, busy content the
        #: sized one; an undershoot re-reads.
        if entropy == "device":
            # the head, then the CAVLC payloads (~pixels/80: full-damage
            # 1080p scroll runs ~12.7 KB of bitstream per frame)
            self._cavlc_msb = dcav.default_max_stripe_bytes(
                self.pad_w // MB, sh // MB)
            self._fixed_bytes = dcav.HEAD_BYTES * self.n_stripes
            self._buf_bytes = self._fixed_bytes \
                + self.n_stripes * self._cavlc_msb
            self._guess_bytes = self._bucket(self._fixed_bytes + (16 << 10))
            self._prefix_large = self._bucket(
                self._fixed_bytes
                + max(24 << 10, self.pad_h * self.pad_w // 80))
        else:
            # the head and cell bitmaps, then the nonzero cells
            # (full-damage content runs ~pixels/20 in cells)
            self._cavlc_msb = 0
            self._fixed_bytes = 4 * self.n_stripes \
                + self.n_stripes * (self._n_cells // 8)
            self._buf_bytes = self._fixed_bytes \
                + self.n_stripes * self._cap_cells * dev.CELL
            self._guess_bytes = self._bucket(self._fixed_bytes + (64 << 10))
            self._prefix_large = self._bucket(
                self._fixed_bytes
                + max(96 << 10, self.pad_h * self.pad_w // 20))
        self._prefix_small = self._bucket(self._fixed_bytes + 4096)

        #: host entropy wall time, and the D2H bytes of the fetches made by
        #: harvest itself (not a pipeline's) and of the re-reads
        self.host_entropy_ms_total = 0.0
        self.d2h_fetch_bytes_total = 0
        self.d2h_refetch_bytes_total = 0
        #: P stripes coded on the host because their device pack overflowed
        self.host_coded_stripes_total = 0
        #: stripes whose entropy coding failed and forced an IDR resync
        self.entropy_errors_total = 0

    # -- device plumbing ---------------------------------------------------

    def stream_context(self):
        """Context that makes this encoder's stream current (no-op on CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Small per-frame host array to the device: through pinned memory
        with a non-blocking copy (a pageable copy would wait for every frame
        already queued on the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """Blocking read on the encoder's stream (the rare re-reads)."""
        with self.stream_context():
            return t.cpu().numpy()

    def _choose_prefix(self) -> int:
        """The small head for quiet content, the sized one otherwise, from
        the estimate harvest keeps (~1.5x the last frame's bytes)."""
        if self._guess_bytes <= self._prefix_small:
            return self._prefix_small
        return self._prefix_large

    def _bucket(self, nbytes: int) -> int:
        """Power-of-two fetch prefix, at most the whole buffer."""
        n = 4096
        while n < nbytes:
            n <<= 1
        return min(n, self._buf_bytes)

    def _sps_pps_for(self, st: _StripeState) -> bytes:
        key = st.h
        if key not in self._sps_pps:
            self._sps_pps[key] = (
                make_sps(self.width, st.h, coded_height=self.stripe_h)
                + make_pps())
        return self._sps_pps[key]

    # -- encode ------------------------------------------------------------

    def dispatch(self, rgb, fetch: bool = True) -> _H264Pending:
        """One device step for the whole frame (every stripe); pair with
        :meth:`harvest`. ``rgb`` is an (H, W, 3) uint8 array or a tensor on
        the encoder's device (handed over here: :meth:`adopt`).
        ``fetch=False`` starts no host copy (the pipeline owns the
        transfer)."""
        return self._dispatch(self.adopt(rgb), fetch)

    def _dispatch(self, rgb, fetch: bool) -> _H264Pending:
        """:meth:`dispatch` of a frame already handed over."""
        rgb = self._input(rgb)            # before any state changes
        is_idr = any(st.need_idr for st in self.stripes)
        if is_idr:
            # optimistic clear so frames dispatched ahead don't re-IDR; an
            # entropy failure at harvest re-arms the flag
            for st in self.stripes:
                st.need_idr = False
        paint = np.zeros(self.n_stripes, np.int8)
        if not is_idr:
            for i, st in enumerate(self.stripes):
                # candidacy from previous frames' history; optimistic mark
                # so frames in flight don't re-trigger (damage clears it)
                if (st.static_frames >= self.paint_over_trigger
                        and not st.painted_over):
                    paint[i] = 1
                    st.painted_over = True

        with self.stream_context():
            if is_idr:
                (flat16, self._prev_y, self._prev_cb, self._prev_cr,
                 self._ref_y, self._ref_cb, self._ref_cr) = \
                    dev.encode_frame_idr_rgb(
                        rgb, self.qp, pad_h=self.pad_h, pad_w=self.pad_w,
                        n_stripes=self.n_stripes, sh=self.stripe_h)
                buf = head = None
                fetch_arr = flat16
            elif self.entropy == "host":
                (buf, head, flat16, self._prev_y, self._prev_cb,
                 self._prev_cr, self._ref_y, self._ref_cb, self._ref_cr) = \
                    dev.encode_frame_p_rgb(
                        rgb, self._prev_y, self._prev_cb, self._prev_cr,
                        self._ref_y, self._ref_cb, self._ref_cr,
                        self._upload(paint.astype(np.int32)),
                        self.qp, self.paint_over_qp,
                        pad_h=self.pad_h, pad_w=self.pad_w,
                        n_stripes=self.n_stripes, sh=self.stripe_h,
                        search=self.search, cap_frac=CAP_FRAC,
                        prefix=self._choose_prefix())
                fetch_arr = head
            else:
                (buf, head, flat16, self._prev_y, self._prev_cb,
                 self._prev_cr, self._ref_y, self._ref_cb, self._ref_cr) = \
                    dev.encode_frame_p_cavlc_rgb(
                        rgb, self._prev_y, self._prev_cb, self._prev_cr,
                        self._ref_y, self._ref_cb, self._ref_cr,
                        self._upload(paint.astype(np.int32)),
                        self.qp, self.paint_over_qp,
                        pad_h=self.pad_h, pad_w=self.pad_w,
                        n_stripes=self.n_stripes, sh=self.stripe_h,
                        search=self.search,
                        max_stripe_bytes=self._cavlc_msb,
                        prefix=self._choose_prefix())
                fetch_arr = head
            copy = HostCopy(fetch_arr, self.stream) if fetch else None
        qp_arr = np.where(paint != 0, self.paint_over_qp, self.qp)
        return _H264Pending(fetch=copy, flat16=flat16, is_idr=is_idr,
                            paint=paint, qp=qp_arr, buf=buf, head=head)

    def dispatch_batch(self, rgbs, fetch: bool = True
                       ) -> List[_H264Pending]:
        """Encode B sequential frames in one batched device step; pair
        each pending with :meth:`harvest`, in order. ``rgbs`` is a (B, H,
        W, 3) uint8 array or a tensor on the encoder's device.

        The batch's fetch prefix is pinned when it is dispatched, and
        paint-over is forecast per frame of the batch (harvest has not yet
        advanced the history of frames inside it), so a stripe crossing
        the trigger mid-batch paints at the right frame. While any stripe
        needs an IDR the frames go through :meth:`dispatch` one by one.
        ``fetch=False`` starts no host copy (the pipeline owns it). A
        tensor is handed over here (:meth:`adopt`)."""
        return self._dispatch_batch(self.adopt(rgbs), fetch)

    def _dispatch_batch(self, rgbs, fetch: bool) -> List[_H264Pending]:
        """:meth:`dispatch_batch` of a batch already handed over."""
        B = int(rgbs.shape[0])
        rgbs = self._input(rgbs)          # before any state changes
        if any(st.need_idr for st in self.stripes):
            return [self._dispatch(rgbs[b], fetch) for b in range(B)]
        paints = np.zeros((B, self.n_stripes), np.int8)
        for b in range(B):
            for i, st in enumerate(self.stripes):
                # if damage lands mid-batch instead, that frame emits at
                # the paint QP (more quality, never a stale stripe)
                if (st.static_frames + b >= self.paint_over_trigger
                        and not st.painted_over):
                    paints[b, i] = 1
                    st.painted_over = True
        qps = np.where(paints != 0, self.paint_over_qp, self.qp)
        prefix = self._choose_prefix()
        kw = dict(pad_h=self.pad_h, pad_w=self.pad_w,
                  n_stripes=self.n_stripes, sh=self.stripe_h,
                  search=self.search, prefix=prefix)
        if self.entropy == "host":
            step = dev.encode_frame_p_batch_rgb
            kw["cap_frac"] = CAP_FRAC
        else:
            step = dev.encode_frame_p_batch_cavlc_rgb
            kw["max_stripe_bytes"] = self._cavlc_msb
        with self.stream_context():
            (heads, flat16s, self._prev_y, self._prev_cb, self._prev_cr,
             self._ref_y, self._ref_cb, self._ref_cr) = step(
                rgbs, self._prev_y, self._prev_cb,
                self._prev_cr, self._ref_y, self._ref_cb, self._ref_cr,
                self._upload(paints.astype(np.int32)),
                self._upload(np.full(B, self.qp, np.int32)),
                self.paint_over_qp, **kw)
            cache = {"copy": HostCopy(heads, self.stream) if fetch
                     else None}
        return [_H264Pending(fetch=None, flat16=None, is_idr=False,
                             paint=paints[b], qp=qps[b], batch_heads=heads,
                             batch_flat16=flat16s, batch_index=b,
                             batch_cache=cache) for b in range(B)]

    def _input(self, rgb) -> torch.Tensor:
        """A frame (or a stacked batch) on the device: a tensor (already
        handed over) as it is, a host array uploaded on the encoder's
        stream."""
        if isinstance(rgb, torch.Tensor):
            return rgb
        with self.stream_context():
            return self._upload(np.asarray(rgb, dtype=np.uint8))

    def adopt(self, frame):
        """Hand over a uint8 RGB frame tensor (or a stacked batch) that a
        caller made on the encoder's device (``_device.adopt_frame``), in
        the caller's thread; a host array passes as it is. Every public
        entry point of the encoders, pipelines and drivers calls it once,
        where the frame leaves its caller."""
        if not isinstance(frame, torch.Tensor):
            return frame
        return adopt_frame(frame, self.device, self.stream)

    def _batch_host(self, p: _H264Pending) -> np.ndarray:
        """Frame ``p``'s head from the batch's one host copy of its heads
        (read once, by the first of its frames to be harvested)."""
        cache = p.batch_cache
        if cache.get("host") is None:
            copy = cache.get("copy")
            cache["host"] = copy.numpy() if copy is not None \
                else self._to_host(p.batch_heads)
            self.d2h_fetch_bytes_total += cache["host"].nbytes
        return cache["host"][p.batch_index]

    def _recover_undershoot(self, p: _H264Pending, host, needed: int,
                            ovf, damage):
        """A fetch prefix that missed the frame's bytes. A single-frame
        dispatch re-reads the right bucket of its full device buffer. A
        batched one keeps no full buffer: every emitting stripe then takes
        its exact levels (returned in ``ovf``), and an undershoot at the
        large prefix grows it. Either way the estimate is re-tiered."""
        if needed > len(host):
            if p.buf is not None:
                host = self._to_host(p.buf[:self._bucket(needed)])
                self.d2h_refetch_bytes_total += host.nbytes
            else:
                ovf = ovf | damage | (p.paint != 0)
                if len(host) >= self._prefix_large:
                    self._prefix_large = min(
                        self._buf_bytes, self._bucket(needed + needed // 2))
        self._guess_bytes = self._bucket(
            max(needed + needed // 2, self._fixed_bytes + 4096))
        return host, ovf

    def _refetch_overflow_rows(self, p: _H264Pending, damage, ovf):
        """Exact flat16 rows of the emitting stripes whose device pack
        overflowed (rare: |level| beyond the escape range, a stripe past
        its byte or cell budget, or a batched frame's undershoot). More
        than two rows read the whole frame's levels at once."""
        if p.flat16 is None:
            p.flat16 = p.batch_flat16[p.batch_index]
        need = [i for i in range(self.n_stripes)
                if ovf[i] and (damage[i] or p.paint[i])]
        if not need:
            return {}
        rows = self._to_host(p.flat16 if len(need) > 2 else p.flat16[need])
        self.d2h_refetch_bytes_total += rows.nbytes
        if len(need) > 2:
            return {i: rows[i] for i in need}
        return dict(zip(need, rows))

    def _sparse_row(self, host: np.ndarray, bitmap: np.ndarray, start: int,
                    used: int) -> np.ndarray:
        """One stripe's dense level row from its cell bitmap and its
        compacted nonzero cells."""
        bits = np.unpackbits(bitmap, bitorder="little")
        idx = np.flatnonzero(bits[:self._n_cells])
        cells = host[start:start + used].view(np.int8).astype(np.int32) \
            .reshape(-1, dev.CELL)
        dense = np.zeros(self._pad_words, np.int32)
        dense.reshape(-1, dev.CELL)[idx[:len(cells)]] = cells
        return dense[:self._stripe_words]

    def harvest(self, p: _H264Pending,
                host: Optional[np.ndarray] = None) -> List[H264Stripe]:
        """Entropy-finish one dispatched frame. Must be called in dispatch
        order. ``host`` supplies the fetched bytes when a pipeline owns the
        transfer."""
        if host is None and p.batch_heads is not None:
            host = self._batch_host(p)
        elif host is None:
            host = p.fetch.numpy() if p.fetch is not None else \
                self._to_host(p.flat16 if p.is_idr else p.head)
            self.d2h_fetch_bytes_total += host.nbytes
        S = self.n_stripes
        if p.is_idr:
            levels16 = host
            damage = np.ones(S, bool)
            refetch = {}
        elif self.entropy == "device":
            t_bits, base_words, damage, ovf = dcav.parse_cavlc_head(host, S)
            # mirror the device's per-stripe word clip: an overflowing
            # stripe records its unclipped t_bits but compacts at most V
            # words
            wc = np.minimum((t_bits + 31) // 32, self._cavlc_msb // 4)
            needed = self._fixed_bytes + 4 * int(base_words[-1] + wc[-1])
            host, ovf = self._recover_undershoot(p, host, needed, ovf,
                                                 damage)
            refetch = self._refetch_overflow_rows(p, damage, ovf)
        else:
            head = host[:4 * S].reshape(S, 4)
            # the head keeps the cell count's low 16 bits; a count past the
            # cap (wrapped or not) comes with the overflow flag
            counts = head[:, 0].astype(np.int64) \
                + (head[:, 1].astype(np.int64) << 8)
            damage = head[:, 2] != 0
            ovf = head[:, 3] != 0
            used = np.minimum(counts, self._cap_cells) * dev.CELL
            needed = self._fixed_bytes + int(used.sum())
            host, ovf = self._recover_undershoot(p, host, needed, ovf,
                                                 damage)
            bitmaps = host[4 * S:self._fixed_bytes] \
                .reshape(S, self._n_cells // 8)
            starts = np.concatenate(
                [[0], np.cumsum(used)[:-1]]) + self._fixed_bytes
            refetch = self._refetch_overflow_rows(p, damage, ovf)

        mb_w = self.pad_w // MB
        mb_h = self.stripe_h // MB
        jobs: List[tuple] = []
        for i, st in enumerate(self.stripes):
            if p.is_idr:
                emit, is_key = True, True
                st.static_frames = 0
                st.painted_over = False
            elif damage[i]:
                emit, is_key = True, False
                st.static_frames = 0
                st.painted_over = False
            elif p.paint[i]:
                emit, is_key = True, False
                st.static_frames += 1
            else:
                emit = False
                st.static_frames += 1
            if not emit:
                continue
            if p.is_idr:
                row = levels16[i].astype(np.int32)
            elif i in refetch:
                self.host_coded_stripes_total += 1
                row = refetch[i].astype(np.int32)
            elif self.entropy == "device":
                # the device coded this stripe: header/escape glue only
                jobs.append((i, st, is_key, int(p.qp[i]),
                             dcav.payload_slice(host, S, base_words,
                                                t_bits, i)))
                continue
            else:
                row = self._sparse_row(host, bitmaps[i], int(starts[i]),
                                       int(used[i]))
            parts, pos = [], 0
            for shape, size in self._shapes:
                parts.append(row[pos:pos + size].reshape(shape))
                pos += size
            jobs.append((i, st, is_key, int(p.qp[i]), tuple(parts)))

        def run_one(job):
            i, st, is_key, qp, work = job
            if len(work) == 2:                     # (payload, nbits)
                return dcav.assemble_p_slice(work[0], work[1], qp,
                                             st.frame_num)
            nals = encode_picture_nals_np(
                *work, is_idr=is_key, mb_w=mb_w, mb_h=mb_h, qp=qp,
                frame_num=0 if is_key else st.frame_num,
                idr_pic_id=st.idr_pic_id)
            return self._sps_pps_for(st) + nals if is_key else nals

        def safe_one(job):
            try:
                return run_one(job)
            except Exception as exc:     # surfaced per stripe below
                return exc

        t0 = time.perf_counter()
        if len(jobs) > 1:
            payloads = list(_entropy_pool().map(safe_one, jobs))
        else:
            payloads = [safe_one(job) for job in jobs]
        self.host_entropy_ms_total += (time.perf_counter() - t0) * 1000.0

        out: List[H264Stripe] = []
        for job, payload in zip(jobs, payloads):
            i, st, is_key, qp, _ = job
            if isinstance(payload, Exception):
                # the device reference already advanced to a reconstruction
                # the decoder will never see: resynchronize with an IDR
                # instead of drifting every following P frame
                self.entropy_errors_total += 1
                logger.error("entropy coding failed for stripe %d; "
                             "forcing IDR resync", i, exc_info=payload)
                st.need_idr = True
                continue
            if is_key:
                st.frame_num = 1
                st.idr_pic_id = (st.idr_pic_id + 1) % 16
                st.need_idr = False
            else:
                st.frame_num = (st.frame_num + 1) % 16
            out.append(H264Stripe(y_start=st.y0, width=self.width,
                                  height=st.h, annexb=payload,
                                  is_key=is_key))
        return out

    def encode_frame(self, rgb) -> List[H264Stripe]:
        """RGB (H, W, 3) uint8 -> encoded stripes (damaged/paint-over)."""
        return self._encode_frame(self.adopt(rgb))

    def _encode_frame(self, rgb) -> List[H264Stripe]:
        """:meth:`encode_frame` of a frame already handed over."""
        return self.harvest(self._dispatch(rgb, True))

    def request_keyframe(self) -> None:
        """Force IDR on every stripe (client join / pipeline reset)."""
        for st in self.stripes:
            st.need_idr = True

    def stripe_ref(self, i: int):
        """Host copies of stripe i's reference planes (conformance oracle)."""
        sh = self.stripe_h
        return (self._to_host(self._ref_y[i * sh:(i + 1) * sh]),
                self._to_host(self._ref_cb[i * sh // 2:(i + 1) * sh // 2]),
                self._to_host(self._ref_cr[i * sh // 2:(i + 1) * sh // 2]))
