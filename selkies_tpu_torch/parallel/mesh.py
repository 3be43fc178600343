"""Device meshes and the multi-session JPEG lane (counterpart of
``selkies_tpu/parallel/mesh.py``).

The JAX package runs N sessions as one SPMD program over a ("session",
"stripe") ``jax.sharding.Mesh``: ``vmap`` over the sessions, ``shard_map``
over the chips, and a ``psum`` for the rate feedback. Here a lane runs on
one card. The session axis folds into the frame's rows (``[N*H, W]``
planes): every stage of the step is per pixel, per block or per stripe,
and no block or stripe crosses a session's rows, so one launch of each
kernel carries every session and each session's bytes are what it would
get alone. What is per session — the heads, the buffer bases and the rate
feedback (the ``psum``, here a sum over the session axis) — is computed
per session.

:class:`Mesh` is a ("session", "stripe") grid of ``torch.device``\\ s.
The lane encoders take a mesh of one card; a session axis or a stripe
axis over several cards (split-frame encoding) is not ported (ROADMAP
Queue 1, item 2) and raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import adopt_frame, encoder_stream, resolve_device
from ..encoder.staging import HostCopy, SlotUploads

#: pinned host batches a lane's uploads take turns in: the scheduler's
#: in-flight window (2) plus the tick being built
UPLOAD_DEPTH = 3

#: sessions per Huffman packer call of the JPEG lane: the packer's slot
#: grids grow with the stripes packed at once (about 1.5 GB per 1080p
#: session), so a lane packs in chunks of this many sessions, as the
#: H.264 lane does per ``h264_device.PACK_FRAMES``
PACK_SESSIONS = 4


class Mesh:
    """A ("session", "stripe") grid of torch devices (the counterpart of
    ``jax.sharding.Mesh`` with those axis names)."""

    axis_names = ("session", "stripe")

    def __init__(self, devices) -> None:
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        self.devices = arr
        self.shape = {"session": arr.shape[0], "stripe": arr.shape[1]}


def _default_devices() -> List[torch.device]:
    """Every CUDA card; without one, raise (``_device.resolve_device``)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(devices, rows: int, cols: int) -> Mesh:
    flat = list(devices)[:rows * cols]
    return Mesh([flat[r * cols:(r + 1) * cols] for r in range(rows)])


def make_mesh(devices=None, stripe_axis: Optional[int] = None) -> Mesh:
    """Build a ("session", "stripe") mesh over the given (or all) devices.

    ``stripe_axis`` defaults to 2 when the device count is even so both mesh
    axes are exercised, else 1 (pure session parallelism).
    """
    if devices is None:
        devices = _default_devices()
    n = len(devices)
    if stripe_axis is None:
        stripe_axis = 2 if (n % 2 == 0 and n > 1) else 1
    if n % stripe_axis:
        raise ValueError(f"{n} devices not divisible by stripe_axis={stripe_axis}")
    return _grid(devices, n // stripe_axis, stripe_axis)


def parse_mesh_spec(spec: str, devices=None) -> Mesh:
    """Build a mesh from the ``tpu_mesh`` setting, e.g. ``"session:1"`` or
    ``"session:4,stripe:2"``. Axis sizes must multiply to ≤ the available
    device count; missing axes default to 1."""
    if devices is None:
        devices = _default_devices()
    sizes = {"session": 1, "stripe": 1}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, num = part.partition(":")
        name = name.strip()
        if name not in sizes:
            raise ValueError(f"unknown mesh axis {name!r} (session|stripe)")
        sizes[name] = int(num)
    total = sizes["session"] * sizes["stripe"]
    if total < 1 or total > len(devices):
        raise ValueError(
            f"mesh {spec!r} needs {total} devices; {len(devices)} available")
    return _grid(devices, sizes["session"], sizes["stripe"])


def lane_device(mesh: Mesh) -> torch.device:
    """The one card a lane runs on. A mesh over several devices — a session
    axis across cards, or a stripe axis (split-frame encoding) — is not
    ported: it raises, naming the ROADMAP item, and never runs one shard
    quietly."""
    if mesh.shape["stripe"] > 1:
        raise NotImplementedError(
            f"a stripe axis of {mesh.shape['stripe']} (split-frame "
            "encoding across cards) is not ported: ROADMAP Queue 1, item 2")
    if mesh.shape["session"] > 1:
        raise NotImplementedError(
            f"a session axis of {mesh.shape['session']} cards is not "
            "ported (lanes run on one card): ROADMAP Queue 1, item 2")
    return resolve_device(mesh.devices[0, 0])


def fetch_prefix(copy: HostCopy) -> Tuple[np.ndarray, Dict[int, float]]:
    """Materialize a lane's fetched prefix (the counterpart of JAX's
    ``fetch_sharded_prefix``): ``(host, per_shard_ms)``, the host array and
    the milliseconds spent blocked on it, attributed to stripe shard 0 (a
    lane has one)."""
    t0 = time.perf_counter()
    host = copy.numpy()
    return host, {0: (time.perf_counter() - t0) * 1000.0}


def _recip_tables(quality: int, paintover_quality: int):
    """f32 reciprocal quant tables [2, 8, 8] (normal, paint-over) and the
    integer tables the JFIF headers carry."""
    from ..encoder.jpeg import _recip
    from ..ops.quant import quality_scaled_tables

    ly, lc = quality_scaled_tables(quality)
    py, pc = quality_scaled_tables(paintover_quality)
    qy = np.stack([ly, py]).astype(np.float32)
    qc = np.stack([lc, pc]).astype(np.float32)
    return _recip(qy), _recip(qc), (ly, lc), (py, pc)


def make_batched_step(mesh: Mesh, stripe_h: int):
    """The multi-session encode step without entropy coding.

    fn(frames, prev, recip_y, recip_c, qsel) with
      frames/prev [N, H, W, 3] uint8 — ``prev`` is updated in place;
      recip_y/recip_c [nq, 8, 8] f32 — reciprocal quant tables (the JAX
        step takes the tables and computes ``1 / tables`` itself);
      qsel [N, S] int32 — per-session per-stripe table index.
    Returns (yq, cbq, crq, damage, prev, session_bits, total_bits): the
    coefficient planes per session ([N, H/8, W/8, 64], [N, H/16, W/16,
    64]), damage [N, S], per-session nonzero-coefficient counts [N] (the
    rate feedback) and their sum. One DCT+quant launch per call."""
    from ..encoder.jpeg import encode_body_sessions

    lane_device(mesh)

    def step(frames, prev, recip_y, recip_c, qsel):
        n, h, w, _ = frames.shape
        yq, cbq, crq, damage, new_prev = encode_body_sessions(
            frames, prev, recip_y, recip_c, qsel, stripe_h=stripe_h)
        prev.copy_(new_prev.reshape(prev.shape))
        yq = yq.reshape(n, h // 8, w // 8, 64)
        cbq = cbq.reshape(n, h // 16, w // 16, 64)
        crq = crq.reshape(n, h // 16, w // 16, 64)
        nz = ((yq != 0).flatten(1).sum(1) + (cbq != 0).flatten(1).sum(1)
              + (crq != 0).flatten(1).sum(1)).to(torch.int32)
        return yq, cbq, crq, damage, prev, nz, nz.sum()

    return step, (mesh.shape["session"], mesh.shape["stripe"])


def make_batched_entropy_step(mesh: Mesh, pad_h: int, pad_w: int,
                              stripe_h: int, n_sessions: int):
    """The multi-session step carried through device entropy coding: one
    call yields wire-ready packed bitstreams for every session.

    Returns (fn, meta): fn(frames, prev, recip_y, recip_c, qsel) →
      packed [N, mw + 1 + cap_words] int32 — per session: nbytes, base,
          overflow and damage per stripe (``jpeg.split_meta``), the
          session's coded bytes, then its compacted stripe bitstreams
          (row n holds the bit patterns of the JAX lane's uint32 row n);
      prev (updated in place), yq, cbq, crq (folded; kept on the device
          for the rare overflowed stripes);
      session_bytes [N] int32 — coded bytes per session (rate feedback);
      total_bytes [] int32 — their sum.
    meta = (S, mw, cap_words, packer). One DCT+quant launch per call; the
    Huffman pack runs over every ``PACK_SESSIONS`` sessions' stripes
    (each session compacts on its own, so the chunking changes no
    byte)."""
    from ..encoder.device_entropy import DeviceEntropyPacker
    from ..encoder.jpeg import (BLOCK_WORDS, MAX_STRIPE_BYTES,
                                encode_body_sessions)

    dev = lane_device(mesh)
    if pad_h % stripe_h:
        raise ValueError("pad_h must divide into stripe_h bands")
    s = pad_h // stripe_h
    chunk = min(n_sessions, PACK_SESSIONS)
    # one packer per chunk size: full chunks and the remainder
    packers = {c: DeviceEntropyPacker(c * pad_h, pad_w, stripe_h,
                                      block_words=BLOCK_WORDS,
                                      max_stripe_bytes=MAX_STRIPE_BYTES,
                                      device=dev, sessions=c)
               for c in {chunk, n_sessions % chunk} if c}
    mw = 4 * s
    yr, cr = pad_h // 8, pad_h // 16        # block rows per session

    def pack(yq, cbq, crq, n):
        parts = []
        for lo in range(0, n, chunk):
            c = min(chunk, n - lo)
            words, nbytes, base, ovf = packers[c].pack(
                yq[lo * yr:(lo + c) * yr], cbq[lo * cr:(lo + c) * cr],
                crq[lo * cr:(lo + c) * cr])
            parts.append((words.reshape(c, -1), nbytes, base, ovf))
        return tuple(torch.cat(p) for p in zip(*parts))

    def step(frames, prev, recip_y, recip_c, qsel):
        n = frames.shape[0]
        yq, cbq, crq, damage, new_prev = encode_body_sessions(
            frames, prev, recip_y, recip_c, qsel, stripe_h=stripe_h)
        prev.copy_(new_prev.reshape(prev.shape))
        words, nbytes, base, ovf = pack(yq, cbq, crq, n)
        nbytes = nbytes.reshape(n, s)
        session_bytes = nbytes.sum(1).to(torch.int32)
        head = torch.cat([nbytes.to(torch.int32),
                          base.reshape(n, s).to(torch.int32),
                          ovf.reshape(n, s).to(torch.int32),
                          damage.to(torch.int32),
                          session_bytes[:, None]], dim=1)
        packed = torch.cat([head, words.reshape(n, -1)], dim=1)
        return (packed, prev, yq, cbq, crq, session_bytes,
                session_bytes.sum())

    return step, (s, mw, packers[chunk].cap_words, packers[chunk])


class BatchedSessionEncoder:
    """Frame-batched multi-session encoder without entropy coding (the
    step's coefficients and rate feedback): holds the previous frames on
    the device and runs one step per tick."""

    def __init__(
        self,
        mesh: Mesh,
        n_sessions: int,
        width: int,
        height: int,
        stripe_h: int = 64,
        quality: int = 40,
        paintover_quality: int = 90,
    ) -> None:
        self.device = lane_device(mesh)
        if height % stripe_h:
            raise ValueError(
                f"height {height} not divisible by stripe_h {stripe_h}")
        if width % 16:
            raise ValueError("width must be a multiple of 16 (4:2:0 MCUs)")
        self.mesh = mesh
        self.n_sessions = n_sessions
        self.width, self.height, self.stripe_h = width, height, stripe_h
        self.n_stripes = height // stripe_h
        self.stream = encoder_stream(self.device)
        ry, rc, _, _ = _recip_tables(quality, paintover_quality)
        self._step, _ = make_batched_step(mesh, stripe_h)
        with _stream(self.stream):
            self._recip_y = torch.from_numpy(ry).to(self.device)
            self._recip_c = torch.from_numpy(rc).to(self.device)
            self._prev = torch.zeros((n_sessions, height, width, 3),
                                     dtype=torch.uint8, device=self.device)

    def step(self, frames: np.ndarray, qsel: Optional[np.ndarray] = None):
        """Encode one frame per session; returns
        (yq, cbq, crq, damage, session_bits, total_bits)."""
        if qsel is None:
            qsel = np.zeros((self.n_sessions, self.n_stripes), np.int32)
        with _stream(self.stream):
            frames_d = torch.from_numpy(
                np.ascontiguousarray(frames, np.uint8)).to(self.device)
            qsel_d = torch.from_numpy(
                np.asarray(qsel, np.int32)).to(self.device)
            yq, cbq, crq, damage, _, session_bits, total_bits = self._step(
                frames_d, self._prev, self._recip_y, self._recip_c, qsel_d)
        return yq, cbq, crq, damage, session_bits, total_bits


def _stream(stream):
    """Make ``stream`` current (a no-op without one: the CPU)."""
    import contextlib

    return contextlib.nullcontext() if stream is None \
        else torch.cuda.stream(stream)


class LaneFrames:
    """The frame side of a lane encoder, shared by both profiles: the
    per-slot last frame that idle ticks re-present (the JAX lane's
    ``_last_host``, kept here on the device, so an idle slot costs no
    upload), the pinned uploads of new host frames into it, and the
    upload of the small per-tick host arrays."""

    def __init__(self, n_sessions: int, pad_h: int, pad_w: int,
                 device: torch.device, stream) -> None:
        self.n_sessions = n_sessions
        self.pad_h, self.pad_w = pad_h, pad_w
        self.device, self.stream = device, stream
        shape = (n_sessions, pad_h, pad_w, 3)
        with _stream(stream):
            #: last frame submitted per slot (zeroed by reset_session)
            self.last = torch.zeros(shape, dtype=torch.uint8, device=device)
        self._uploads = SlotUploads(shape, UPLOAD_DEPTH, device)

    @property
    def h2d_bytes_total(self) -> int:
        return self._uploads.bytes_total

    def batch(self, frames) -> Tuple[torch.Tensor, np.ndarray]:
        """The device batch [N, pad_h, pad_w, 3] of one tick and the slots
        that re-present their last frame.

        ``frames``: an [N, H, W, 3] host array; a stacked [N, pad_h, pad_w,
        3] uint8 tensor on the lane's device (used as it is, and not kept
        for re-presenting, as the JAX lane does with a device batch); or a
        length-N sequence whose entries are host frames (padded here),
        padded frame tensors on the device, or None (re-present the
        slot's last frame, which damage gating then suppresses)."""
        n_s = self.n_sessions
        reuse_prev = np.zeros(n_s, bool)
        if isinstance(frames, torch.Tensor):
            want = (n_s, self.pad_h, self.pad_w, 3)
            if tuple(frames.shape) != want:
                raise ValueError(f"device batch must be pre-padded to {want}")
            return adopt_frame(frames, self.device, self.stream), reuse_prev
        if isinstance(frames, np.ndarray) and frames.ndim == 4:
            frames = list(frames)
        host: Dict[int, np.ndarray] = {}
        for n, f in enumerate(frames):
            if f is None:
                reuse_prev[n] = True
            elif isinstance(f, torch.Tensor):
                want = (self.pad_h, self.pad_w, 3)
                if tuple(f.shape) != want:
                    raise ValueError(f"frame tensor {tuple(f.shape)} must be "
                                     f"padded to {want}")
                f = adopt_frame(f, self.device, self.stream)
                with _stream(self.stream):
                    self.last[n].copy_(f)
            else:
                host[n] = f
        self._uploads.upload(self.last, host, self.stream)
        return self.last, reuse_prev

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """A small per-tick host array on the device: through pinned memory
        with a non-blocking copy on the card (a pageable copy would wait
        for every tick already queued on the stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        with _stream(self.stream):
            return t.pin_memory().to(self.device, non_blocking=True)

    def reset(self, session: int) -> None:
        with _stream(self.stream):
            self.last[session].zero_()


@dataclass
class _MeshPending:
    """One in-flight lane dispatch (device handles + dispatch-time state)."""

    fetch: HostCopy             # async copy of the head + payload prefix
    packed: Any                 # full device buffer (refetch on miss)
    yq: Any                     # folded coefficient planes (overflow only)
    cbq: Any
    crq: Any
    paint_candidate: np.ndarray
    reuse_prev: np.ndarray
    first: np.ndarray
    stride: int


class MeshStripeEncoder:
    """Multi-session JPEG-stripe encoder: one device step per tick carries
    every session's frame through color convert, DCT, quantization and the
    Huffman pack, and returns wire-ready 0x03 stripe payloads per session.

    N solo ``JpegStripeEncoder``\\ s collapsed into one step on one card;
    damage gating and paint-over history run vectorized on the host across
    the whole batch.
    """

    def __init__(
        self,
        mesh: Mesh,
        n_sessions: int,
        width: int,
        height: int,
        stripe_h: int = 64,
        quality: int = 40,
        paintover_quality: int = 90,
        use_paint_over_quality: bool = True,
        paint_over_trigger_frames: int = 15,
        damage_threshold: int = 0,
    ) -> None:
        from ..encoder.jfif import jfif_headers

        self.device = lane_device(mesh)
        self.n_stripe_ax = 1
        if stripe_h % 16:
            raise ValueError("stripe_h must be a multiple of 16 (4:2:0 MCUs)")
        self.width, self.height = width, height
        self.pad_w = -(-width // 16) * 16
        self.pad_h = -(-height // stripe_h) * stripe_h
        self.stripe_h = stripe_h
        self.n_stripes = self.pad_h // stripe_h
        self.n_sessions = n_sessions
        self.mesh = mesh
        self.damage_threshold = int(damage_threshold)
        self.use_paint_over_quality = bool(use_paint_over_quality)
        self.paint_over_trigger_frames = int(paint_over_trigger_frames)
        #: the card's one encoder stream: every device call of the lane
        #: runs on it (the scheduler's worker thread makes it current too)
        self.stream = encoder_stream(self.device)

        ry, rc, (ly, lc), (py, pc) = _recip_tables(quality, paintover_quality)
        self._headers = tuple(
            jfif_headers(self.pad_w, stripe_h, qy_np, qc_np, subsampling="420")
            for qy_np, qc_np in ((ly, lc), (py, pc)))

        with _stream(self.stream):
            self._step, (self.s_local, self._mw, self._cap, self._packer) = \
                make_batched_entropy_step(mesh, self.pad_h, self.pad_w,
                                          stripe_h, n_sessions)
            self._recip_y = torch.from_numpy(ry).to(self.device)
            self._recip_c = torch.from_numpy(rc).to(self.device)
            self._prev = torch.zeros(
                (n_sessions, self.pad_h, self.pad_w, 3), dtype=torch.uint8,
                device=self.device)
        self._frames = LaneFrames(n_sessions, self.pad_h, self.pad_w,
                                  self.device, self.stream)

        S = self.n_stripes
        self._static = np.zeros((n_sessions, S), np.int64)
        self._painted = np.zeros((n_sessions, S), bool)
        self._first = np.ones(n_sessions, bool)
        #: adaptive D2H prefix (words per session fetched besides the
        #: head); a miss costs one extra read of the missing slice
        self._guess = self._packer.bucket_words(8192)
        #: fetch/concat split of the latest harvest wall, with per-shard
        #: fetch attribution (the scheduler's trace feed)
        self.last_harvest_stages: Optional[dict] = None
        #: bytes read device to host (prefixes and refetches) and stripes
        #: host-coded from their coefficients (observability)
        self.d2h_bytes_total = 0
        self.host_fallback_stripes_total = 0

    @property
    def h2d_bytes_total(self) -> int:
        return self._frames.h2d_bytes_total

    # -- control -----------------------------------------------------------

    def force_keyframe(self, session: int) -> None:
        """Next frame emits every stripe of one session (viewer join)."""
        self._first[session] = True
        self._static[session] = 0
        self._painted[session] = False

    def reset_session(self, session: int) -> None:
        """Recycle a slot for a new session: fresh damage history and a
        zeroed prev frame and re-present frame, so no stale pixels leak
        across occupants. Zeroed in place on the lane's stream, so ticks
        already in flight read the old pixels and every later tick the
        zeros."""
        self.force_keyframe(session)
        self._frames.reset(session)
        with _stream(self.stream):
            self._prev[session].zero_()

    # -- per-tick ----------------------------------------------------------

    def dispatch(self, frames) -> _MeshPending:
        """Dispatch one step for all sessions and start the async D2H
        prefix fetch; pair with :meth:`harvest`. ``frames`` as
        :meth:`LaneFrames.batch` takes them."""
        batch, reuse_prev = self._frames.batch(frames)

        paint_candidate = (
            self.use_paint_over_quality
            & (self._static >= self.paint_over_trigger_frames)
            & ~self._painted)
        paint_candidate &= ~reuse_prev[:, None] & ~self._first[:, None]
        first = self._first.copy()
        # a keyframe request on a slot with no frame this tick stays armed
        self._first &= reuse_prev
        # optimistic mark (cleared again by damage at harvest): frames
        # dispatched before this one harvests must not re-trigger the
        # same paint-over
        self._painted |= paint_candidate

        qsel = self._frames.upload(paint_candidate.astype(np.int32))
        with _stream(self.stream):
            packed, _, yq, cbq, crq, _sb, _total = self._step(
                batch, self._prev, self._recip_y, self._recip_c, qsel)
            stride = self._mw + 1 + min(self._guess, self._cap)
            fetch = HostCopy(packed[:, :stride].contiguous(), self.stream)
        return _MeshPending(
            fetch=fetch, packed=packed, yq=yq, cbq=cbq, crq=crq,
            paint_candidate=paint_candidate, reuse_prev=reuse_prev,
            first=first, stride=stride)

    def fetch_ready(self, p: _MeshPending) -> bool:
        """True when the prefix copy has landed (an event query: never
        blocks) — the scheduler's in-flight window harvests then."""
        return p.fetch.ready()

    def harvest(self, p: _MeshPending) -> Tuple[List[List], np.ndarray]:
        """Complete one dispatched step: returns (stripes_per_session,
        session_coded_bytes). Must be called in dispatch order.

        Sets :attr:`last_harvest_stages`, the fetch/concat split of the
        harvest wall, which the scheduler folds into each frame's trace."""
        from ..encoder.device_entropy import stuff_bytes, words_to_stripe_bytes
        from ..encoder.jfif import EOI
        from ..encoder.jpeg import StripeOutput, split_meta

        t_h0 = time.perf_counter()
        host, per_shard_ms = fetch_prefix(p.fetch)
        self.d2h_bytes_total += host.nbytes
        fetch_ms = sum(per_shard_ms.values())
        head = self._mw + 1
        n_s, S = self.n_sessions, self.n_stripes

        damaged = np.zeros((n_s, S), bool)
        session_bytes = np.zeros(n_s, np.int64)
        metas = {}
        max_total = 0
        for n in range(n_s):
            session_bytes[n] = int(host[n, self._mw])
            nbytes, base, ovf, damage = split_meta(host[n, :self._mw], S)
            total = int(base[-1]) + (int(nbytes[-1]) + 3) // 4
            metas[n] = (nbytes, base, ovf, total)
            max_total = max(max_total, total)
            damaged[n] = damage > self.damage_threshold

        damaged[p.first] = True
        damaged[p.reuse_prev] = False
        emit = damaged | p.paint_candidate
        is_paint = p.paint_candidate
        self._static = np.where(damaged, 0, self._static + 1)
        # paint marks were set optimistically at dispatch; damage clears
        self._painted = np.where(damaged, False, self._painted)

        # start every miss-refetch before blocking on any
        refetch = {}
        for n in range(n_s):
            total = metas[n][3]
            if emit[n].any() and total > p.stride - head:
                with _stream(self.stream):
                    refetch[n] = HostCopy(p.packed[n, head:head + total],
                                          self.stream)

        yrows, crows = self.stripe_h // 8, self.stripe_h // 16
        out: List[List[StripeOutput]] = []
        for n in range(n_s):
            stripes: List[StripeOutput] = []
            if emit[n].any():
                nbytes, base, ovf, total = metas[n]
                if n in refetch:
                    t_rf = time.perf_counter()
                    words = refetch[n].numpy()
                    self.d2h_bytes_total += words.nbytes
                    rf_ms = (time.perf_counter() - t_rf) * 1000.0
                    fetch_ms += rf_ms
                    per_shard_ms[0] = per_shard_ms.get(0, 0.0) + rf_ms
                else:
                    words = host[n, head:head + total]
                raw = words_to_stripe_bytes(words, base, nbytes)
                for g in range(S):
                    if not emit[n, g]:
                        continue
                    if ovf[g]:
                        # pathological stripe: host-code its coefficients
                        scan = self._host_scan(p, n * S + g, yrows, crows)
                    else:
                        scan = stuff_bytes(raw[g])
                    qidx = 1 if is_paint[n, g] else 0
                    stripes.append(StripeOutput(
                        y_start=g * self.stripe_h,
                        height=self.stripe_h,
                        jpeg=self._headers[qidx] + scan + EOI,
                        is_paintover=bool(is_paint[n, g])))
            out.append(stripes)

        self._guess = max(self._packer.bucket_words(max(max_total * 2, 8192)),
                          self._guess // 2)
        total_ms = (time.perf_counter() - t_h0) * 1000.0
        self.last_harvest_stages = {
            "fetch_ms": fetch_ms,
            "concat_ms": max(0.0, total_ms - fetch_ms),
            "per_shard_fetch_ms": [round(per_shard_ms.get(0, 0.0), 3)],
        }
        return out, session_bytes

    def _host_scan(self, p: _MeshPending, row: int, yrows: int,
                   crows: int) -> bytes:
        """Stripe ``row`` of the folded planes coded by the native scan
        coder from its coefficients (a stripe whose device pack
        overflowed; the bytes are the same)."""
        from ..encoder.jpeg import _entropy_encode_420

        self.host_fallback_stripes_total += 1
        with _stream(self.stream):
            y = p.yq[row * yrows:(row + 1) * yrows].cpu().numpy()
            cb = p.cbq[row * crows:(row + 1) * crows].cpu().numpy()
            cr = p.crq[row * crows:(row + 1) * crows].cpu().numpy()
        self.d2h_bytes_total += y.nbytes + cb.nbytes + cr.nbytes
        return _entropy_encode_420(y, cb, cr)

    def encode_frames(self, frames) -> Tuple[List[List], np.ndarray]:
        """Synchronous dispatch + harvest (tests, simple callers)."""
        return self.harvest(self.dispatch(frames))
