"""Device meshes and the multi-session JPEG lane (counterpart of
``selkies_tpu/parallel/mesh.py``).

The JAX package runs N sessions as one SPMD program over a ("session",
"stripe") ``jax.sharding.Mesh``: ``vmap`` over the sessions, ``shard_map``
over the chips, and a ``psum`` for the rate feedback. Here a lane is a grid
of **shards**: shard (r, c) holds the sessions of session-axis row r and
the rows of stripe band c, on ``mesh.devices[r, c]``, and runs its block
with that device current, on the device's encoder stream. Within a shard
the session axis folds into the frame's rows (``[n*h, W]`` planes): every
stage of the step is per pixel, per block or per stripe, and no block or
stripe crosses a session's rows or a band's edge, so one launch of each
kernel per shard carries the shard's sessions, and each session's bytes
are what it would get alone. What crosses shards is per session only: the
rate feedback (the ``psum`` over "stripe", then "session"), here a sum of
the shards' counts — on the host after the fetch (the lanes) or copied
onto the first device (:func:`make_batched_step`) — and the harvest,
which concatenates a session's stripes from its shards in stripe order
(stripes are independent, so nothing else is stitched).

:class:`Mesh` is a ("session", "stripe") grid of ``torch.device``\\ s. A
mesh may name one device several times (shards side by side on one card);
every distinct device runs on its own encoder stream.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import (TickClock, adopt_frame, encoder_stream, on_device,
                       resolve_device)
from ..encoder.staging import HostCopy, SlotUploads

#: pinned host batches a lane's uploads take turns in: the scheduler's
#: in-flight window (2) plus the tick being built
UPLOAD_DEPTH = 3

#: sessions per Huffman packer call of the JPEG lane on the CPU: the plain
#: packer's slot grids grow with the stripes packed at once (about 1.5 GB
#: per 1080p session), so it packs in chunks of this many sessions, as the
#: H.264 lane does per ``h264_device.PACK_FRAMES``; on the card the kernel
#: holds no such grid, and one call packs every session of a shard
PACK_SESSIONS = 4


class Mesh:
    """A ("session", "stripe") grid of torch devices (the counterpart of
    ``jax.sharding.Mesh`` with those axis names). Every device is of one
    kind (all CPU, or all CUDA); a CUDA device without an index is the
    current one."""

    axis_names = ("session", "stripe")

    def __init__(self, devices) -> None:
        arr = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(devices[idx[0]][idx[1]])
        kinds = {d.type for d in arr.flat}
        if len(kinds) > 1:
            raise ValueError(f"a mesh spans one kind of device, got "
                             f"{sorted(kinds)}")
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
    device count (every card, or the ``devices`` given, which may name one
    card several times); missing axes default to 1."""
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


@dataclass(frozen=True)
class Shard:
    """One block of a lane: the sessions of one session-axis row and the
    padded rows of one stripe band, on one device."""

    row: int                    # session-axis index
    col: int                    # stripe-axis index
    device: torch.device
    stream: Any                 # the device's encoder stream (None: CPU)
    sessions: slice             # lane slots
    rows: slice                 # padded frame rows
    stripes: slice              # lane stripe indices

    @property
    def n_sessions(self) -> int:
        return self.sessions.stop - self.sessions.start

    @property
    def height(self) -> int:
        return self.rows.stop - self.rows.start

    def context(self):
        """The shard's device current, on its encoder stream."""
        return on_device(self.device, self.stream)


def mesh_shards(mesh: Mesh, n_sessions: int, pad_h: int,
                stripe_h: int) -> List[Shard]:
    """The shards of a lane of ``n_sessions`` frames of ``pad_h`` rows over
    ``mesh``, row-major: ``n_sessions`` splits over the session axis and
    ``pad_h`` into stripe-axis bands of whole stripes (the JAX mesh's
    ``P("session", "stripe")`` blocks)."""
    n_sess_ax, n_stripe_ax = mesh.shape["session"], mesh.shape["stripe"]
    if n_sessions % n_sess_ax:
        raise ValueError(
            f"{n_sessions} sessions not divisible by session axis {n_sess_ax}")
    if pad_h % (n_stripe_ax * stripe_h):
        raise ValueError("pad_h must divide into stripe_ax × stripe_h bands")
    nl, hl = n_sessions // n_sess_ax, pad_h // n_stripe_ax
    sl = hl // stripe_h
    shards = []
    for r in range(n_sess_ax):
        for c in range(n_stripe_ax):
            dev = resolve_device(mesh.devices[r, c])
            shards.append(Shard(
                row=r, col=c, device=dev, stream=encoder_stream(dev),
                sessions=slice(r * nl, (r + 1) * nl),
                rows=slice(c * hl, (c + 1) * hl),
                stripes=slice(c * sl, (c + 1) * sl)))
    return shards


def gather(shards: List[Shard], parts: List[torch.Tensor]) -> torch.Tensor:
    """The lane-wide tensor ``[N, rows, ...]`` assembled from the shards'
    blocks (``[n_local, rows_local, ...]``) on the first shard's device
    (the block itself when the lane is one shard)."""
    if len(parts) == 1:
        return parts[0]
    dev = shards[0].device
    by_row: Dict[int, List[torch.Tensor]] = {}
    for sh, t in zip(shards, parts):
        by_row.setdefault(sh.row, []).append(t.to(dev))
    return torch.cat([torch.cat(by_row[r], dim=1) for r in sorted(by_row)])


def fetch_sharded_prefix(shards: List[Shard], copies: List[HostCopy]
                         ) -> Tuple[np.ndarray, Dict[int, float]]:
    """Materialize a lane's fetched prefixes shard by shard (the
    counterpart of JAX's ``fetch_sharded_prefix``), attributing the host
    wall to each stripe-axis block.

    Each copy is a shard's ``[n_local, L]`` prefix. Returns ``(host,
    per_shard_ms)``: the assembled host array ``[N, stripe_ax, L]`` and a
    map of stripe-axis block index to the host milliseconds spent blocked
    on that shard's copy; several sessions' shards on the same stripe
    block fold to the max (the gating wall)."""
    n = max(sh.sessions.stop for sh in shards)
    n_cols = max(sh.col for sh in shards) + 1
    host = None
    per_shard: Dict[int, float] = {}
    for sh, copy in zip(shards, copies):
        t0 = time.perf_counter()
        part = copy.numpy()
        ms = (time.perf_counter() - t0) * 1000.0
        if host is None:
            host = np.empty((n, n_cols) + part.shape[1:], part.dtype)
        host[sh.sessions, sh.col] = part
        per_shard[sh.col] = max(per_shard.get(sh.col, 0.0), ms)
    return host, per_shard


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


def _shards_of(mesh: Mesh, frames: List[torch.Tensor],
               stripe_h: int) -> List[Shard]:
    """The shards whose blocks ``frames`` (one ``[n_local, h_local, W, 3]``
    block per shard, row-major) are."""
    n_sess_ax, n_stripe_ax = mesh.shape["session"], mesh.shape["stripe"]
    if len(frames) != n_sess_ax * n_stripe_ax:
        raise ValueError(f"{len(frames)} blocks for a mesh of "
                         f"{n_sess_ax * n_stripe_ax} shards")
    nl, hl = frames[0].shape[:2]
    return mesh_shards(mesh, nl * n_sess_ax, hl * n_stripe_ax, stripe_h)


def make_batched_step(mesh: Mesh, stripe_h: int):
    """The multi-session encode step without entropy coding.

    fn(frames, prev, recip_y, recip_c, qsel), each a list of per-shard
    blocks in the order of :func:`mesh_shards`:
      frames/prev [n_local, h_local, W, 3] uint8 — ``prev`` is updated in
        place;
      recip_y/recip_c [nq, 8, 8] f32 — reciprocal quant tables on the
        shard's device (the JAX step takes the tables and computes
        ``1 / tables`` itself);
      qsel [n_local, s_local] int32 — per-session per-stripe table index.
    Returns (yq, cbq, crq, damage, prev, session_bits, total_bits): per
    shard the coefficient planes ([n_local, h_local/8, W/8, 64],
    [n_local, h_local/16, W/16, 64]), damage [n_local, s_local] and prev;
    then, on the first shard's device, the per-session nonzero-coefficient
    counts [N] (the rate feedback: each shard's counts copied there and
    summed over the stripe axis, the JAX ``psum``) and their sum. One
    DCT+quant launch per shard, on the shard's device."""
    from ..encoder.jpeg import encode_body_sessions

    def step(frames, prev, recip_y, recip_c, qsel):
        shards = _shards_of(mesh, frames, stripe_h)
        outs = []
        for sh, f, p, ry, rc, q in zip(shards, frames, prev, recip_y,
                                       recip_c, qsel):
            with sh.context():
                n, h, w, _ = f.shape
                yq, cbq, crq, damage, new_prev = encode_body_sessions(
                    f, p, ry, rc, q, stripe_h=stripe_h)
                p.copy_(new_prev.reshape(p.shape))
                yq = yq.reshape(n, h // 8, w // 8, 64)
                cbq = cbq.reshape(n, h // 16, w // 16, 64)
                crq = crq.reshape(n, h // 16, w // 16, 64)
                nz = ((yq != 0).flatten(1).sum(1)
                      + (cbq != 0).flatten(1).sum(1)
                      + (crq != 0).flatten(1).sum(1)).to(torch.int32)
            outs.append((yq, cbq, crq, damage, p, nz))
        yq, cbq, crq, damage, prev_out, nz = (list(x) for x in zip(*outs))
        dev0 = shards[0].device
        with shards[0].context():
            rows: Dict[int, torch.Tensor] = {}
            for sh, z in zip(shards, nz):
                z = z.to(dev0)
                rows[sh.row] = z if sh.row not in rows else rows[sh.row] + z
            session_bits = torch.cat([rows[r] for r in sorted(rows)])
            total_bits = session_bits.sum()
        return yq, cbq, crq, damage, prev_out, session_bits, total_bits

    return step, (mesh.shape["session"], mesh.shape["stripe"])


def make_batched_entropy_step(mesh: Mesh, pad_h: int, pad_w: int,
                              stripe_h: int, n_sessions: int):
    """The multi-session step carried through device entropy coding: one
    call yields wire-ready packed bitstreams for every session.

    Stripes are independent JPEGs (DC prediction resets per stripe), so
    each shard entropy-codes its band with a packer built for the band's
    geometry: no bitstream crosses shards.

    Returns (fn, meta): fn(frames, prev, recip_y, recip_c, qsel), each a
    list of per-shard blocks as :func:`make_batched_step` takes them, →
    per shard:
      packed [n_local, mw + 1 + cap_words] int32 — per session: nbytes,
          base, overflow and damage per stripe of the band
          (``jpeg.split_meta``), the band's coded bytes, then its
          compacted stripe bitstreams (the bit patterns of the JAX lane's
          uint32 block of that session and band);
      prev (updated in place), yq, cbq, crq (folded; kept on the device
          for the rare overflowed stripes);
      session_bytes [n_local] int32 — the band's coded bytes per session.
    A session's coded bytes (the rate feedback, JAX's ``psum`` over
    "stripe") are the sum of its bands' counts: the lane sums the heads on
    the host after the fetch, so nothing crosses devices.
    meta = (s_local, mw, cap_words, packer) of a band. One DCT+quant
    launch per shard; the Huffman pack is one kernel call per shard on the
    card, and on the CPU runs over every ``PACK_SESSIONS`` sessions'
    stripes (each session compacts on its own, so the chunking changes no
    byte)."""
    from ..encoder.device_entropy import DeviceEntropyPacker
    from ..encoder.jpeg import (BLOCK_WORDS, encode_body_sessions,
                                max_stripe_bytes)

    shards = mesh_shards(mesh, n_sessions, pad_h, stripe_h)
    h_local = shards[0].height
    nl = shards[0].n_sessions
    s = h_local // stripe_h
    chunk = nl if shards[0].device.type == "cuda" \
        else min(nl, PACK_SESSIONS)
    # per device, one packer per chunk size: full chunks and the remainder
    packers: Dict[Tuple[torch.device, int], Any] = {}
    for sh in shards:
        with sh.context():
            for c in {chunk, nl % chunk} - {0}:
                if (sh.device, c) not in packers:
                    packers[(sh.device, c)] = DeviceEntropyPacker(
                        c * h_local, pad_w, stripe_h,
                        block_words=BLOCK_WORDS,
                        max_stripe_bytes=max_stripe_bytes(stripe_h, pad_w),
                        device=sh.device, sessions=c)
    mw = 4 * s
    yr, cr = h_local // 8, h_local // 16        # block rows per session

    def pack(dev, yq, cbq, crq, n):
        parts = []
        for lo in range(0, n, chunk):
            c = min(chunk, n - lo)
            words, nbytes, base, ovf = packers[(dev, c)].pack(
                yq[lo * yr:(lo + c) * yr], cbq[lo * cr:(lo + c) * cr],
                crq[lo * cr:(lo + c) * cr])
            parts.append((words.reshape(c, -1), nbytes, base, ovf))
        return tuple(torch.cat(p) for p in zip(*parts))

    def shard_step(sh, frames, prev, recip_y, recip_c, qsel):
        n = frames.shape[0]
        yq, cbq, crq, damage, new_prev = encode_body_sessions(
            frames, prev, recip_y, recip_c, qsel, stripe_h=stripe_h)
        prev.copy_(new_prev.reshape(prev.shape))
        words, nbytes, base, ovf = pack(sh.device, yq, cbq, crq, n)
        nbytes = nbytes.reshape(n, s)
        session_bytes = nbytes.sum(1).to(torch.int32)
        head = torch.cat([nbytes.to(torch.int32),
                          base.reshape(n, s).to(torch.int32),
                          ovf.reshape(n, s).to(torch.int32),
                          damage.to(torch.int32),
                          session_bytes[:, None]], dim=1)
        packed = torch.cat([head, words.reshape(n, -1)], dim=1)
        return packed, prev, yq, cbq, crq, session_bytes

    def step(frames, prev, recip_y, recip_c, qsel):
        outs = []
        for sh, *args in zip(shards, frames, prev, recip_y, recip_c, qsel):
            with sh.context():
                outs.append(shard_step(sh, *args))
        return tuple(list(x) for x in zip(*outs))

    first = packers[(shards[0].device, chunk)]
    return step, (s, mw, first.cap_words, first)


class _LaneState:
    """What a lane keeps per shard: the shard, its frames and its device
    tensors (by name)."""

    __slots__ = ("shard", "frames", "t")

    def __init__(self, shard: Shard, frames: "LaneFrames") -> None:
        self.shard = shard
        self.frames = frames
        self.t: Dict[str, torch.Tensor] = {}


class BatchedSessionEncoder:
    """Frame-batched multi-session encoder without entropy coding (the
    step's coefficients and rate feedback): holds the previous frames on
    the shards' devices and runs one step per tick."""

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
        n_stripe_ax = mesh.shape["stripe"]
        if height % (n_stripe_ax * stripe_h):
            raise ValueError(
                f"height {height} not divisible by stripe axis {n_stripe_ax}"
                f" × stripe_h {stripe_h}")
        if width % 16:
            raise ValueError("width must be a multiple of 16 (4:2:0 MCUs)")
        self.mesh = mesh
        self.n_sessions = n_sessions
        self.width, self.height, self.stripe_h = width, height, stripe_h
        self.n_stripes = height // stripe_h
        self.shards = mesh_shards(mesh, n_sessions, height, stripe_h)
        self.device = self.shards[0].device
        ry, rc, _, _ = _recip_tables(quality, paintover_quality)
        self._step, _ = make_batched_step(mesh, stripe_h)
        self._recip_y, self._recip_c, self._prev_blocks = [], [], []
        for sh in self.shards:
            with sh.context():
                self._recip_y.append(torch.from_numpy(ry).to(sh.device))
                self._recip_c.append(torch.from_numpy(rc).to(sh.device))
                self._prev_blocks.append(torch.zeros(
                    (sh.n_sessions, sh.height, width, 3), dtype=torch.uint8,
                    device=sh.device))

    def step(self, frames: np.ndarray, qsel: Optional[np.ndarray] = None):
        """Encode one frame per session; returns (yq, cbq, crq, damage,
        session_bits, total_bits), each lane-wide on the first shard's
        device."""
        if qsel is None:
            qsel = np.zeros((self.n_sessions, self.n_stripes), np.int32)
        frames = np.ascontiguousarray(frames, np.uint8)
        qsel = np.asarray(qsel, np.int32)
        f_d, q_d = [], []
        for sh in self.shards:
            with sh.context():
                f_d.append(torch.from_numpy(np.ascontiguousarray(
                    frames[sh.sessions, sh.rows])).to(sh.device))
                q_d.append(torch.from_numpy(np.ascontiguousarray(
                    qsel[sh.sessions, sh.stripes])).to(sh.device))
        yq, cbq, crq, damage, _, session_bits, total_bits = self._step(
            f_d, self._prev_blocks, self._recip_y, self._recip_c, q_d)
        return (gather(self.shards, yq), gather(self.shards, cbq),
                gather(self.shards, crq), gather(self.shards, damage),
                session_bits, total_bits)


class LaneFrames:
    """The frame side of one shard of a lane encoder, shared by both
    profiles: the per-slot last frame band that idle ticks re-present (the
    JAX lane's ``_last_host``, kept here on the device, so an idle slot
    costs no upload), the pinned uploads of new host frames into it, and
    the upload of the small per-tick host arrays."""

    def __init__(self, n_sessions: int, pad_h: int, pad_w: int,
                 device: torch.device, stream) -> None:
        self.n_sessions = n_sessions
        self.pad_h, self.pad_w = pad_h, pad_w
        self.device, self.stream = device, stream
        shape = (n_sessions, pad_h, pad_w, 3)
        with on_device(device, stream):
            #: last frame submitted per slot (zeroed by reset_session)
            self.last = torch.zeros(shape, dtype=torch.uint8, device=device)
        self._uploads = SlotUploads(shape, UPLOAD_DEPTH, device)

    @property
    def h2d_bytes_total(self) -> int:
        return self._uploads.bytes_total

    def _take(self, t: torch.Tensor) -> torch.Tensor:
        """A frame tensor (or a stacked batch) for this shard: adopted as
        it is on the shard's device; from another card of the mesh, copied
        onto the shard's device on its stream (PyTorch orders a copy
        between cards after the work queued on both cards' current
        streams, and the source's stream after the copy)."""
        if t.device == self.device or t.device.type != "cuda" \
                or self.device.type != "cuda":
            return adopt_frame(t, self.device, self.stream)
        if t.dtype != torch.uint8:
            raise ValueError(f"frame tensor of {t.dtype}; uint8 expected")
        with on_device(self.device, self.stream):
            return t.to(self.device)

    def batch(self, frames) -> Tuple[torch.Tensor, np.ndarray]:
        """The device batch [N, pad_h, pad_w, 3] of one tick and the slots
        that re-present their last frame.

        ``frames``: an [N, H, W, 3] host array; a stacked [N, pad_h, pad_w,
        3] uint8 tensor on the shard's device (used as it is, and not kept
        for re-presenting, as the JAX lane does with a device batch) or on
        another card of the mesh (copied); or a length-N sequence whose
        entries are host frames (padded here), padded frame tensors, or
        None (re-present the slot's last frame, which damage gating then
        suppresses)."""
        n_s = self.n_sessions
        reuse_prev = np.zeros(n_s, bool)
        if isinstance(frames, torch.Tensor):
            want = (n_s, self.pad_h, self.pad_w, 3)
            if tuple(frames.shape) != want:
                raise ValueError(f"device batch must be pre-padded to {want}")
            batch = self._take(frames)
            if not batch.is_contiguous():
                with on_device(self.device, self.stream):
                    batch = batch.contiguous()
            return batch, reuse_prev
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
                f = self._take(f)
                with on_device(self.device, self.stream):
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
        with on_device(self.device, self.stream):
            return t.pin_memory().to(self.device, non_blocking=True)

    def reset(self, session: int) -> None:
        with on_device(self.device, self.stream):
            self.last[session].zero_()


def _band_of(frame: np.ndarray, rows: slice, pad_h: int) -> np.ndarray:
    """Rows ``rows`` of a host frame edge-padded to ``pad_h`` rows, without
    padding the whole frame: the band's rows inside the frame (the last
    frame row when the band lies wholly in the pad); ``pad_into`` then
    replicates the edges, as ``np.pad(mode="edge")`` would."""
    h = frame.shape[0]
    if rows.start == 0 and rows.stop >= min(h, pad_h):
        return frame
    if rows.start >= h:
        return frame[h - 1:h]
    return frame[rows.start:min(rows.stop, h)]


def split_frames(shards: List[Shard], frames, pad_h: int) -> List[Any]:
    """One tick's ``frames`` (as :meth:`LaneFrames.batch` takes them, for
    the whole lane) as each shard's input: its sessions, and the rows of
    its band."""
    if len(shards) == 1:
        return [frames]
    if isinstance(frames, torch.Tensor):
        return [frames[sh.sessions, sh.rows] for sh in shards]
    frames = list(frames)
    out = []
    for sh in shards:
        part = []
        for f in frames[sh.sessions]:
            if f is None:
                part.append(None)
            elif isinstance(f, torch.Tensor):
                part.append(f[sh.rows])
            else:
                part.append(_band_of(np.asarray(f), sh.rows, pad_h))
        out.append(part)
    return out


@dataclass
class _MeshPending:
    """One in-flight lane dispatch (device handles + dispatch-time state),
    per shard where the device holds it."""

    fetch: List[HostCopy]       # async copies of the head + payload prefix
    packed: List[Any]           # full device buffers (refetch on miss)
    yq: List[Any]               # folded coefficient planes (overflow only)
    cbq: List[Any]
    crq: List[Any]
    paint_candidate: np.ndarray
    reuse_prev: np.ndarray
    first: np.ndarray
    stride: int
    starts: Optional[list] = None   # the tick's device start stamps
    ends: Optional[list] = None     # its device completion stamps


class MeshStripeEncoder:
    """Multi-session JPEG-stripe encoder over a mesh: one step per shard
    per tick carries the shard's sessions' bands through color convert,
    DCT, quantization and the Huffman pack, and the harvest returns
    wire-ready 0x03 stripe payloads per session.

    N solo ``JpegStripeEncoder``\\ s collapsed into one step per shard;
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

        self.n_stripe_ax = mesh.shape["stripe"]
        if n_sessions % mesh.shape["session"]:
            raise ValueError(
                f"{n_sessions} sessions not divisible by session axis "
                f"{mesh.shape['session']}")
        if stripe_h % 16:
            raise ValueError("stripe_h must be a multiple of 16 (4:2:0 MCUs)")
        band = self.n_stripe_ax * stripe_h
        self.width, self.height = width, height
        self.pad_w = -(-width // 16) * 16
        self.pad_h = -(-height // band) * band
        self.stripe_h = stripe_h
        self.n_stripes = self.pad_h // stripe_h
        self.n_sessions = n_sessions
        self.mesh = mesh
        self.damage_threshold = int(damage_threshold)
        self.use_paint_over_quality = bool(use_paint_over_quality)
        self.paint_over_trigger_frames = int(paint_over_trigger_frames)
        self.shards = mesh_shards(mesh, n_sessions, self.pad_h, stripe_h)
        #: the first shard's device and encoder stream (the scheduler's
        #: worker thread makes it current; every shard's work enters its
        #: own)
        self.device = self.shards[0].device
        self.stream = self.shards[0].stream
        #: each tick's device interval on the host clock (none on the CPU)
        self._clock = TickClock(self.shards)

        ry, rc, (ly, lc), (py, pc) = _recip_tables(quality, paintover_quality)
        self._headers = tuple(
            jfif_headers(self.pad_w, stripe_h, qy_np, qc_np, subsampling="420")
            for qy_np, qc_np in ((ly, lc), (py, pc)))

        self._step, (self.s_local, self._mw, self._cap, self._packer) = \
            make_batched_entropy_step(mesh, self.pad_h, self.pad_w,
                                      stripe_h, n_sessions)
        self._lanes: List[_LaneState] = []
        for sh in self.shards:
            st = _LaneState(sh, LaneFrames(sh.n_sessions, sh.height,
                                           self.pad_w, sh.device, sh.stream))
            with sh.context():
                st.t["recip_y"] = torch.from_numpy(ry).to(sh.device)
                st.t["recip_c"] = torch.from_numpy(rc).to(sh.device)
                st.t["prev"] = torch.zeros(
                    (sh.n_sessions, sh.height, self.pad_w, 3),
                    dtype=torch.uint8, device=sh.device)
            self._lanes.append(st)

        S = self.n_stripes
        self._static = np.zeros((n_sessions, S), np.int64)
        self._painted = np.zeros((n_sessions, S), bool)
        self._first = np.ones(n_sessions, bool)
        #: adaptive D2H prefix (words per (session, shard) fetched besides
        #: the head); a miss costs one extra read of the missing slice
        self._guess = self._packer.bucket_words(8192)
        #: fetch/concat split of the latest harvest wall, with per-shard
        #: fetch attribution (the scheduler's trace feed)
        self.last_harvest_stages: Optional[dict] = None
        #: bytes read device to host (prefixes and refetches) and stripes
        #: host-coded from their coefficients (observability)
        self.d2h_bytes_total = 0
        self.host_fallback_stripes_total = 0

    @property
    def n_shards(self) -> int:
        """Devices one frame's stripe bands span (the stripe axis)."""
        return self.n_stripe_ax

    @property
    def h2d_bytes_total(self) -> int:
        return sum(st.frames.h2d_bytes_total for st in self._lanes)

    def gathered(self, name: str) -> torch.Tensor:
        """A copy of one per-session plane of the lane's state, assembled
        from the shards (``prev``: the previous frames [N, pad_h, pad_w,
        3]): for reading only, a write to it reaches no shard."""
        return gather(self.shards, [st.t[name] for st in self._lanes])

    @property
    def last_frames(self) -> torch.Tensor:
        """Each slot's re-present frame [N, pad_h, pad_w, 3] (gathered)."""
        return gather(self.shards, [st.frames.last for st in self._lanes])

    # -- control -----------------------------------------------------------

    def force_keyframe(self, session: int) -> None:
        """Next frame emits every stripe of one session (viewer join)."""
        self._first[session] = True
        self._static[session] = 0
        self._painted[session] = False

    def reset_session(self, session: int) -> None:
        """Recycle a slot for a new session: fresh damage history and a
        zeroed prev frame and re-present frame, so no stale pixels leak
        across occupants. Zeroed in place on each shard's stream, so ticks
        already in flight read the old pixels and every later tick the
        zeros."""
        self.force_keyframe(session)
        for st in self._lanes:
            sh = st.shard
            if sh.sessions.start <= session < sh.sessions.stop:
                local = session - sh.sessions.start
                st.frames.reset(local)
                with sh.context():
                    st.t["prev"][local].zero_()

    # -- per-tick ----------------------------------------------------------

    def dispatch(self, frames) -> _MeshPending:
        """Dispatch one step for all sessions and start the async D2H
        prefix fetch of every shard; pair with :meth:`harvest`. ``frames``
        as :meth:`LaneFrames.batch` takes them, for the whole lane."""
        starts = self._clock.stamp()
        parts = split_frames(self.shards, frames, self.pad_h)
        batches = []
        reuse_prev = np.zeros(self.n_sessions, bool)
        for st, part in zip(self._lanes, parts):
            b, reuse = st.frames.batch(part)
            batches.append(b)
            reuse_prev[st.shard.sessions] = reuse

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

        qsel = [st.frames.upload(paint_candidate[st.shard.sessions,
                                                 st.shard.stripes]
                                 .astype(np.int32))
                for st in self._lanes]
        packed, _, yq, cbq, crq, _sb = self._step(
            batches, [st.t["prev"] for st in self._lanes],
            [st.t["recip_y"] for st in self._lanes],
            [st.t["recip_c"] for st in self._lanes], qsel)
        stride = self._mw + 1 + min(self._guess, self._cap)
        fetch = []
        for st, pk in zip(self._lanes, packed):
            with st.shard.context():
                fetch.append(HostCopy(pk[:, :stride].contiguous(),
                                      st.shard.stream))
        return _MeshPending(
            fetch=fetch, packed=packed, yq=yq, cbq=cbq, crq=crq,
            paint_candidate=paint_candidate, reuse_prev=reuse_prev,
            first=first, stride=stride, starts=starts,
            ends=self._clock.stamp())

    def fetch_ready(self, p: _MeshPending) -> bool:
        """True when every shard's prefix copy has landed (event queries:
        never blocks) — the scheduler's in-flight window harvests then."""
        return all(f.ready() for f in p.fetch)

    def device_interval(self, p: _MeshPending
                        ) -> Optional[Tuple[float, float]]:
        """The harvested tick's (start, completion) on the card, on the
        host's monotonic clock; None on the CPU."""
        return self._clock.interval(p.starts, p.ends)

    def harvest(self, p: _MeshPending) -> Tuple[List[List], np.ndarray]:
        """Complete one dispatched step: returns (stripes_per_session,
        session_coded_bytes). Must be called in dispatch order.

        Sets :attr:`last_harvest_stages`, the fetch/concat split of the
        harvest wall with per-shard fetch attribution, which the scheduler
        folds into each frame's trace."""
        from ..encoder.jpeg import split_meta

        t_h0 = time.perf_counter()
        host, per_shard_ms = fetch_sharded_prefix(self.shards, p.fetch)
        self.d2h_bytes_total += host.nbytes
        fetch_ms = sum(per_shard_ms.values())
        head = self._mw + 1
        n_s, S, sl = self.n_sessions, self.n_stripes, self.s_local

        damaged = np.zeros((n_s, S), bool)
        # the rate feedback: each band's coded bytes, summed over the
        # stripe axis (the JAX step's psum)
        session_bytes = host[:, :, self._mw].astype(np.int64).sum(axis=1)
        metas = {}
        max_total = 0
        for n in range(n_s):
            for k in range(self.n_stripe_ax):
                nbytes, base, ovf, damage = split_meta(
                    host[n, k, :self._mw], sl)
                total = int(base[-1]) + (int(nbytes[-1]) + 3) // 4
                metas[(n, k)] = (nbytes, base, ovf, total)
                max_total = max(max_total, total)
                damaged[n, k * sl:(k + 1) * sl] = \
                    damage > self.damage_threshold

        damaged[p.first] = True
        damaged[p.reuse_prev] = False
        emit = damaged | p.paint_candidate
        is_paint = p.paint_candidate
        self._static = np.where(damaged, 0, self._static + 1)
        # paint marks were set optimistically at dispatch; damage clears
        self._painted = np.where(damaged, False, self._painted)

        # start every miss-refetch before blocking on any; session n's
        # band k is row n % nl of shard (n // nl, k)
        nl = self.shards[0].n_sessions
        refetch = {}
        for n in range(n_s):
            for k in range(self.n_stripe_ax):
                total = metas[(n, k)][3]
                if emit[n, k * sl:(k + 1) * sl].any() \
                        and total > p.stride - head:
                    i = (n // nl) * self.n_stripe_ax + k
                    with self.shards[i].context():
                        refetch[(n, k)] = HostCopy(
                            p.packed[i][n % nl, head:head + total],
                            self.shards[i].stream)

        out: List[List] = []
        for n in range(n_s):
            stripes: List = []
            for k in range(self.n_stripe_ax):
                if not emit[n, k * sl:(k + 1) * sl].any():
                    continue
                nbytes, base, ovf, total = metas[(n, k)]
                if (n, k) in refetch:
                    t_rf = time.perf_counter()
                    words = refetch[(n, k)].numpy()
                    self.d2h_bytes_total += words.nbytes
                    rf_ms = (time.perf_counter() - t_rf) * 1000.0
                    fetch_ms += rf_ms
                    per_shard_ms[k] = per_shard_ms.get(k, 0.0) + rf_ms
                else:
                    words = host[n, k, head:head + total]
                stripes += self._shard_stripes(
                    p, (n // nl) * self.n_stripe_ax + k, n % nl, words,
                    nbytes, base, ovf, emit[n], is_paint[n])
            out.append(stripes)

        self._guess = max(self._packer.bucket_words(max(max_total * 2, 8192)),
                          self._guess // 2)
        total_ms = (time.perf_counter() - t_h0) * 1000.0
        self.last_harvest_stages = {
            "fetch_ms": fetch_ms,
            "concat_ms": max(0.0, total_ms - fetch_ms),
            "per_shard_fetch_ms": [
                round(per_shard_ms.get(k, 0.0), 3)
                for k in range(self.n_stripe_ax)],
        }
        return out, session_bytes

    def _shard_stripes(self, p: _MeshPending, i: int, local: int,
                       words, nbytes, base, ovf, emit, is_paint) -> list:
        """The emitted stripes of one session's band in shard ``i``
        (``local``: the session's index in the shard), in stripe order."""
        from ..encoder.device_entropy import stuff_bytes, words_to_stripe_bytes
        from ..encoder.jfif import EOI
        from ..encoder.jpeg import StripeOutput

        raw = words_to_stripe_bytes(words, base, nbytes)
        out = []
        for s in range(self.s_local):
            g = self.shards[i].stripes.start + s
            if not emit[g]:
                continue
            if ovf[s]:  # pathological stripe: host-code its coefficients
                scan = self._host_scan(p, i, local * self.s_local + s)
            else:
                scan = stuff_bytes(raw[s])
            qidx = 1 if is_paint[g] else 0
            out.append(StripeOutput(
                y_start=g * self.stripe_h,
                height=self.stripe_h,
                jpeg=self._headers[qidx] + scan + EOI,
                is_paintover=bool(is_paint[g])))
        return out

    def _host_scan(self, p: _MeshPending, i: int, row: int) -> bytes:
        """Stripe ``row`` of shard ``i``'s folded planes coded by the native
        scan coder from its coefficients (a stripe whose device pack
        overflowed; the bytes are the same)."""
        from ..encoder.jpeg import _entropy_encode_420

        yrows, crows = self.stripe_h // 8, self.stripe_h // 16
        self.host_fallback_stripes_total += 1
        with self.shards[i].context():
            y = p.yq[i][row * yrows:(row + 1) * yrows].cpu().numpy()
            cb = p.cbq[i][row * crows:(row + 1) * crows].cpu().numpy()
            cr = p.crq[i][row * crows:(row + 1) * crows].cpu().numpy()
        self.d2h_bytes_total += y.nbytes + cb.nbytes + cr.nbytes
        return _entropy_encode_420(y, cb, cr)

    def encode_frames(self, frames) -> Tuple[List[List], np.ndarray]:
        """Synchronous dispatch + harvest (tests, simple callers)."""
        return self.harvest(self.dispatch(frames))
