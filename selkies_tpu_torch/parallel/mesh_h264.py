"""Multi-session striped H.264 lane over a mesh (counterpart of
``selkies_tpu/parallel/mesh_h264.py``).

Sessions split over the mesh's "session" axis and each frame's height
over its "stripe" axis on stripe boundaries (split-frame encoding, SFE):
legal because every stripe is an independent video sequence (its own
SPS/PPS/IDR chain and decoder on the client), so motion search, the
reconstruction chain and the pack stay shard-local. Within a shard the
sessions' stripes fold into one stripe axis: one device step per shard per
tick runs the damage test, one motion-search launch, the transform, quant
and reconstruction, and the pack (per ``h264_device.PACK_FRAMES``
sessions), on the shard's device. The harvest fetches every shard's heads
and concatenates each session's stripes, in stripe order, into one access
unit; each session's Annex-B equals the JAX lane's.

IDR handling keeps the step uniform: a joining session must not force
every session to a keyframe, so the step comes in two flavours — P only,
and a mixed one that also codes every stripe as Intra16x16 and selects per
stripe (``h264_device._merge_idr``). The host runs the mixed step only on
ticks where some stripe needs an IDR (join, reset, resync); IDR stripes
recover their exact levels from ``flat16`` and are coded on the host, as
overflowed stripes are, per shard.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import TickClock
from ..encoder import device_cavlc as dcav
from ..encoder import h264_device as dev
from ..encoder.h264 import (H264Stripe, _entropy_pool, encode_picture_nals_np,
                            make_pps, make_sps)
from ..encoder.staging import HostCopy
from .mesh import (LaneFrames, Mesh, _LaneState, fetch_sharded_prefix,
                   gather, mesh_shards, split_frames)

logger = logging.getLogger("selkies_tpu_torch.parallel.h264")

MB = 16


def make_h264_mesh_step(mesh: Mesh, pad_h: int, pad_w: int, stripe_h: int,
                        *, search: int = dev.SEARCH, cap_frac: int = 4,
                        with_idr: bool = False, prefix: int = 0,
                        entropy: str = "sparse", max_stripe_bytes: int = 0):
    """The multi-session H.264 step over ``mesh``
    (``h264_device.encode_frame_p_sessions_rgb`` per shard, with the band's
    geometry bound).

    Returns (fn, s_local): fn(frames, prev_y, prev_cb, prev_cr, ref_y,
    ref_cb, ref_cr, paint, idr, qp, paint_qp), the tensors as lists of
    per-shard blocks in the order of :func:`~.mesh.mesh_shards` (frames
    ``[n_local, h_local, pad_w, 3]``, paint and idr ``[n_local, s_local]``),
    → per shard (heads [n_local, prefix], flat16 [n_local, s_local, words],
    prev planes, refs), each shard's run on its device. ``entropy="device"``
    packs per-stripe CAVLC P-slice payloads; ``"sparse"`` the block-sparse
    levels. ``prefix=0`` keeps the whole buffer."""
    n_stripe_ax = mesh.shape["stripe"]
    if pad_h % (n_stripe_ax * stripe_h):
        raise ValueError("pad_h must divide into stripe_ax × stripe_h bands")
    h_local = pad_h // n_stripe_ax
    s_local = h_local // stripe_h
    shard_step = functools.partial(
        dev.encode_frame_p_sessions_rgb, pad_h=h_local, pad_w=pad_w,
        n_stripes=s_local, sh=stripe_h, search=search, with_idr=with_idr,
        entropy="device" if entropy == "device" else "sparse",
        cap_frac=cap_frac, max_stripe_bytes=max_stripe_bytes,
        prefix=prefix or None)

    def step(frames, prev_y, prev_cb, prev_cr, ref_y, ref_cb, ref_cr,
             paint, idr, qp, paint_qp):
        n = frames[0].shape[0] * mesh.shape["session"]
        outs = []
        for sh, *args in zip(mesh_shards(mesh, n, pad_h, stripe_h), frames,
                             prev_y, prev_cb, prev_cr, ref_y, ref_cb,
                             ref_cr, paint, idr):
            with sh.context():
                outs.append(shard_step(*args, qp, paint_qp))
        return tuple(list(x) for x in zip(*outs))

    return step, s_local


@dataclass
class _MeshH264Pending:
    fetch: List[HostCopy]         # async copies of each shard's heads
    flat16: List[Any]             # per shard [n_local, s_local, words]
    idr: np.ndarray               # [N, S] bool — dispatched as IDR
    paint: np.ndarray             # [N, S] bool
    reuse_prev: np.ndarray        # [N] bool
    qp: np.ndarray                # [N, S] int — qp each stripe coded at
    key_req: np.ndarray           # [N] keyframe requests made before it
    starts: Optional[list] = None  # the tick's device start stamps
    ends: Optional[list] = None    # its device completion stamps


#: the plane sets a lane keeps per shard: (name, rows per frame row)
_PLANES = (("prev_y", 1), ("prev_cb", 2), ("prev_cr", 2),
           ("ref_y", 1), ("ref_cb", 2), ("ref_cr", 2))


class MeshH264Encoder:
    """N solo striped H.264 encoders collapsed into one step per shard.

    Mirrors :class:`~.mesh.MeshStripeEncoder`'s surface (dispatch /
    fetch_ready / harvest, the scheduler's control calls) with the per
    stripe host state of a solo encoder (frame_num, idr_pic_id, damage and
    paint history) per session."""

    def __init__(self, mesh: Mesh, n_sessions: int, width: int, height: int,
                 *, stripe_h: int = 64, qp: int = 26, paint_over_qp: int = 18,
                 use_paint_over_quality: bool = True,
                 paint_over_trigger_frames: int = 15,
                 search: int = dev.SEARCH,
                 entropy: Optional[str] = None) -> None:
        self.n_stripe_ax = mesh.shape["stripe"]
        if n_sessions % mesh.shape["session"]:
            raise ValueError(
                f"{n_sessions} sessions not divisible by session axis "
                f"{mesh.shape['session']}")
        if stripe_h % MB:
            raise ValueError("stripe_h must be a multiple of 16")
        if width % 2 or height % 2:
            raise ValueError("frame dimensions must be even")
        band = self.n_stripe_ax * stripe_h
        self.width, self.height = width, height
        self.pad_w = -(-width // MB) * MB
        self.pad_h = -(-height // band) * band
        self.stripe_h = stripe_h
        self.n_stripes = self.pad_h // stripe_h
        self.n_sessions = n_sessions
        self.mesh = mesh
        self.qp = int(np.clip(qp, 0, 51))
        self.paint_over_qp = int(np.clip(paint_over_qp, 0, 51))
        self.use_paint_over_quality = bool(use_paint_over_quality)
        self.paint_over_trigger = int(paint_over_trigger_frames)
        self.search = search
        self.shards = mesh_shards(mesh, n_sessions, self.pad_h, stripe_h)
        #: the first shard's device and encoder stream (every shard's work
        #: enters its own)
        self.device = self.shards[0].device
        self.stream = self.shards[0].stream
        #: each tick's device interval on the host clock (none on the CPU)
        self._clock = TickClock(self.shards)

        n = (stripe_h // MB) * (self.pad_w // MB)
        self._shapes = [((n, 2), 2 * n), ((n, 16, 4, 4), 256 * n),
                        ((n, 4, 4), 16 * n), ((n, 2, 2, 2), 8 * n),
                        ((n, 2, 4, 4, 4), 128 * n)]
        self._stripe_words = sum(s for _, s in self._shapes)
        self.s_local = self.n_stripes // self.n_stripe_ax
        self._cap_frac = 8
        self._pad_words, self._n_cells, self._cap_cells = \
            dev.sparse_geometry(self._stripe_words, self._cap_frac)
        #: entropy tier: "device" packs CAVLC on the card, so steady state
        #: needs no host entropy threads; "host" ships sparse levels
        if entropy is None:
            entropy = os.environ.get("SELKIES_TPU_H264_ENTROPY", "device")
        if entropy not in ("device", "host"):
            raise ValueError(f"entropy must be device|host, got {entropy!r}")
        self.entropy = entropy
        if entropy == "device":
            self._cavlc_msb = dcav.default_max_stripe_bytes(
                self.pad_w // MB, stripe_h // MB)
            self._fixed_bytes = dcav.HEAD_BYTES * self.s_local
            self._buf_bytes = self._fixed_bytes \
                + self.s_local * self._cavlc_msb
            self._prefix = self._bucket(
                self._fixed_bytes + self.s_local * (4 << 10))
        else:
            self._cavlc_msb = 0
            self._fixed_bytes = 4 * self.s_local \
                + self.s_local * (self._n_cells // 8)
            self._buf_bytes = self._fixed_bytes \
                + self._cap_cells * self.s_local * dev.CELL
            #: per-(session, shard) fetch prefix over the content-compacted
            #: buffer; an undershoot falls back to flat16 rows and grows
            #: the bucket
            self._prefix = self._bucket(
                self._fixed_bytes + self.s_local * (8 << 10))

        self._lanes: List[_LaneState] = []
        for sh in self.shards:
            st = _LaneState(sh, LaneFrames(sh.n_sessions, sh.height,
                                           self.pad_w, sh.device, sh.stream))
            with sh.context():
                for name, div in _PLANES:
                    st.t[name] = torch.zeros(
                        (sh.n_sessions, sh.height // div, self.pad_w // div),
                        dtype=torch.uint8, device=sh.device)
            self._lanes.append(st)

        S = self.n_stripes
        self._need_idr = np.ones((n_sessions, S), bool)
        self._frame_num = np.zeros((n_sessions, S), np.int64)
        self._idr_pic_id = np.zeros((n_sessions, S), np.int64)
        self._static = np.zeros((n_sessions, S), np.int64)
        self._painted = np.zeros((n_sessions, S), bool)
        #: keyframe requests (force_keyframe, reset_session) per session:
        #: the harvest of an IDR dispatched before a request leaves the
        #: request armed (the JAX lane's harvest clears it, so a slot
        #: reset while its old occupant's join IDR was in flight gave the
        #: new occupant a P frame first)
        self._key_req = np.zeros(n_sessions, np.int64)
        self._sps_pps: Dict[int, bytes] = {}
        #: fetch/concat split of the latest harvest wall with per-shard
        #: fetch attribution (the scheduler's trace feed)
        self.last_harvest_stages: Optional[dict] = None
        #: stripes recovered through the flat16 host coder (overflow /
        #: prefix undershoot; IDR resyncs excluded) — observability
        self.host_fallback_stripes_total = 0
        #: bytes read device to host (heads and exact-level rows)
        self.d2h_bytes_total = 0
        #: sessions whose frame was withheld by whole-frame containment:
        #: in-flight successor ticks predicted off the withheld frame's
        #: references are withheld too, until the full-IDR resync tick
        self._withheld = np.zeros(n_sessions, bool)
        #: session indices whose stripe jobs FAILED in the latest harvest
        #: (not containment carry-over) — the scheduler charges these
        #: slots' health, so repeated encoder-internal failures walk the
        #: slot into quarantine and migration like injected faults
        self.last_failed_sessions: frozenset = frozenset()

    @property
    def n_shards(self) -> int:
        """Devices one frame's stripe bands are sharded across (the SFE
        stripe axis; 1 = the whole frame on one device)."""
        return self.n_stripe_ax

    @property
    def h2d_bytes_total(self) -> int:
        return sum(st.frames.h2d_bytes_total for st in self._lanes)

    def gathered(self, name: str) -> torch.Tensor:
        """A copy of one per-session plane of the lane's state, assembled
        from the shards (``prev_y``, ``prev_cb``, ``prev_cr``, ``ref_y``,
        ``ref_cb``, ``ref_cr``): for reading only, a write to it reaches
        no shard."""
        return gather(self.shards, [st.t[name] for st in self._lanes])

    @property
    def last_frames(self) -> torch.Tensor:
        """Each slot's re-present frame [N, pad_h, pad_w, 3] (gathered)."""
        return gather(self.shards, [st.frames.last for st in self._lanes])

    # -- control -----------------------------------------------------------

    def force_keyframe(self, session: int) -> None:
        self._need_idr[session] = True
        self._key_req[session] += 1
        self._static[session] = 0
        self._painted[session] = False

    def reset_session(self, session: int) -> None:
        """Recycle a slot: fresh history and zeroed planes, so no pixels
        leak across occupants (the inter references would carry them).
        The six plane sets and the re-present frame are zeroed in place on
        each shard's stream: ticks already in flight read the old planes,
        every later tick the zeros."""
        self.force_keyframe(session)
        self._frame_num[session] = 0
        self._withheld[session] = False
        for st in self._lanes:
            sh = st.shard
            if sh.sessions.start <= session < sh.sessions.stop:
                local = session - sh.sessions.start
                st.frames.reset(local)
                with sh.context():
                    for name, _ in _PLANES:
                        st.t[name][local].zero_()

    # -- helpers -----------------------------------------------------------

    def _bucket(self, nbytes: int) -> int:
        """Fetch-prefix bound quantized per stripe: the payload share above
        the fixed head rounds up to s_local × a power-of-two per-stripe
        budget (≥ 1 KB), capped at the whole buffer — growing the stripe
        axis shrinks s_local instead of multiplying distinct shapes."""
        per = 1 << 10
        need = max(0, int(nbytes) - self._fixed_bytes)
        while per * self.s_local < need:
            per <<= 1
        return min(self._fixed_bytes + per * self.s_local, self._buf_bytes)

    def _step_for(self, with_idr: bool, prefix: int):
        return make_h264_mesh_step(
            self.mesh, self.pad_h, self.pad_w, self.stripe_h,
            search=self.search, with_idr=with_idr, cap_frac=self._cap_frac,
            prefix=prefix,
            entropy="device" if self.entropy == "device" else "sparse",
            max_stripe_bytes=self._cavlc_msb)[0]

    def _sps_pps_for(self, h: int) -> bytes:
        if h not in self._sps_pps:
            self._sps_pps[h] = (
                make_sps(self.width, h, coded_height=self.stripe_h)
                + make_pps())
        return self._sps_pps[h]

    # -- per-tick ----------------------------------------------------------

    def dispatch(self, frames) -> _MeshH264Pending:
        """One step per shard for all sessions; pair with :meth:`harvest`.
        ``frames`` as :meth:`~.mesh.LaneFrames.batch` takes them, for the
        whole lane (None entries re-present the previous frame; damage
        gating suppresses them)."""
        starts = self._clock.stamp()
        parts = split_frames(self.shards, frames, self.pad_h)
        batches = []
        reuse_prev = np.zeros(self.n_sessions, bool)
        for st, part in zip(self._lanes, parts):
            b, reuse = st.frames.batch(part)
            batches.append(b)
            reuse_prev[st.shard.sessions] = reuse

        # a withheld session's client never received the content already
        # sitting in its last frame (whole-frame containment dropped it),
        # so an idle re-present is NOT a no-op for it: run the armed
        # full-frame IDR resync now instead of waiting for fresh damage
        reuse_prev &= ~self._withheld

        idr = self._need_idr & ~reuse_prev[:, None]
        paint = (self.use_paint_over_quality
                 & (self._static >= self.paint_over_trigger)
                 & ~self._painted & ~idr)
        paint &= ~reuse_prev[:, None]
        # optimistic arming (cleared by damage at harvest) — in-flight
        # ticks must not re-trigger
        self._painted |= paint
        self._need_idr &= reuse_prev[:, None]

        qp_arr = np.where(paint, self.paint_over_qp, self.qp)
        fn = self._step_for(bool(idr.any()), self._prefix)

        def blocks(arr):
            return [st.frames.upload(arr[st.shard.sessions, st.shard.stripes]
                                     .astype(np.int32)) for st in self._lanes]

        planes = [[st.t[name] for st in self._lanes] for name, _ in _PLANES]
        heads, flat16, *new = fn(batches, *planes, blocks(paint),
                                 blocks(idr), self.qp, self.paint_over_qp)
        fetch = []
        for i, st in enumerate(self._lanes):
            for (name, _), t in zip(_PLANES, new):
                st.t[name] = t[i]
            with st.shard.context():
                fetch.append(HostCopy(heads[i], st.shard.stream))
        return _MeshH264Pending(
            fetch=fetch, flat16=flat16, idr=idr, paint=paint,
            reuse_prev=reuse_prev, qp=qp_arr, key_req=self._key_req.copy(),
            starts=starts, ends=self._clock.stamp())

    def fetch_ready(self, p: _MeshH264Pending) -> bool:
        """True when every shard's heads copy has landed (event queries:
        never blocks) — the scheduler's in-flight window harvests then."""
        return all(f.ready() for f in p.fetch)

    def device_interval(self, p: _MeshH264Pending
                        ) -> Optional[Tuple[float, float]]:
        """The harvested tick's (start, completion) on the card, on the
        host's monotonic clock; None on the CPU."""
        return self._clock.interval(p.starts, p.ends)

    def harvest(self, p: _MeshH264Pending
                ) -> Tuple[List[List[H264Stripe]], np.ndarray]:
        """Entropy-finish one dispatched tick. Returns (stripes per session,
        coded bytes per session). Must be called in dispatch order.

        Sets :attr:`last_harvest_stages`, the fetch/concat split of the
        harvest wall with per-shard fetch attribution, which the scheduler
        folds into each frame's trace."""
        t_h0 = time.perf_counter()
        # [N, stripe_ax, prefix], copied shard by shard so the D2H wall is
        # attributable per stripe shard
        host, per_shard_ms = fetch_sharded_prefix(self.shards, p.fetch)
        self.d2h_bytes_total += host.nbytes
        fetch_ms = sum(per_shard_ms.values())
        n_s, S, sl = self.n_sessions, self.n_stripes, self.s_local
        CELL = dev.CELL
        cavlc = self.entropy == "device"

        damage = np.zeros((n_s, S), bool)
        ovf = np.zeros((n_s, S), bool)
        counts = np.zeros((n_s, S), np.int64)
        t_bits = np.zeros((n_s, S), np.int64)
        base_words = np.zeros((n_s, S), np.int64)
        for k in range(self.n_stripe_ax):
            gs = slice(k * sl, (k + 1) * sl)
            if cavlc:
                for n in range(n_s):
                    tb, bw, dmg, ov = dcav.parse_cavlc_head(host[n, k], sl)
                    t_bits[n, gs] = tb
                    base_words[n, gs] = bw
                    damage[n, gs] = dmg
                    ovf[n, gs] = ov
            else:
                head = host[:, k, :4 * sl].reshape(n_s, sl, 4)
                # the head keeps the cell count's low 16 bits; a count
                # past the cap (wrapped or not) comes with the overflow
                # flag
                counts[:, gs] = head[:, :, 0].astype(np.int64) \
                    + (head[:, :, 1].astype(np.int64) << 8)
                damage[:, gs] = head[:, :, 2] != 0
                ovf[:, gs] = head[:, :, 3] != 0

        damage[p.reuse_prev] = False
        emit = damage | p.paint | p.idr
        self._static = np.where(damage, 0, self._static + 1)
        self._painted = np.where(damage, False, self._painted)

        # per shard: device-CAVLC payload words or content-compacted sparse
        # cells, back to back after the fixed head. An undershoot (content
        # past the fetched prefix), a per-stripe overflow, or an IDR
        # stripe (its merged intra levels are not P-slice material)
        # recovers from the exact flat16 rows; their reads start before
        # any blocks
        used = np.minimum(counts, self._cap_cells) * CELL
        grew = False
        for n in range(n_s):
            for k in range(self.n_stripe_ax):
                gs = slice(k * sl, (k + 1) * sl)
                if not emit[n, gs].any():
                    continue
                if cavlc:
                    # clip to the device's per-stripe word capacity: an
                    # overflow stripe records unclipped t_bits but
                    # compacts at most V words
                    wc = np.minimum((t_bits[n, gs] + 31) // 32,
                                    self._cavlc_msb // 4)
                    needed = self._fixed_bytes \
                        + 4 * int(base_words[n, gs][-1] + wc[-1])
                else:
                    needed = self._fixed_bytes + int(used[n, gs].sum())
                if needed > host.shape[-1]:
                    ovf[n, gs] |= emit[n, gs]
                    if not grew:
                        self._prefix = self._bucket(needed + needed // 2)
                        grew = True
        host_path = ovf | (cavlc & p.idr)
        # overflow / prefix-undershoot stripes recovered through the
        # flat16 host coder (IDR resyncs are by construction, not faults)
        self.host_fallback_stripes_total += int((ovf & emit).sum())
        nl = self.shards[0].n_sessions
        exact: Dict[Tuple[int, int], HostCopy] = {}
        for n in range(n_s):
            for g in range(S):
                if emit[n, g] and host_path[n, g]:
                    i = (n // nl) * self.n_stripe_ax + g // sl
                    sh = self.shards[i]
                    with sh.context():
                        exact[(n, g)] = HostCopy(
                            p.flat16[i][n % nl, g % sl], sh.stream)

        mb_w = self.pad_w // MB
        mb_h = self.stripe_h // MB
        jobs = []
        for n in range(n_s):
            for g in range(S):
                if not emit[n, g]:
                    continue
                k, s = g // sl, g % sl
                if cavlc and not host_path[n, g]:
                    # the device already coded the stripe; the job is
                    # slice-header glue only
                    pb, nbits = dcav.payload_slice(
                        host[n, k], sl, base_words[n, k * sl:(k + 1) * sl],
                        t_bits[n, k * sl:(k + 1) * sl], s)
                    jobs.append((n, g, False, int(p.qp[n, g]),
                                 ("bits", pb, nbits)))
                    continue
                if host_path[n, g]:
                    t_rf = time.perf_counter()
                    row16 = exact[(n, g)].numpy()
                    self.d2h_bytes_total += row16.nbytes
                    row = row16.astype(np.int32)
                    rf_ms = (time.perf_counter() - t_rf) * 1000.0
                    fetch_ms += rf_ms
                    per_shard_ms[k] = per_shard_ms.get(k, 0.0) + rf_ms
                else:
                    bitmap = host[n, k, 4 * sl:self._fixed_bytes] \
                        .reshape(sl, self._n_cells // 8)[s]
                    bits = np.unpackbits(bitmap, bitorder="little")
                    idx = np.flatnonzero(bits[:self._n_cells])
                    start = self._fixed_bytes \
                        + int(used[n, k * sl:g].sum())
                    cells = host[n, k, start:start + used[n, g]] \
                        .view(np.int8).astype(np.int32).reshape(-1, CELL)
                    dense = np.zeros(self._pad_words, np.int32)
                    dense.reshape(-1, CELL)[idx[:len(cells)]] = cells
                    row = dense[:self._stripe_words]
                parts, pos = [], 0
                for shape, size in self._shapes:
                    parts.append(row[pos:pos + size].reshape(shape))
                    pos += size
                jobs.append((n, g, bool(p.idr[n, g]), int(p.qp[n, g]),
                             ("levels", parts)))
        def run_one(job):
            n, g, is_key, qp, work = job
            if work[0] == "bits":
                _, pb, nbits = work
                return dcav.assemble_p_slice(
                    pb, nbits, qp, int(self._frame_num[n, g]))
            mv, luma, luma_dc, chroma_dc, chroma_ac = work[1]
            if is_key:
                return encode_picture_nals_np(
                    mv, luma, luma_dc, chroma_dc, chroma_ac,
                    is_idr=True, mb_w=mb_w, mb_h=mb_h, qp=qp, frame_num=0,
                    idr_pic_id=int(self._idr_pic_id[n, g]))
            return encode_picture_nals_np(
                mv, luma, luma_dc, chroma_dc, chroma_ac,
                is_idr=False, mb_w=mb_w, mb_h=mb_h, qp=qp,
                frame_num=int(self._frame_num[n, g]))

        def safe_one(job):
            try:
                return run_one(job)
            except Exception as exc:
                return exc

        payloads = list(_entropy_pool().map(safe_one, jobs)) \
            if len(jobs) > 1 else [safe_one(j) for j in jobs]

        # whole-frame containment: a failed stripe job must never tear the
        # access unit. Sibling stripes of the same frame are withheld WITH
        # it — their device references already advanced, so emitting them
        # while skipping the failed one would drift every later P frame —
        # and the whole session resyncs with a full IDR on its next tick.
        # Successor ticks already in flight when the failure surfaces
        # predicted off the withheld references too, so the session STAYS
        # withheld until the tick that was dispatched as a full-frame IDR.
        prev_withheld = self._withheld.copy()
        failed_sessions = set()
        for job, payload in zip(jobs, payloads):
            if isinstance(payload, Exception):
                n, g = job[0], job[1]
                logger.error("lane CAVLC failed for session %d stripe %d; "
                             "frame withheld, forcing whole-frame IDR "
                             "resync", n, g, exc_info=payload)
                failed_sessions.add(n)
        for n in failed_sessions:
            self._need_idr[n] = True
            self._withheld[n] = True
        self.last_failed_sessions = frozenset(failed_sessions)
        # the resync tick (dispatched all-IDR) releases the withhold —
        # unless it failed too, in which case the next one re-arms
        release = prev_withheld & p.idr.all(axis=1)
        for n in failed_sessions:
            release[n] = False
        self._withheld &= ~release

        out: List[List[H264Stripe]] = [[] for _ in range(n_s)]
        coded = np.zeros(n_s, np.int64)
        for job, payload in zip(jobs, payloads):
            n, g, is_key, qp, _ = job
            if n in failed_sessions or (prev_withheld[n] and not release[n]):
                continue
            y0 = g * self.stripe_h
            h = min(self.stripe_h, self.height - y0)
            if h <= 0:
                continue
            if is_key:
                payload = self._sps_pps_for(h) + payload
                self._frame_num[n, g] = 1
                self._idr_pic_id[n, g] = (self._idr_pic_id[n, g] + 1) % 16
                if p.key_req[n] == self._key_req[n]:
                    self._need_idr[n, g] = False
                self._static[n, g] = 0
                self._painted[n, g] = False
            else:
                self._frame_num[n, g] = (self._frame_num[n, g] + 1) % 16
            coded[n] += len(payload)
            out[n].append(H264Stripe(
                y_start=y0, width=self.width, height=h,
                annexb=payload, is_key=is_key))
        total_ms = (time.perf_counter() - t_h0) * 1000.0
        self.last_harvest_stages = {
            "fetch_ms": fetch_ms,
            "concat_ms": max(0.0, total_ms - fetch_ms),
            "per_shard_fetch_ms": [
                round(per_shard_ms.get(k, 0.0), 3)
                for k in range(self.n_stripe_ax)],
        }
        return out, coded

    def encode_frames(self, frames) -> Tuple[List[List[H264Stripe]],
                                             np.ndarray]:
        """Synchronous dispatch + harvest (tests, simple callers)."""
        return self.harvest(self.dispatch(frames))

