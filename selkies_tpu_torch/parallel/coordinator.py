"""Lane scheduler: a dynamic, failure-isolated session scheduler (the
port's copy of ``selkies_tpu/parallel/coordinator.py``).

The server's per-display capture loops keep their shape (one asyncio task
per display), but instead of each owning a solo encoder pipeline they
submit frames to a per-session facade, and a single worker thread batches
sessions into one device step per lane per tick
(:class:`~selkies_tpu_torch.parallel.mesh.MeshStripeEncoder`,
:class:`~selkies_tpu_torch.parallel.mesh_h264.MeshH264Encoder`).

Scheduling model (docs/scaling.md). Sessions pack into **batch lanes**:
each lane owns one lane encoder with a fixed number of slots, its own
bounded in-flight window, and its own fault accounting — a lane is a
fault domain, and a *slot* is the sub-domain one session rides.

* **Dynamic admission** — a join takes a free slot in any live lane; when
  every lane is full a new lane is built on demand, up to ``max_lanes``.
  A full scheduler is therefore a real capacity statement (the server's
  admission control turns it into queue/shed verdicts).
* **Rebalance on leave** — a lane with no sessions and an empty window is
  retired after a grace period, freeing its device tensors; the tick never
  dispatches an empty lane. One healthy lane is kept warm to spare the
  next joiner a rebuild (unless it carries quarantined slots — then
  retiring it is how the poisoned fault domain gets recycled).
* **Slot health + quarantine + live migration** — per-slot error EWMAs
  (:class:`~selkies_tpu_torch.robustness.SlotHealth`) accumulate from
  failed dispatch/harvest ticks and injected slot faults. A slot that
  keeps faulting is quarantined (never returns to the free list) and its
  session is **migrated in place** to a healthy slot — the facade stays
  the same object, the new slot gets a full state reset (zeroed planes +
  keyframe), and the capture loop is told via ``consume_migration()`` so
  it can reset its frame ids (PIPELINE_RESETTING + ``Supervisor.forgive``).
  Cohabiting sessions keep streaming throughout.
* **Lane-contained errors** — a failing lane charges its own slots and
  backs off by itself (``skip_until``); other lanes' ticks proceed. The
  worker thread only sees ``mesh.tick_raise``-style whole-tick faults.

A tick encodes the newest submitted frame per attached session; sessions
without a new frame re-present their previous frame, which damage gating
suppresses on the device, so each dispatch stays dense while idle
sessions cost no wire bytes. Lanes use the server-wide quality settings;
per-client encoder overrides are ignored in this mode.

The worker thread issues the lanes' device work, so it runs with the
card's one encoder stream current (``_device.encoder_stream``), as every
thread of the port that issues device work does. With an injected
``enc_factory`` nothing is built on a device.

A scheduler ticks on a :class:`LaneTicker`'s thread. Given none, it gets
one of its own, as the JAX scheduler has its own thread; the server gives
every bucket's scheduler its one ticker (a divergence from the JAX
server, see :class:`LaneTicker`).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..robustness import SlotHealth, backoff_delay

logger = logging.getLogger("selkies_tpu_torch.parallel")

#: seconds a failed lane build blocks further build attempts — a broken
#: device must not be re-probed on every join
LANE_BUILD_BLOCK_S = 30.0

#: process-global lane id counter: geometry buckets share one fault
#: injector, so a ``mesh.slot_raise=lane:slot`` arming must name exactly
#: one lane across ALL coordinators, not one per bucket
_lane_ids = itertools.count()


def _p50(samples, ndigits: int = 3) -> float:
    """Median of a small sample window (0.0 when empty). Shared with
    the bench reporters so every ``*_ms_p50`` surface agrees."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return round(s[len(s) // 2], ndigits)


class MeshSessionFacade:
    """One session's encoder-shaped handle onto the coordinator.

    The facade survives migration: the coordinator rebinds the session to
    a new (lane, slot) underneath it, and the capture loop polls
    :meth:`consume_migration` to learn a rebind happened (so it can reset
    frame ids and notify the client)."""

    def __init__(self, coord: "MeshEncodeCoordinator", sid: int) -> None:
        self._coord = coord
        self.sid = sid
        self.closed = False

    @property
    def slot(self) -> Optional[int]:
        """Current slot index (None once released)."""
        return self._coord._slot_of(self.sid)

    @property
    def lane_id(self) -> Optional[int]:
        return self._coord._lane_of(self.sid)

    def try_submit(self, frame) -> Optional[int]:
        return self._coord._submit(self.sid, frame)

    submit = try_submit

    def poll(self) -> List[Tuple[int, list]]:
        return self._coord._poll(self.sid)

    def flush(self) -> List[Tuple[int, list]]:
        return self._coord._flush(self.sid)

    def force_keyframe(self) -> None:
        self._coord._force_keyframe(self.sid)

    def consume_migration(self) -> bool:
        """True once per quarantine migration since the last call — the
        capture loop's cue to reset frame ids (keyframe is already forced
        on the new slot by the coordinator)."""
        return self._coord._consume_migration(self.sid)

    def pop_trace(self, seq: int):
        """Flight-recorder stage intervals for a harvested frame.

        The mesh encoders split the harvest wall into ``fetch_wait``
        (D2H materialization, from their ``last_harvest_stages``) and
        ``pack`` (host slice concat /
        entropy glue); injected encoders without the split fall back to
        whole-wall ``fetch_wait`` (docs/observability.md)."""
        return self._coord._pop_trace(self.sid, seq)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self._coord._release(self.sid)


class _Session:
    """Scheduler-side state of one attached session (slot-independent, so
    migration only touches the lane/slot binding)."""

    __slots__ = ("sid", "lane", "slot", "gen", "seq", "pending", "results",
                 "traces", "inflight", "want_key", "want_reset",
                 "migrations_pending", "coded_bytes_total", "closed")

    def __init__(self, sid: int, lane: "_Lane", slot: int) -> None:
        self.sid = sid
        self.lane = lane
        self.slot = slot
        #: bumped on migration: harvests tagged with an older generation
        #: are dropped, so in-flight results of the old binding (or a
        #: previous occupant of a reused slot) never reach this session
        self.gen = 0
        self.seq = 0
        self.pending: Any = None
        self.results: List[Tuple[int, list]] = []
        #: seq -> stage intervals for the flight recorder (bounded)
        self.traces: Dict[int, dict] = {}
        #: frames of this session inside some lane's in-flight window
        self.inflight = 0
        self.want_key = False
        self.want_reset = False
        self.migrations_pending = 0
        self.coded_bytes_total = 0
        self.closed = False


class _Lane:
    """One SPMD batch lane: a compiled mesh encoder, its slot table, its
    bounded in-flight window, and its fault accounting."""

    __slots__ = ("id", "enc", "n_slots", "free", "sessions", "health",
                 "slot_errors", "inflight_q", "dispatching", "error_streak",
                 "skip_until", "idle_since")

    def __init__(self, lane_id: int, enc, n_slots: int,
                 health: SlotHealth) -> None:
        self.id = lane_id
        self.enc = enc
        self.n_slots = n_slots
        self.free = list(range(n_slots))
        self.sessions: Dict[int, _Session] = {}   # slot -> session
        self.health = health
        #: frames lost to failed dispatch/harvest ticks, per slot (so a
        #: single noisy session is attributable)
        self.slot_errors = [0] * n_slots
        #: (pending, [(session, slot, gen)], dispatch_interval)
        self.inflight_q: deque = deque()
        #: [(session, slot, gen)] taken by the tick being dispatched, not
        #: yet in inflight_q (they count toward a new submit's seq)
        self.dispatching: list = []
        #: consecutive failed ticks of THIS lane; drives the per-lane
        #: capped backoff so a sick lane never slows its neighbours
        self.error_streak = 0
        self.skip_until = 0.0
        self.idle_since: Optional[float] = None


class _LaneTickError(RuntimeError):
    """Internal: a lane's dispatch/harvest failed (already attributed)."""


class LaneTicker:
    """One worker thread that ticks lane schedulers, each at its own
    framerate, one after another.

    A tick issues a lane's ~1,500 eager device ops from Python, so two
    such threads contend for the GIL with each other and with the event
    loop: on the H100 host a second bucket's own thread cut the first
    bucket's displays to under half their rate (``chip_smoke.py``'s
    ``server_resize``, ``lane_own_tickers``). The thread enters the stream
    context of the scheduler that started it (the card's encoder stream,
    which every scheduler of one card shares) and ends when no scheduler
    is left."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._coords: List["MeshEncodeCoordinator"] = []
        #: the scheduler being ticked right now (remove waits it out)
        self._current: Optional["MeshEncodeCoordinator"] = None
        #: wakes the thread early (stop, retire); a tick still waits for
        #: its scheduler's next slot
        self.kick = threading.Event()
        self.thread: Optional[threading.Thread] = None

    def add(self, coord: "MeshEncodeCoordinator") -> bool:
        """Tick ``coord`` from now on, starting the thread if none runs.
        True when a thread that died had to be replaced."""
        with self._cond:
            if coord not in self._coords:
                coord._next_tick = time.monotonic()
                self._coords.append(coord)
            if self.thread is not None and self.thread.is_alive():
                return False
            died = self.thread is not None
            self.thread = threading.Thread(
                target=self._run, args=(coord,), name="mesh-encode",
                daemon=True)
            self.thread.start()
            return died

    def remove(self, coord: "MeshEncodeCoordinator") -> None:
        """Stop ticking ``coord``: when this returns no tick of it runs or
        will run. The last one out joins the thread."""
        me = threading.current_thread()
        with self._cond:
            if coord in self._coords:
                self._coords.remove(coord)
            if me is not self.thread:
                self._cond.wait_for(lambda: self._current is not coord,
                                    timeout=5.0)
            thread = None if self._coords else self.thread
            if thread is not None:
                self.thread = None
        self.kick.set()
        if thread is not None and thread is not me:
            thread.join(timeout=5.0)

    def ticks(self, coord: "MeshEncodeCoordinator") -> bool:
        with self._cond:
            return coord in self._coords

    def _run(self, first: "MeshEncodeCoordinator") -> None:
        me = threading.current_thread()
        with first._stream_context():
            while True:
                with self._cond:
                    if self.thread is not me or not self._coords:
                        return
                    coords = list(self._coords)
                wake = time.monotonic() + 1.0
                for coord in coords:
                    with self._cond:
                        if coord not in self._coords:
                            continue
                        self._current = coord
                    try:
                        now = time.monotonic()
                        if now >= coord._next_tick:
                            coord._tick_once(now)
                        wake = min(wake, coord._next_tick)
                    finally:
                        with self._cond:
                            self._current = None
                            self._cond.notify_all()
                delay = wake - time.monotonic()
                if delay > 0:
                    self.kick.wait(timeout=delay)
                self.kick.clear()


class MeshEncodeCoordinator:
    """Owns the batch lanes, the session table, and its ticks."""

    def __init__(
        self,
        mesh_spec: str,
        sessions_per_chip: int,
        width: int,
        height: int,
        settings=None,
        framerate: float = 60.0,
        stripe_h: int = 64,
        profile: str = "jpeg",
        max_inflight: int = 2,
        max_lanes: Optional[int] = None,
        slots_per_lane: Optional[int] = None,
        enc_factory: Optional[Callable[[int], Any]] = None,
        health_sick_errors: Optional[float] = None,
        health_window_s: Optional[float] = None,
        lane_retire_s: float = 5.0,
        device=None,
        ticker: Optional[LaneTicker] = None,
    ) -> None:
        self.profile = profile
        self.width, self.height = width, height
        self.framerate = float(framerate)
        #: the card's encoder stream the worker thread runs with (None:
        #: injected lanes, or the CPU)
        self._stream = None
        if enc_factory is not None:
            # injected lanes (tests): nothing built on a device, capacity
            # comes from the caller
            self.chips = max(1, self._chips_from_spec(mesh_spec))
            self.slots_per_lane = int(
                slots_per_lane or max(1, sessions_per_chip))
            self._enc_factory = enc_factory
        else:
            self._enc_factory = self._build_default_factory(
                mesh_spec, sessions_per_chip, width, height,
                settings, stripe_h, profile, device)
        if max_lanes is None and settings is not None:
            max_lanes = int(getattr(settings, "mesh_max_lanes", 4) or 4)
        self.max_lanes = max(1, int(max_lanes or 4))
        if health_sick_errors is None and settings is not None:
            health_sick_errors = float(
                getattr(settings, "slot_quarantine_errors", 3) or 3)
        if health_window_s is None and settings is not None:
            health_window_s = float(
                getattr(settings, "slot_health_window_s", 30) or 30)
        self._health_sick_errors = float(health_sick_errors or 3.0)
        self._health_window_s = float(health_window_s or 30.0)
        self.lane_retire_s = float(lane_retire_s)

        self._lock = threading.Lock()
        #: serializes lane BUILDS only: device allocation can take
        #: seconds and must never happen under the main lock (it would
        #: freeze every ticking lane and every facade poll/submit)
        self._build_lock = threading.Lock()
        self.lanes: List[_Lane] = []
        self._lane_build_block_until = 0.0
        #: sids currently blocked from migrating (nowhere healthy to
        #: go): membership makes migrations_blocked_total count blocked
        #: EVENTS, not retry ticks
        self._blocked_sids: set = set()
        self._sessions: Dict[int, _Session] = {}
        self._next_sid = 0
        #: fault-injection registry checked at the tick/slot sites
        #: (mesh.tick_raise / mesh.slot_raise); wired by the server
        self.faults = None

        #: bounded in-flight window PER LANE: up to
        #: ``max_inflight`` dispatched ticks ride the device at once —
        #: dispatch of tick N+1 overlaps the D2H fetch of tick N, drained
        #: oldest-first (per-stripe host state advances per tick)
        self.max_inflight = max(1, int(max_inflight))
        self.inflight_batches_max = 0
        #: the thread that ticks this scheduler (shared with other
        #: buckets' schedulers when the server hands one in)
        self._ticker = ticker if ticker is not None else LaneTicker()
        self._next_tick = 0.0
        # -- aggregate fault/scheduling accounting (health feeds + tests)
        self.tick_errors_total = 0
        self._consecutive_tick_failures = 0
        self.worker_restarts_total = 0
        self.slot_faults_total = 0
        self.quarantined_total = 0
        self.migrations_total = 0
        self.migrations_blocked_total = 0
        self.lanes_built_total = 0
        self.lanes_retired_total = 0
        #: recent harvest fetch/concat walls (ms) from the lane encoders'
        #: last_harvest_stages (the health feed's sfe_concat_ms_p50)
        self._fetch_ms_window: deque = deque(maxlen=128)
        self._concat_ms_window: deque = deque(maxlen=128)
        # first lane is built eagerly so construction failures surface at
        # coordinator-build time (the server scopes those per geometry)
        if self._build_lane() is None:
            raise RuntimeError("mesh lane construction failed")

    # -- construction helpers ----------------------------------------------

    @staticmethod
    def _chips_from_spec(spec: str) -> int:
        """Device count implied by a ``tpu_mesh`` spec string, computed
        textually so injected-encoder mode builds nothing. Malformed
        parts are a configuration error and REJECTED — a typo'd axis
        must not silently collapse a multi-chip slice to one chip."""
        chips = 1
        for part in str(spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, num = part.partition(":")
            if not sep or not name.strip():
                raise ValueError(f"malformed tpu_mesh part {part!r} "
                                 f"(want axis:size)")
            try:
                chips *= max(1, int(num))
            except ValueError:
                raise ValueError(
                    f"malformed tpu_mesh part {part!r}: size "
                    f"{num!r} is not an integer") from None
        return chips

    @staticmethod
    def _sfe_shard_count(total_chips: int, width: int, height: int,
                         settings) -> int:
        """Stripe shards one frame of this geometry should span: 1 below
        ``sfe_min_pixels`` (or on a single chip), else ``sfe_shards``
        (0 = every chip), clamped to the largest count that tiles the
        slice. Pure policy — unit-testable without devices. Split-frame
        encoding is not ported (ROADMAP Queue 1, item 2): no lane is built
        from it, and on one card it is 1."""
        sfe_min = int(getattr(settings, "sfe_min_pixels", 0) or 0) \
            if settings is not None else 0
        if not sfe_min or total_chips <= 1 or width * height < sfe_min:
            return 1
        want = int(getattr(settings, "sfe_shards", 0) or 0) \
            if settings is not None else 0
        shards = max(1, min(want or total_chips, total_chips))
        while total_chips % shards:    # largest count that tiles the slice
            shards -= 1
        return shards

    def _build_default_factory(self, mesh_spec, sessions_per_chip, width,
                               height, settings, stripe_h, profile,
                               device=None):
        from .._device import encoder_stream, resolve_device
        from .mesh import MeshStripeEncoder, parse_mesh_spec
        from .mesh_h264 import MeshH264Encoder

        devices = None if device is None else [resolve_device(device)]
        # a mesh over several cards (a stripe axis: split-frame encoding)
        # makes the lane encoders raise, so its lanes fail to build
        mesh = parse_mesh_spec(mesh_spec, devices)
        self.chips = mesh.shape["session"] * mesh.shape["stripe"]
        self.slots_per_lane = (
            mesh.shape["session"] * max(1, sessions_per_chip))
        self._stream = encoder_stream(mesh.devices[0, 0])
        kwargs: Dict[str, Any] = {}
        if profile == "x264enc-striped":
            # H.264 stripes in lanes; CRF settings map onto the QP scale
            # like the solo factory does
            if settings is not None:
                kwargs = dict(
                    qp=int(settings.h264_crf.default),
                    paint_over_qp=int(settings.h264_paintover_crf.default),
                    use_paint_over_quality=bool(
                        settings.use_paint_over_quality.value),
                    stripe_h=int(settings.tpu_stripe_height),
                )
            else:
                kwargs = dict(stripe_h=stripe_h)

            def factory(n: int):
                return MeshH264Encoder(mesh, n, width, height, **kwargs)
        else:
            if settings is not None:
                kwargs = dict(
                    quality=int(settings.jpeg_quality.default),
                    paintover_quality=int(
                        settings.paint_over_jpeg_quality.default),
                    use_paint_over_quality=bool(
                        settings.use_paint_over_quality.value),
                    stripe_h=int(settings.tpu_stripe_height),
                )
            else:
                kwargs = dict(stripe_h=stripe_h)

            def factory(n: int):
                return MeshStripeEncoder(mesh, n, width, height, **kwargs)
        return factory

    def _build_lane(self) -> Optional[_Lane]:
        """Build and publish one lane, holding the main lock only for
        the capacity check and the publish — the encoder construction
        (device allocation) runs outside it, so ticking lanes and facade
        polls never freeze behind a build. ``_build_lock`` serializes
        concurrent builders (two joins racing must not overshoot
        ``max_lanes``)."""
        with self._build_lock:
            with self._lock:
                if len(self.lanes) >= self.max_lanes:
                    return None
                if time.monotonic() < self._lane_build_block_until:
                    return None
            try:
                enc = self._enc_factory(self.slots_per_lane)
            except Exception:
                # a broken device tier must not be re-probed per join
                with self._lock:
                    self._lane_build_block_until = (
                        time.monotonic() + LANE_BUILD_BLOCK_S)
                logger.exception("mesh lane build failed; blocking "
                                 "builds for %.0fs", LANE_BUILD_BLOCK_S)
                return None
            lane = _Lane(next(_lane_ids), enc, self.slots_per_lane,
                         SlotHealth(self.slots_per_lane,
                                    sick_errors=self._health_sick_errors,
                                    window_s=self._health_window_s))
            with self._lock:
                self.lanes.append(lane)
                self.lanes_built_total += 1
            logger.info("mesh lane %d built (%d slots, %d lanes live)",
                        lane.id, lane.n_slots, len(self.lanes))
            return lane

    # -- session lifecycle (event-loop side) -------------------------------

    @property
    def active_sessions(self) -> int:
        """Currently attached sessions (live occupancy, not cumulative)."""
        with self._lock:
            return len(self._sessions)

    @property
    def n_sessions(self) -> int:
        """Batch width of one lane (compat: the pre-lane slot count)."""
        return self.slots_per_lane

    @property
    def _attached(self) -> Dict[int, _Session]:
        """Compat view for tests: sid -> session."""
        with self._lock:
            return dict(self._sessions)

    def _bind_free_slot_locked(self) -> Optional[int]:
        lane = next((ln for ln in self.lanes if ln.free), None)
        if lane is None:
            return None
        slot = lane.free.pop(0)
        sid = self._next_sid
        self._next_sid += 1
        sess = _Session(sid, lane, slot)
        lane.sessions[slot] = sess
        lane.idle_since = None
        self._sessions[sid] = sess
        # applied at tick time: the worker may be mid-dispatch and the
        # encoder's host state is not safe to touch from here. A new
        # occupant gets a full reset (zeroed prev planes), not just a
        # keyframe — stale pixels must not leak across occupants.
        sess.want_reset = True
        return sid

    def acquire(self, width: int, height: int) -> Optional[MeshSessionFacade]:
        """Attach a session; None when geometry differs or — after trying
        to grow a fresh lane — the scheduler is genuinely out of slots."""
        if (width, height) != (self.width, self.height):
            return None
        with self._lock:
            sid = self._bind_free_slot_locked()
        if sid is None:
            # grow on demand: the build runs outside the main lock, so
            # existing lanes keep ticking while the new one allocates
            self._build_lane()
            with self._lock:
                sid = self._bind_free_slot_locked()
        if sid is None:
            return None
        self._ensure_thread()
        return MeshSessionFacade(self, sid)

    def capacity(self) -> Dict[str, int]:
        """Live lane capacity for the server's admission verdicts."""
        with self._lock:
            free = sum(len(ln.free) for ln in self.lanes)
            quarantined = sum(len(ln.health.quarantined)
                              for ln in self.lanes)
            growable = ((self.max_lanes - len(self.lanes))
                        * self.slots_per_lane
                        if time.monotonic() >= self._lane_build_block_until
                        else 0)
            return {
                "slots_free": free,
                "growable_slots": growable,
                "slots_total": len(self.lanes) * self.slots_per_lane,
                "quarantined_slots": quarantined,
                "active_sessions": len(self._sessions),
                "lanes": len(self.lanes),
            }

    def _release(self, sid: int) -> None:
        with self._lock:
            sess = self._sessions.pop(sid, None)
            if sess is None:
                return
            sess.closed = True
            sess.pending = None
            sess.results = []
            sess.traces = {}
            self._blocked_sids.discard(sid)
            lane = sess.lane
            if lane.sessions.get(sess.slot) is sess:
                lane.sessions.pop(sess.slot, None)
                # quarantined slots never return to service; the lane is
                # recycled wholesale once it drains
                if sess.slot not in lane.health.quarantined:
                    lane.free.append(sess.slot)

    def _slot_of(self, sid: int) -> Optional[int]:
        with self._lock:
            sess = self._sessions.get(sid)
            return sess.slot if sess is not None else None

    def _lane_of(self, sid: int) -> Optional[int]:
        with self._lock:
            sess = self._sessions.get(sid)
            return sess.lane.id if sess is not None else None

    def _pop_trace(self, sid: int, seq: int):
        with self._lock:
            sess = self._sessions.get(sid)
            return sess.traces.pop(seq, None) if sess is not None else None

    def _consume_migration(self, sid: int) -> bool:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None and sess.migrations_pending:
                sess.migrations_pending = 0
                return True
            return False

    def stop(self) -> None:
        self._ticker.remove(self)

    @property
    def _kick(self) -> threading.Event:
        return self._ticker.kick

    @property
    def _thread(self) -> Optional[threading.Thread]:
        """The thread ticking this scheduler (None once stopped)."""
        return self._ticker.thread if self._ticker.ticks(self) else None

    # -- facade surface ----------------------------------------------------

    def _submit(self, sid: int, frame) -> Optional[int]:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                return None
            dropped = sess.pending is not None
            sess.pending = frame
            # the seq THIS frame will harvest under: seq advances only at
            # harvest, so same-generation frames already in the in-flight
            # window come first — without the offset, overlapped steady
            # state would hand the in-flight frame's seq to every new
            # submit (trace correlation off by one)
            lane = sess.lane
            took = [t for entry in lane.inflight_q for t in entry[1]]
            inflight = sum(1 for s, _slot, g in took + lane.dispatching
                           if s is sess and g == sess.gen)
            seq = sess.seq + inflight
        self._kick.set()
        return None if dropped else seq

    def _poll(self, sid: int) -> List[Tuple[int, list]]:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                return []
            out = sess.results
            if out:
                sess.results = []
            return out

    def _flush(self, sid: int) -> List[Tuple[int, list]]:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._lock:
                sess = self._sessions.get(sid)
                if sess is None or (sess.pending is None
                                    and sess.inflight == 0):
                    break
            time.sleep(0.005)
        return self._poll(sid)

    def _force_keyframe(self, sid: int) -> None:
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is not None:
                sess.want_key = True
        self._kick.set()

    # -- worker ------------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._ticker.add(self):
            # the previous worker died (tick exception storm or device
            # loss); account for the re-spawn so it is observable
            self.worker_restarts_total += 1

    def _stream_context(self):
        """The card's encoder stream, current for the worker thread (a
        no-op for injected lanes and on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        import torch

        return torch.cuda.stream(self._stream)

    def _tick_once(self, now: float) -> None:
        """One tick on the ticker's thread, and the time of the next."""
        interval = 1.0 / max(1.0, self.framerate)
        self._next_tick = max(self._next_tick + interval, now - interval)
        try:
            self._tick()
            self._consecutive_tick_failures = 0
        except Exception:
            # whole-tick failure (mesh.tick_raise / unexpected): lane
            # errors are contained per lane, so reaching here is rare;
            # back off with a capped exponential so a persistent fault
            # doesn't spin the worker at tick rate (without holding up
            # the other schedulers on the ticker)
            self.tick_errors_total += 1
            self._consecutive_tick_failures += 1
            logger.exception("mesh encode tick failed (streak %d)",
                             self._consecutive_tick_failures)
            self._next_tick = time.monotonic() + backoff_delay(
                self._consecutive_tick_failures, 0.5, 5.0)

    def stats(self) -> dict:
        """Scheduler + per-slot fault accounting for health feeds/tests."""
        with self._lock:
            lane_detail = []
            for ln in self.lanes:
                lane_detail.append({
                    "id": ln.id,
                    "slots": ln.n_slots,
                    "free": len(ln.free),
                    "sessions": len(ln.sessions),
                    "slot_errors": list(ln.slot_errors),
                    "error_streak": ln.error_streak,
                    "inflight": len(ln.inflight_q),
                    "health": ln.health.state(),
                })
            return {
                "active_sessions": len(self._sessions),
                "lanes": len(self.lanes),
                "slots_per_lane": self.slots_per_lane,
                "capacity_slots": len(self.lanes) * self.slots_per_lane,
                "free_slots": sum(len(ln.free) for ln in self.lanes),
                "quarantined_slots": sum(
                    len(ln.health.quarantined) for ln in self.lanes),
                "tick_errors_total": self.tick_errors_total,
                "worker_restarts_total": self.worker_restarts_total,
                "slot_errors": [e for ln in self.lanes
                                for e in ln.slot_errors],
                "slot_faults_total": self.slot_faults_total,
                "quarantined_total": self.quarantined_total,
                "migrations_total": self.migrations_total,
                "migrations_blocked_total": self.migrations_blocked_total,
                "lanes_built_total": self.lanes_built_total,
                "lanes_retired_total": self.lanes_retired_total,
                "inflight_batches": sum(
                    len(ln.inflight_q) for ln in self.lanes),
                "inflight_batches_max": self.inflight_batches_max,
                "sfe_fetch_ms_p50": _p50(self._fetch_ms_window),
                "sfe_concat_ms_p50": _p50(self._concat_ms_window),
                "lane_detail": lane_detail,
            }

    def verify_slot_accounting(self) -> List[str]:
        """Leak check for tests/harnesses: every slot of every lane must
        be exactly one of free / occupied / quarantined."""
        problems: List[str] = []
        with self._lock:
            for ln in self.lanes:
                occupied = set(ln.sessions)
                free = set(ln.free)
                quarantined = set(ln.health.quarantined)
                if len(ln.free) != len(free):
                    problems.append(f"lane {ln.id}: duplicate free slots")
                if free & occupied:
                    problems.append(
                        f"lane {ln.id}: slots both free and occupied: "
                        f"{sorted(free & occupied)}")
                if quarantined & free:
                    problems.append(
                        f"lane {ln.id}: quarantined slots back in the "
                        f"free list: {sorted(quarantined & free)}")
                accounted = free | occupied | quarantined
                missing = set(range(ln.n_slots)) - accounted
                if missing:
                    problems.append(
                        f"lane {ln.id}: leaked slots {sorted(missing)}")
            for sid, sess in self._sessions.items():
                if sess.lane.sessions.get(sess.slot) is not sess:
                    problems.append(f"session {sid}: dangling slot binding")
        return problems

    def _fetch_ready(self, lane: _Lane, pending) -> bool:
        ready = getattr(lane.enc, "fetch_ready", None)
        if ready is None:
            return True
        try:
            return bool(ready(pending))
        except Exception:
            return True

    def _harvest_oldest(self, lane: _Lane) -> None:
        """Harvest the head of a lane's in-flight window (dispatch order
        is mandatory: per-stripe host state advances per tick)."""
        pending, took, dispatch_iv = lane.inflight_q[0]
        t0 = time.monotonic()
        try:
            out, session_bytes = lane.enc.harvest(pending)
        except Exception:
            with self._lock:
                lane.inflight_q.popleft()
                for sess, slot, _gen in took:
                    lane.slot_errors[slot] += 1
                    lane.health.record_error(slot)
                    sess.inflight = max(0, sess.inflight - 1)
            raise
        # flight-recorder intervals: the mesh encoders report the
        # fetch/concat split of the harvest wall (last_harvest_stages) — D2H
        # materialization rides fetch_wait, host slice-concat/entropy
        # glue rides pack. Encoders without the split (injected fakes)
        # keep the coarse whole-wall fetch_wait attribution.
        t1 = time.monotonic()
        harvest_ms = (t1 - t0) * 1000.0
        stages = getattr(lane.enc, "last_harvest_stages", None)
        if isinstance(stages, dict) and "fetch_ms" in stages:
            t_split = min(t1, t0 + float(stages["fetch_ms"]) / 1000.0)
            trace_iv = {"dispatch": dispatch_iv,
                        "fetch_wait": (t0, t_split),
                        "pack": (t_split, t1)}
        else:
            trace_iv = {"dispatch": dispatch_iv, "fetch_wait": (t0, t1)}
        # encoder-internal stripe-job failures (whole-frame containment
        # withheld the AU without raising) must charge the slot exactly
        # like a harvest raise or an injected fault — otherwise a sick
        # slot freezes its session forever while health records ok
        # and quarantine/migration never fire
        failed = getattr(lane.enc, "last_failed_sessions", None) \
            or frozenset()
        with self._lock:
            if isinstance(stages, dict) and "fetch_ms" in stages:
                # under the lock: stats() sorts these windows while the
                # worker appends — deques must not be mutated mid-iteration
                self._fetch_ms_window.append(float(stages["fetch_ms"]))
                self._concat_ms_window.append(
                    float(stages.get("concat_ms", 0.0)))
            lane.inflight_q.popleft()
            for sess, slot, gen in took:
                sess.inflight = max(0, sess.inflight - 1)
                if slot in failed:
                    lane.slot_errors[slot] += 1
                    lane.health.record_error(slot)
                else:
                    lane.health.record_ok(slot, harvest_ms)
                if sess.closed or sess.gen != gen:
                    # released or migrated mid-flight: the old binding's
                    # pixels must not reach the (re-homed) session
                    continue
                sess.coded_bytes_total += int(session_bytes[slot])
                seq = sess.seq
                sess.seq = seq + 1
                sess.results.append((seq, out[slot]))
                sess.traces[seq] = dict(trace_iv)
                while len(sess.traces) > 32:
                    sess.traces.pop(next(iter(sess.traces)))

    def _unwind_took_locked(self, lane: _Lane, took) -> None:
        """A batch that never reached the in-flight window lost its
        frames: attribute per slot and release the inflight holds."""
        for sess, slot, _gen in took:
            lane.slot_errors[slot] += 1
            lane.health.record_error(slot)
            sess.inflight = max(0, sess.inflight - 1)

    def _tick(self) -> None:
        """One scheduler tick: apply deferred resets, build each lane's
        batch (with slot-fault screening), dispatch/drain every lane's
        bounded in-flight window, then run the quarantine/migration pass.
        Lane failures are contained to the lane (its slots charged, its
        own backoff armed); only whole-tick faults propagate to _run."""
        faults = self.faults
        if faults is not None:
            faults.maybe_raise("mesh.tick_raise")
        now = time.monotonic()
        plans: List[Tuple[_Lane, list, list]] = []
        with self._lock:
            self._retire_idle_lanes_locked(now)
            for sess in self._sessions.values():
                lane = sess.lane
                try:
                    if sess.want_reset:
                        # a new occupant / migration target gets zeroed
                        # prev planes AND a keyframe (reset implies it)
                        lane.enc.reset_session(sess.slot)
                    elif sess.want_key:
                        lane.enc.force_keyframe(sess.slot)
                except Exception:
                    # a broken lane must not take the whole tick down:
                    # charge the slot and let health/quarantine decide
                    lane.slot_errors[sess.slot] += 1
                    lane.health.record_error(sess.slot)
                    logger.exception("lane %d reset/keyframe failed for "
                                     "slot %d", lane.id, sess.slot)
                sess.want_reset = False
                sess.want_key = False
            for lane in self.lanes:
                if now < lane.skip_until:
                    continue
                frames = [None] * lane.n_slots
                took: List[Tuple[_Session, int, int]] = []
                for slot, sess in list(lane.sessions.items()):
                    if sess.pending is None:
                        continue
                    if faults is not None and faults.should_fire_for(
                            "mesh.slot_raise", f"{lane.id}:{slot}", slot):
                        # slot-scoped fault: charge THIS slot and drop its
                        # frame; cohabiting sessions' tick proceeds — a
                        # slot failure must never become a mesh failure
                        lane.slot_errors[slot] += 1
                        lane.health.record_error(slot)
                        self.slot_faults_total += 1
                        sess.pending = None
                        continue
                    frames[slot] = sess.pending
                    sess.pending = None
                    sess.inflight += 1
                    took.append((sess, slot, sess.gen))
                if took or lane.inflight_q:
                    lane.dispatching = took
                    plans.append((lane, frames, took))
        for lane, frames, took in plans:
            self._tick_lane(lane, frames, took)
        self._migrate_sick_sessions()

    def _tick_lane(self, lane: _Lane, frames: list, took: list) -> None:
        dispatched = False
        try:
            # make room FIRST: the window is a hard bound on dispatched-
            # unharvested ticks, so a full window blocks on the oldest
            # fetch BEFORE the new dispatch, never after
            while took and len(lane.inflight_q) >= self.max_inflight:
                self._harvest_oldest(lane)
            t_disp0 = time.monotonic()
            pending = lane.enc.dispatch(frames) if took else None
            if pending is not None:
                with self._lock:
                    lane.inflight_q.append(
                        (pending, took, (t_disp0, time.monotonic())))
                    lane.dispatching = []
                    depth = sum(len(ln.inflight_q) for ln in self.lanes)
                    self.inflight_batches_max = max(
                        self.inflight_batches_max, depth)
                dispatched = True
            elif took:
                # an encoder that swallowed a batch without a pending must
                # not strand the inflight holds (facade.flush would block
                # on them for its full timeout)
                with self._lock:
                    lane.dispatching = []
                    for sess, _slot, _gen in took:
                        sess.inflight = max(0, sess.inflight - 1)
                dispatched = True
            # opportunistic drain: only fetches that already landed are
            # taken here, so this tick's dispatch is never stalled by a
            # slow transfer (the window cap above is the blocking site)
            while lane.inflight_q and self._fetch_ready(
                    lane, lane.inflight_q[0][0]):
                self._harvest_oldest(lane)
        except Exception:
            # lane-contained failure: charge the batch that was lost, arm
            # this lane's own backoff, and keep every other lane ticking
            with self._lock:
                lane.dispatching = []
                if took and not dispatched:
                    self._unwind_took_locked(lane, took)
                lane.error_streak += 1
                lane.skip_until = time.monotonic() + backoff_delay(
                    lane.error_streak, 0.5, 5.0)
            self.tick_errors_total += 1
            logger.exception("mesh lane %d tick failed (streak %d)",
                             lane.id, lane.error_streak)
        else:
            lane.error_streak = 0

    def _retire_idle_lanes_locked(self, now: float) -> None:
        """Rebalance on leave: a drained lane is retired after a grace
        period so its device arrays are freed — except the last healthy
        lane, which stays warm for the next joiner. A drained lane with
        quarantined slots is always retired: that is how a poisoned
        fault domain gets recycled into a fresh one."""
        if self.lane_retire_s < 0:
            return
        for lane in list(self.lanes):
            if lane.sessions or lane.inflight_q:
                lane.idle_since = None
                continue
            if lane.idle_since is None:
                lane.idle_since = now
                continue
            if now - lane.idle_since < self.lane_retire_s:
                continue
            if len(self.lanes) == 1 and not lane.health.quarantined:
                continue
            self.lanes.remove(lane)
            self.lanes_retired_total += 1
            logger.info("mesh lane %d retired (%d lanes live, %d slots "
                        "quarantined)", lane.id, len(self.lanes),
                        len(lane.health.quarantined))

    # -- quarantine + live migration ---------------------------------------

    def _migrate_sick_sessions(self) -> None:
        """Quarantine slots whose error EWMA crossed the threshold and
        re-home their sessions onto healthy slots, preferring a different
        lane (the whole lane may be the sick domain). The facade is
        untouched: only the binding moves, the new slot gets a full reset,
        and the capture loop learns via ``consume_migration()``.

        When no free slot exists anywhere, ONE lane build is attempted
        (outside the main lock — the build blocks only this tick thread,
        which already pays first-dispatch compiles by design, never the
        facades) and the pass retries. Still nowhere to go after that:
        the session keeps serving on the sick slot — degraded beats dead
        — counted once per blocked episode in ``migrations_blocked_total``
        and retried every tick while the EWMA keeps the slot flagged."""
        for attempt in (0, 1):
            with self._lock:
                blocked: List[_Session] = []
                for sess in list(self._sessions.values()):
                    if not sess.lane.health.is_sick(sess.slot):
                        continue
                    dest = self._find_migration_slot_locked(sess.lane)
                    if dest is None:
                        blocked.append(sess)
                        continue
                    self._do_migrate_locked(sess, *dest)
            if not blocked:
                return
            if attempt == 0 and self._build_lane() is not None:
                continue            # retry against the fresh lane
            with self._lock:
                for sess in blocked:
                    if sess.sid not in self._blocked_sids:
                        self._blocked_sids.add(sess.sid)
                        self.migrations_blocked_total += 1
            return

    def _do_migrate_locked(self, sess: _Session, dest_lane: _Lane,
                           dest_slot: int) -> None:
        old_lane, old_slot = sess.lane, sess.slot
        old_lane.health.quarantine(old_slot)
        old_lane.sessions.pop(old_slot, None)
        self.quarantined_total += 1
        dest_lane.sessions[dest_slot] = sess
        dest_lane.idle_since = None
        sess.lane, sess.slot = dest_lane, dest_slot
        sess.gen += 1              # drop the old binding's in-flights
        sess.pending = None        # staged for a dead slot
        sess.want_reset = True
        sess.migrations_pending += 1
        self.migrations_total += 1
        self._blocked_sids.discard(sess.sid)
        logger.warning(
            "session %d migrated off sick slot %d/lane %d -> "
            "slot %d/lane %d (slot quarantined)",
            sess.sid, old_slot, old_lane.id, dest_slot, dest_lane.id)

    def _find_migration_slot_locked(
            self, avoid: _Lane) -> Optional[Tuple[_Lane, int]]:
        candidates = [ln for ln in self.lanes
                      if ln is not avoid and ln.free]
        if not candidates and avoid.free:
            # same lane, different slot: weaker isolation, still a new
            # fault domain at slot granularity
            candidates = [avoid]
        if not candidates:
            return None
        lane = min(candidates, key=lambda ln: ln.error_streak)
        return lane, lane.free.pop(0)
