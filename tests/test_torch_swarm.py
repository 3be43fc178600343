"""The port's lane scheduler against the JAX package's, on the CPU.

* Policy parity: for seeded event sequences on an injected clock, the
  port's ``SlotHealth`` gives the JAX package's scores, verdicts and
  quarantine sets; ``_chips_from_spec`` and ``_sfe_shard_count`` give its
  answers.
* Scheduler parity: the port's ``MeshEncodeCoordinator`` and the JAX
  package's, driven tick by tick over device-free ``FakeMeshEncoder``
  lanes through the same seeded joins, leaves, submits, slot faults and
  lane failures, keep the same slot accounting, lanes, quarantines and
  migrations, and deliver the same results to each session.
* The scheduler scenarios of ``tests/test_swarm.py`` on the port (its
  worker thread running): lanes grow and retire, lane failures stay in
  their lane, a tick fault leaves the worker alive, a sick slot is
  quarantined and its session migrates while its cohabitant streams, a
  blocked migration keeps serving, churn leaks no slot, generations guard
  slot reuse, submit seqs count the in-flight window, an encoder-internal
  failure charges its slot.
* The serving plane through the port's ``ws_handler``: admission queue →
  shed → readmit, a slot freed inside the queue window, a migration that
  restarts the display's frame ids (``PIPELINE_RESETTING``) with its
  restart budget forgiven, the ``system_health`` feed's ``mesh`` key, and
  a small served lane of the real port ``MeshStripeEncoder`` whose first
  stripes equal a solo encoder's.
"""

import asyncio
import json
import random
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.parallel import coordinator as jcoord  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.parallel import coordinator as tcoord  # noqa: E402
from selkies_tpu_torch.parallel.coordinator import (  # noqa: E402
    MeshEncodeCoordinator)
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.robustness import (FakeMeshEncoder,  # noqa: E402
                                          FaultInjector, InProcessClient,
                                          SlotHealth)
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings  # noqa: E402


def make_coord(slots_per_lane=2, max_lanes=3, framerate=200.0,
               lane_retire_s=5.0, sick_errors=3, encs=None, **kw):
    def factory(n):
        enc = FakeMeshEncoder(n)
        if encs is not None:
            encs.append(enc)
        return enc

    return MeshEncodeCoordinator(
        "session:1", slots_per_lane, 64, 48, enc_factory=factory,
        slots_per_lane=slots_per_lane, max_lanes=max_lanes,
        framerate=framerate, health_sick_errors=sick_errors,
        health_window_s=30.0, lane_retire_s=lane_retire_s, **kw)


def pump_until(pred, coord_facades, timeout=5.0, interval=0.005):
    """Submit/poll every facade until pred() or timeout; returns per-
    facade harvested counts."""
    counts = [0] * len(coord_facades)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        for i, f in enumerate(coord_facades):
            if not f.closed:
                f.try_submit(b"frame")
                counts[i] += len(f.poll())
        time.sleep(interval)
    return counts


# ---------------------------------------------------------------------------
# policy parity


def _slot_health_trace(rob, seed):
    """One seeded sequence of errors, oks, clock steps and quarantines on
    an injected clock; every verdict and snapshot along the way."""
    rng = random.Random(seed)
    t = [0.0]
    h = rob.SlotHealth(4, sick_errors=rng.choice([1.0, 2.5, 3.0]),
                       window_s=rng.choice([1.0, 10.0, 30.0]),
                       clock=lambda: t[0])
    out = []
    for _ in range(120):
        op = rng.randrange(6)
        slot = rng.randrange(4)
        if op == 0:
            h.record_error(slot)
        elif op == 1:
            h.record_ok(slot, rng.choice([0.0, 3.5, 17.25]))
        elif op == 2:
            t[0] += rng.choice([0.01, 0.5, 4.0, 25.0])
        elif op == 3 and rng.random() < 0.3:
            h.quarantine(slot)
        out.append((op, slot, h.is_sick(slot), round(h.score(slot), 9),
                    h.state()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_slot_health_policy_equals_jax(seed):
    assert _slot_health_trace(trob, seed) == _slot_health_trace(jrob, seed)


CHIP_SPECS = ["session:2,stripe:3", "session:8", "", " session:2 , ",
              "session:1", "session:banana", "4", "session",
              "session:2,oops"]


def _chips(cls, spec):
    try:
        return cls._chips_from_spec(spec)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", CHIP_SPECS)
def test_chips_from_spec_equals_jax(spec):
    got = _chips(tcoord.MeshEncodeCoordinator, spec)
    assert got == _chips(jcoord.MeshEncodeCoordinator, spec)
    if spec in ("session:banana", "4", "session", "session:2,oops"):
        assert got[0] == "ValueError"       # malformed parts are rejected


def test_sfe_shard_count_policy_equals_jax():
    """Pure split-frame sizing policy: below sfe_min_pixels or on one card
    a session is not split (so on one H100 it is 1 at every geometry);
    above it the frame spans sfe_shards cards (0 = all), clamped to a
    count that tiles the slice."""
    from types import SimpleNamespace as NS

    fourk = NS(sfe_min_pixels=3840 * 2160, sfe_shards=0)
    cases = [(4, 1920, 1080, fourk), (1, 3840, 2160, fourk),
             (4, 3840, 2160, fourk), (8, 7680, 4320, fourk),
             (4, 3840, 2160, NS(sfe_min_pixels=3840 * 2160, sfe_shards=3)),
             (4, 3840, 2160, NS(sfe_min_pixels=0, sfe_shards=0)),
             (4, 3840, 2160, None), (1, 7680, 4320, fourk)]
    got = [tcoord.MeshEncodeCoordinator._sfe_shard_count(*c) for c in cases]
    assert got == [jcoord.MeshEncodeCoordinator._sfe_shard_count(*c)
                   for c in cases]
    assert got == [1, 1, 4, 8, 2, 1, 1, 1]


def test_slot_health_ewma_decay_and_quarantine():
    t = [0.0]
    h = SlotHealth(2, sick_errors=3.0, window_s=10.0, clock=lambda: t[0])
    assert not h.is_sick(0)
    for _ in range(3):
        h.record_error(0)
    assert h.is_sick(0)
    assert not h.is_sick(1)           # the neighbour slot is untouched
    t[0] += 10.0                      # one half-life halves the score
    assert not h.is_sick(0)
    assert h.errors_total[0] == 3     # the lifetime counter never decays
    for _ in range(4):
        h.record_error(1)
    h.quarantine(1)
    assert not h.is_sick(1)           # out of service is not sick
    assert h.state()["quarantined"] == [1]
    h.record_ok(0, latency_ms=10.0)
    h.record_ok(0, latency_ms=20.0)
    assert 10.0 < h.latency_ewma_ms[0] < 20.0


def test_should_fire_for_keyed_arming():
    f = FaultInjector()
    f.arm("mesh.slot_raise", times=2, arg="7:1")
    assert not f.should_fire_for("mesh.slot_raise", "7:0", 0)
    assert "mesh.slot_raise" in f.armed      # a non-match never consumes
    assert f.should_fire_for("mesh.slot_raise", "7:1", 1)
    f.arm("mesh.slot_raise", times=1, arg="1")
    assert f.should_fire_for("mesh.slot_raise", "9:1", 1)
    f.arm("mesh.slot_raise", times=1)        # argless: first site checked
    assert f.should_fire_for("mesh.slot_raise", "3:0", 0)
    assert f.fired["mesh.slot_raise"] >= 3


# ---------------------------------------------------------------------------
# scheduler parity: both packages driven tick by tick


def _hand_driven(mod, rob, encs):
    """A scheduler whose ticks the test runs itself (no worker thread), on
    FakeMeshEncoder lanes of the given package, slots of 2, up to 3 lanes;
    a long health window, so an error's score does not decay between
    ticks, and lanes retire on the tick after they drain."""
    def factory(n):
        enc = rob.FakeMeshEncoder(n)
        encs.append(enc)
        return enc

    coord = mod.MeshEncodeCoordinator(
        "session:1", 2, 64, 48, enc_factory=factory, slots_per_lane=2,
        max_lanes=3, framerate=200.0, health_sick_errors=2.5,
        health_window_s=1e9, lane_retire_s=0.0)
    coord._ensure_thread = lambda: None
    coord.faults = rob.FaultInjector()
    return coord


def _view(coord, facades, lane_ids):
    """What the two packages must agree on, with lane ids renamed by their
    order of creation (the ids come from a process-global counter)."""
    for ln in coord.lanes:
        lane_ids.setdefault(ln.id, len(lane_ids))
    st = coord.stats()
    keep = ("active_sessions", "lanes", "slots_per_lane", "capacity_slots",
            "free_slots", "quarantined_slots", "tick_errors_total",
            "slot_errors", "slot_faults_total", "quarantined_total",
            "migrations_total", "migrations_blocked_total",
            "lanes_built_total", "lanes_retired_total", "inflight_batches",
            "inflight_batches_max")
    lanes = [(lane_ids[ln.id], sorted(ln.free), sorted(ln.sessions),
              sorted(ln.health.quarantined), ln.health.errors_total)
             for ln in coord.lanes]
    sessions = [(None if f.lane_id is None else lane_ids[f.lane_id], f.slot,
                 f.closed) for f in facades]
    cap = coord.capacity()
    # the JAX capacity also reports split-frame keys the port has not
    cap_keep = ("slots_free", "growable_slots", "slots_total",
                "quarantined_slots", "active_sessions", "lanes")
    return ({k: st[k] for k in keep}, {k: cap[k] for k in cap_keep}, lanes,
            sessions, coord.verify_slot_accounting())


def _drive(mod, rob, seed):
    rng = random.Random(seed)
    encs, facades, trace, lane_ids = [], [], [], {}
    coord = _hand_driven(mod, rob, encs)
    try:
        for step in range(160):
            op = rng.randrange(10)
            live = [f for f in facades if not f.closed]
            if op <= 1 or not live:
                facades.append(coord.acquire(64, 48) or _NoSlot())
                trace.append(("acquire", facades[-1].slot))
            elif op == 2:
                f = rng.choice(live)
                f.close()
                trace.append(("release",))
            elif op <= 5:
                for f in live:
                    if rng.random() < 0.8:
                        trace.append(("submit", f.try_submit(b"frame")))
            elif op == 6:
                f = rng.choice(live)
                coord.faults.arm("mesh.slot_raise", times=rng.randrange(1, 4),
                                 arg=f"{f.lane_id}:{f.slot}")
                trace.append(("arm", f.slot))
            elif op == 7:
                k = rng.randrange(len(encs))
                encs[k].fail_dispatches = rng.randrange(1, 3)
                trace.append(("fail", k))
            else:
                f = rng.choice(live)
                f.force_keyframe()
                trace.append(("key",))
            coord._tick()
            # lane backoffs run on the wall clock: lift them so both
            # packages tick every lane on every step
            for ln in coord.lanes:
                ln.skip_until = 0.0
            trace.append([([(seq, [(x.y_start, x.height, x.jpeg)
                                   for x in stripes])
                            for seq, stripes in f.poll()],
                           f.consume_migration())
                          for f in facades if not f.closed])
            trace.append(_view(coord, facades, lane_ids))
            trace.append([(e.dispatches, e.resets, e.keyframes)
                          for e in encs])
    finally:
        coord.stop()
    return trace


class _NoSlot:
    """A join the scheduler had no slot for."""
    closed = True
    slot = lane_id = None

    def close(self):
        pass


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_accounting_quarantine_and_migration_equal_jax(seed):
    """Same seeded joins, leaves, submits, slot faults and lane failures,
    tick by tick: the same slot tables, lanes built and retired, slot
    errors, quarantines and migrations, and the same (seq, stripes) to
    each session."""
    got = _drive(tcoord, trob, seed)
    want = _drive(jcoord, jrob, seed)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"step {k}"
    views = [t for t in got if isinstance(t, tuple) and len(t) == 5]
    assert views[-1][0]["lanes_built_total"] >= 2
    assert any(v[0]["migrations_total"] for v in views)
    assert any(v[0]["tick_errors_total"] for v in views)
    assert all(v[4] == [] for v in views)


# ---------------------------------------------------------------------------
# the scheduler with its worker thread (tests/test_swarm.py's scenarios)


def test_lanes_grow_on_demand_and_retire_when_drained():
    coord = make_coord(slots_per_lane=2, max_lanes=2, lane_retire_s=0.0)
    try:
        fs = [coord.acquire(64, 48) for _ in range(4)]
        assert all(f is not None for f in fs)
        assert coord.stats()["lanes"] == 2          # grew on demand
        assert coord.acquire(64, 48) is None        # genuinely full
        cap = coord.capacity()
        assert cap["slots_free"] == 0 and cap["growable_slots"] == 0
        assert coord.acquire(128, 128) is None      # geometry mismatch
        for f in fs:
            f.close()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and coord.stats()["lanes"] > 1:
            coord._kick.set()
            time.sleep(0.01)
        st = coord.stats()
        assert st["lanes"] == 1                     # one healthy lane warm
        assert st["lanes_retired_total"] >= 1
        assert st["active_sessions"] == 0
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_lane_failure_is_contained_and_attributed():
    """A failing lane charges its own slots and backs off by itself; the
    other lane keeps streaming and flush never wedges."""
    encs = []
    coord = make_coord(slots_per_lane=1, max_lanes=2, encs=encs,
                       sick_errors=100)     # no migration in this test
    try:
        fa = coord.acquire(64, 48)
        fb = coord.acquire(64, 48)          # second lane
        assert coord.stats()["lanes"] == 2
        pump_until(lambda: False, [fa, fb], timeout=0.1)
        encs[0].fail_dispatches = 2
        counts = pump_until(
            lambda: coord.tick_errors_total >= 2, [fa, fb], timeout=5.0)
        st = coord.stats()
        assert st["tick_errors_total"] >= 2
        assert sum(st["slot_errors"]) >= 2          # attributed per slot
        assert counts[1] > 0                        # lane B kept flowing
        assert coord._thread is not None and coord._thread.is_alive()
        t0 = time.monotonic()
        fa.flush()
        assert time.monotonic() - t0 < 3.0
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_tick_raise_fault_hits_every_lane_but_worker_survives():
    coord = make_coord(slots_per_lane=2)
    coord.faults = FaultInjector()
    try:
        f = coord.acquire(64, 48)
        pump_until(lambda: False, [f], timeout=0.1)
        errors_before = coord.tick_errors_total
        coord.faults.arm("mesh.tick_raise", times=1)
        counts = pump_until(
            lambda: coord.tick_errors_total > errors_before
            and coord.faults.fired.get("mesh.tick_raise", 0) >= 1,
            [f], timeout=5.0)
        assert coord.faults.fired["mesh.tick_raise"] == 1
        assert coord.tick_errors_total > errors_before
        n0 = counts[0]
        counts = pump_until(lambda: False, [f], timeout=1.5)
        assert counts[0] > 0 or n0 > 0
        assert coord._thread is not None and coord._thread.is_alive()
    finally:
        coord.stop()


def _migrates(coord, victim, others, lane0, cause):
    """Drive until the victim migrated; return the harvest counts."""
    counts = pump_until(lambda: coord.migrations_total >= 1,
                        [victim] + others, timeout=5.0)
    st = coord.stats()
    assert st["migrations_total"] == 1, cause
    assert st["quarantined_total"] == 1
    assert victim.lane_id != lane0               # rebound, same facade
    assert victim.consume_migration() is True
    assert victim.consume_migration() is False   # one-shot
    return counts


@pytest.mark.parametrize("cause", ["slot_raise", "encoder_internal"])
def test_sick_slot_quarantined_session_migrates(cause):
    """Repeated faults on one slot — injected at frame-take time
    (``mesh.slot_raise``) or reported by the lane encoder's harvest as an
    internal failure (whole-frame containment, nothing raised) — quarantine
    it and migrate its session to a healthy lane; the cohabitant streams
    throughout, and the victim streams again after the move."""
    encs = []
    coord = make_coord(slots_per_lane=2, max_lanes=2, sick_errors=3,
                       encs=encs)
    coord.faults = FaultInjector()
    try:
        victim = coord.acquire(64, 48)
        cohab = coord.acquire(64, 48)
        lane0, slot0 = victim.lane_id, victim.slot
        if cause == "slot_raise":
            coord.faults.arm("mesh.slot_raise", times=4,
                             arg=f"{lane0}:{slot0}")
        else:
            encs[0].fail_sessions.add(slot0)
        counts = _migrates(coord, victim, [cohab], lane0, cause)
        assert counts[1] > 0                     # the cohabitant streamed
        if cause == "slot_raise":
            assert coord.stats()["slot_faults_total"] >= 3
        got = []
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not got:
            victim.try_submit(b"frame")
            got += [r for r in victim.poll() if r[1]]
            time.sleep(0.005)
        assert got                               # streams on the new lane
        assert coord.verify_slot_accounting() == []
        sick_lane = next((ln for ln in coord.lanes if ln.id == lane0), None)
        if sick_lane is not None:
            assert slot0 in sick_lane.health.quarantined
            assert slot0 not in sick_lane.free
    finally:
        coord.stop()


def test_migration_blocked_at_full_occupancy_keeps_serving():
    coord = make_coord(slots_per_lane=1, max_lanes=1, sick_errors=2)
    coord.faults = FaultInjector()
    try:
        f = coord.acquire(64, 48)
        coord.faults.arm("mesh.slot_raise", times=3,
                         arg=f"{f.lane_id}:{f.slot}")
        pump_until(lambda: coord.migrations_blocked_total >= 1, [f],
                   timeout=5.0)
        assert coord.migrations_blocked_total >= 1
        assert coord.migrations_total == 0
        counts = pump_until(lambda: False, [f], timeout=0.6)
        assert counts[0] > 0                     # degraded beats dead
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_churn_storm_no_slot_leaks_and_flush_never_wedges():
    rng = random.Random(7)
    coord = make_coord(slots_per_lane=4, max_lanes=3, lane_retire_s=0.05)
    try:
        live = []
        for step in range(300):
            r = rng.random()
            if r < 0.45 or not live:
                f = coord.acquire(64, 48)
                if f is not None:
                    live.append(f)
            elif r < 0.75:
                f = live.pop(rng.randrange(len(live)))
                f.try_submit(b"parting-frame")
                if rng.random() < 0.5:
                    t0 = time.monotonic()
                    f.flush()
                    assert time.monotonic() - t0 < 3.0
                f.close()
            else:
                f = rng.choice(live)
                f.try_submit(b"frame")
                f.poll()
            if step % 50 == 0:
                assert coord.verify_slot_accounting() == []
        for f in live:
            f.close()
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline \
                and coord.stats()["active_sessions"]:
            time.sleep(0.01)
        assert coord.stats()["active_sessions"] == 0
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_generation_guard_on_slot_reuse():
    coord = make_coord(slots_per_lane=1, max_lanes=1, framerate=50.0)
    try:
        f1 = coord.acquire(64, 48)
        f1.try_submit(b"old-occupant-frame")
        f1.close()
        f2 = coord.acquire(64, 48)
        assert f2 is not None and f2.slot == 0
        f2.try_submit(b"new-occupant-frame")
        got = []
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and not got:
            got = f2.poll()
            time.sleep(0.01)
        assert got and got[0][0] == 0        # fresh seq for the new owner
        assert f1.poll() == []               # the dead facade gets nothing
        assert coord.verify_slot_accounting() == []
    finally:
        coord.stop()


def test_submit_seq_accounts_for_inflight_window():
    coord = make_coord(slots_per_lane=1, max_lanes=1)
    coord.stop()                             # drive ticks by hand
    f = coord.acquire(64, 48)
    coord.stop()
    with coord._lock:
        sess = coord._sessions[f.sid]
        sess.seq = 5
        lane = sess.lane
        lane.inflight_q.append(
            (object(), [(sess, 0, sess.gen)], (0.0, 0.0)))          # live
        lane.inflight_q.append(
            (object(), [(sess, 0, sess.gen - 1)], (0.0, 0.0)))      # stale
    assert f.try_submit(b"frame") == 6       # 5 + 1 live in flight
    assert f.try_submit(b"frame2") is None   # replaced before the tick


def test_worker_thread_runs_with_the_lane_stream_current(monkeypatch):
    """The worker issues the lanes' device work, so every tick runs inside
    its scheduler's stream context (its mesh's first device and that
    device's encoder stream; a no-op for injected lanes and on the CPU),
    entered per tick, not once per thread."""
    inside = {"now": False}
    ticks = []
    coord = make_coord(slots_per_lane=1, max_lanes=1)
    try:
        class _Ctx:
            def __enter__(self):
                inside["now"] = True

            def __exit__(self, *exc):
                inside["now"] = False
                return False

        coord.stop()
        monkeypatch.setattr(coord, "_stream_context", lambda: _Ctx())
        tick = coord._tick
        monkeypatch.setattr(
            coord, "_tick", lambda: (ticks.append(inside["now"]), tick()))
        f = coord.acquire(64, 48)
        assert pump_until(lambda: False, [f], timeout=0.3)[0] > 0
        assert len(ticks) > 1 and all(ticks)
    finally:
        coord.stop()


# ---------------------------------------------------------------------------
# the serving plane through the port's ws_handler


class _SoloEncoder:
    """A display's own encoder when lanes do not take it (device-free)."""

    def __init__(self):
        self.n = 0
        self._ready = []

    def try_submit(self, frame):
        self.n += 1
        self._ready.append((self.n, [trob.FakeStripe()]))
        return self.n

    def poll(self):
        out, self._ready = self._ready, []
        return out

    def force_keyframe(self):
        pass

    def close(self):
        pass


class _Source:
    def __init__(self, width, height, fps):
        self.width, self.height = width, height
        self.k = 0

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        self.k += 1
        rng = np.random.default_rng(self.k)
        return rng.integers(0, 256, (self.height, self.width, 3), np.uint8)


class _StaticSource(_Source):
    """The same frame every tick (which frame a lane tick takes then never
    matters: a facade replaces a frame still waiting for its tick)."""

    def next_frame(self):
        self.k = 0
        return super().next_frame()


def _lane_settings(slots_per_lane, max_lanes, queue_ms, **env):
    return Settings(argv=[], env=dict({
        "SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false",
        "SELKIES_SECOND_SCREEN": "true", "SELKIES_MAX_DISPLAYS": "0",
        "SELKIES_TPU_MESH": "session:1",
        "SELKIES_TPU_SESSIONS_PER_CHIP": str(slots_per_lane),
        "SELKIES_MESH_MAX_LANES": str(max_lanes),
        "SELKIES_ADMISSION_QUEUE_MS": str(queue_ms),
        "SELKIES_WATCHDOG_FRAMES": "0",
        "SELKIES_SUPERVISOR_MAX_RESTARTS": "1000"}, **env))


def make_lane_server(slots_per_lane=1, max_lanes=1, queue_ms=60,
                     sick_errors=None, **env):
    """The port's server with device-free lanes (the real scheduler over
    FakeMeshEncoder) and device-free solo encoders."""
    settings = _lane_settings(slots_per_lane, max_lanes, queue_ms, **env)
    server = tds.DataStreamingServer(
        settings,
        encoder_factory=lambda w, h, s, overrides=None, device=None:
            _SoloEncoder(),
        source_factory=_Source, device="cpu", host="127.0.0.1")

    def coordinator(spec, spc, w, h, **kw):
        if sick_errors is not None:
            kw["health_sick_errors"] = sick_errors
        return MeshEncodeCoordinator(
            spec, spc, w, h, enc_factory=lambda n: FakeMeshEncoder(n),
            slots_per_lane=slots_per_lane, lane_retire_s=0.2, **kw)

    server.coordinator_factory = coordinator
    return server


async def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


async def open_display(server, display_id, w=64, h=48, fps=30):
    ws = InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(lambda: len(ws.sent) >= 2)
    ws.feed("SETTINGS," + json.dumps({
        "displayId": display_id, "initialClientWidth": w,
        "initialClientHeight": h, "framerate": fps}))
    return ws, task


async def reap(ws, task):
    await ws.close()
    try:
        await asyncio.wait_for(task, 5.0)
    except asyncio.TimeoutError:
        task.cancel()


async def frames_flowing(ws, timeout=5.0):
    n0 = len(ws.binary())
    return await wait_until(lambda: len(ws.binary()) > n0, timeout)


def test_admission_queue_then_shed_then_readmit():
    """Capacity 1: the second display queues, then is shed with KILL
    server_full; after the first leaves, a third is admitted."""
    async def run():
        server = make_lane_server(slots_per_lane=1, max_lanes=1)
        try:
            ws1, t1 = await open_display(server, "d1")
            assert await frames_flowing(ws1)
            assert server.mesh_stats["bucketed"] == 1
            ws2, t2 = await open_display(server, "d2")
            assert await wait_until(lambda: ws2.closed)
            assert any("KILL server_full" in t for t in ws2.texts())
            assert server.edge_stats["sessions_queued"] >= 1
            assert server.edge_stats["sessions_rejected"] >= 1
            assert "d2" not in server.display_clients
            await reap(ws2, t2)
            await reap(ws1, t1)                # leave frees the slot
            ws3, t3 = await open_display(server, "d3")
            assert await frames_flowing(ws3)
            assert not ws3.closed
            assert server.scheduler_stats()["active_sessions"] == 1
            assert server.mesh_stats["solo_fallback"] == 0
            await reap(ws3, t3)
        finally:
            await server.stop()
        assert server.mesh_coordinators == {}
    asyncio.run(run())


def test_admission_queue_admits_when_slot_frees_during_wait():
    async def run():
        server = make_lane_server(slots_per_lane=1, max_lanes=1,
                                  queue_ms=1500)
        try:
            ws1, t1 = await open_display(server, "d1")
            assert await frames_flowing(ws1)
            ws2, t2 = await open_display(server, "d2")
            await asyncio.sleep(0.15)
            assert not ws2.closed              # still queued, not shed
            await reap(ws1, t1)
            assert await frames_flowing(ws2)
            assert not ws2.closed              # admitted after the wait
            assert server.edge_stats["sessions_queued"] >= 1
            assert server.edge_stats["sessions_rejected"] == 0
            await reap(ws2, t2)
        finally:
            await server.stop()
    asyncio.run(run())


def test_migration_resets_frame_ids_forgives_budget_and_reaches_health():
    """``mesh.slot_raise`` on one display's slot: the scheduler quarantines
    the slot and migrates the session to a second lane; the display's
    capture loop restarts its frame ids (PIPELINE_RESETTING, the next frame
    is id 1) and forgives its supervisor's restart budget; the cohabitant
    keeps streaming; the system_health feed carries the bucket's ``mesh``
    entry with the quarantine and the migration."""
    async def run():
        server = make_lane_server(slots_per_lane=2, max_lanes=2,
                                  sick_errors=3)
        try:
            ws0, t0 = await open_display(server, "d0")
            ws1, t1 = await open_display(server, "d1")
            assert await frames_flowing(ws0) and await frames_flowing(ws1)
            st = server.display_clients["d0"]
            facade = st.encoder
            lane0 = facade.lane_id
            forgiven = []
            sup = st.supervisor
            real_forgive = sup.forgive
            sup.forgive = lambda: (forgiven.append(True), real_forgive())
            sup._failure_times.append(time.monotonic())   # a past failure
            server.faults.arm("mesh.slot_raise", times=4,
                              arg=f"{lane0}:{facade.slot}")
            coord = next(iter(server.mesh_coordinators.values()))
            assert await wait_until(lambda: coord.migrations_total == 1)
            # the first reset came with the capture loop's start
            assert await wait_until(
                lambda: ws0.texts().count("PIPELINE_RESETTING d0") == 2)
            assert facade.lane_id != lane0
            assert forgiven and not sup._failure_times
            n1 = len(ws1.binary())
            n0 = [k for k, m in enumerate(ws0.sent)
                  if m == "PIPELINE_RESETTING d0"][1]
            assert await wait_until(
                lambda: any(isinstance(m, bytes) for m in ws0.sent[n0:]))
            after = [unpack_binary(m) for m in ws0.sent[n0:]
                     if isinstance(m, bytes)]
            assert after[0].frame_id == 1          # ids restarted
            assert await wait_until(lambda: len(ws1.binary()) > n1)
            health = [json.loads(t) for t in ws0.texts()
                      if '"system_health"' in t]
            mesh = [h["mesh"]["64x48/jpeg"] for h in health if "mesh" in h]
            assert mesh and mesh[-1]["migrations_total"] == 1
            assert mesh[-1]["quarantined_slots"] == 1
            assert mesh[-1]["lanes"] == 2
            payload = json.loads(server._health_payload())
            assert payload["mesh"]["64x48/jpeg"]["active_sessions"] == 2
            assert st.supervisor.state == "running"
            assert server.display_clients["d0"].ladder.rung == "device"
            await reap(ws0, t0)
            await reap(ws1, t1)
            assert coord.verify_slot_accounting() == []
        finally:
            await server.stop()
        assert server._retired == []               # no facade retired
    asyncio.run(run())


def test_served_lane_of_the_real_port_encoder_equals_solo():
    """Two 64x48 JPEG displays ride one lane of the real port
    ``MeshStripeEncoder`` on the CPU through ws_handler; each display's
    first frame's 0x03 stripes equal a solo ``JpegStripeEncoder``'s on the
    same frame."""
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.protocol.wire import pack_jpeg_stripe

    async def run():
        settings = _lane_settings(2, 1, 60, SELKIES_TPU_STRIPE_HEIGHT="16")
        server = tds.DataStreamingServer(
            settings, source_factory=_StaticSource, device="cpu",
            host="127.0.0.1")
        try:
            ws0, t0 = await open_display(server, "d0")
            ws1, t1 = await open_display(server, "d1")
            for ws in (ws0, ws1):
                assert await wait_until(lambda: len(ws.binary()) >= 3, 30.0)
            assert server.mesh_stats == {"bucketed": 2, "solo_fallback": 0}
            coord = server.mesh_coordinators[(64, 48, "jpeg")]
            assert coord.stats()["active_sessions"] == 2
            solo = JpegStripeEncoder(64, 48, stripe_height=16,
                                     quality=settings.jpeg_quality.default,
                                     paintover_quality=settings
                                     .paint_over_jpeg_quality.default,
                                     device="cpu")
            want = [pack_jpeg_stripe(1, s.y_start, s.jpeg)
                    for s in solo.encode_frame(_StaticSource(64, 48, 30)
                                               .next_frame())]
            for ws in (ws0, ws1):
                first = [m for m in ws.binary()
                         if unpack_binary(m).frame_id == 1]
                assert first == want
            await reap(ws0, t0)
            await reap(ws1, t1)
        finally:
            await server.stop()
    asyncio.run(run())
