"""Swarm churn harness: many in-process clients against the port's server.

Drives N :class:`~selkies_tpu_torch.robustness.InProcessClient`\\ s through
the port's real ``ws_handler`` (the settings handshake, each display's
capture loop, the lane scheduler with its dynamic lanes, admission
verdicts and slot health, the bounded send queues, the flight recorder)
under a join/leave/resize storm, and reports:

* ``sessions_per_chip``: the peak of concurrently scheduled sessions per
  device;
* ``fairness_jain_index``: Jain's index over the sessions' delivered
  frame rates (1.0 is perfectly fair; a stalled session drags it down);
* ``eviction_ms_p95``: from a client's leave to its slot freed;
* leak-freedom: no leaked slot, no open trace span, and clean lane and
  slot accounting once the storm has drained.

By default the lane encoder is the device-free
:class:`~selkies_tpu_torch.robustness.FakeMeshEncoder` (``--encoder
fake``): the scheduling and serving planes at full churn rate, with
nothing on a device. ``--encoder real`` keeps the port's lane encoders on
``--device`` (the card by default).

``--sick-slot`` arms ``mesh.slot_raise`` against one occupied slot in the
middle of the storm and checks that the victim session is quarantined and
migrated while its cohabitants' frame ids keep advancing::

    python -m selkies_tpu_torch.tools.swarm_run --clients 200 --duration 10 --sick-slot
    python -m selkies_tpu_torch.tools.swarm_run --encoder real --clients 32 --sick-slot
    python -m selkies_tpu_torch.tools.swarm_run --device cpu

Prints one JSON object; exit 0 when the run is leak-free and, where
armed, the sick-slot checks held.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import random
import sys
import time
from typing import Dict, List, Optional

from ..robustness.testing import FakeMeshEncoder, FakeStripe, InProcessClient

#: resize targets: two geometries, so churn moves sessions across buckets
#: without passing the server's cap of 4 buckets
GEOMS = ((128, 96), (160, 128))


class _SwarmSource:
    """Frame source whose frames are opaque tokens: the fake lane encoder
    never looks at pixels, so the capture loop ticks at storm rate
    without image buffers."""

    def __init__(self, width, height, fps, x=0, y=0):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return b"frame"


class _SwarmSoloEncoder:
    """A display's own encoder for the overflow and degraded paths
    (device-free)."""

    def __init__(self):
        self._ready = []
        self._n = 0

    def try_submit(self, frame):
        self._n += 1
        self._ready.append((self._n, [FakeStripe()]))
        return self._n

    def poll(self):
        out, self._ready = self._ready, []
        return out

    def force_keyframe(self):
        pass

    def close(self):
        pass


class _Member:
    """One swarm client and its measurement state."""

    def __init__(self, idx: int, ws, task, display_id: str, geom) -> None:
        self.idx = idx
        self.ws = ws
        self.task = task
        self.display_id = display_id
        self.geom = geom
        self.joined_at = time.monotonic()
        self.left_at: Optional[float] = None
        self.read_pos = 0          # cursor into ws.sent
        self.frames = 0
        self.last_frame_id = 0
        self.shed = False
        self.killed_reason: Optional[str] = None


def _jain(values: List[float]) -> float:
    vals = [v for v in values if v >= 0]
    if not vals:
        return 0.0
    s = sum(vals)
    s2 = sum(v * v for v in vals)
    if s2 <= 0:
        return 0.0
    return (s * s) / (len(vals) * s2)


def _p95(samples: List[float]) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return round(s[min(len(s) - 1, int(len(s) * 0.95))], 2)


async def swarm_run(n_clients: int = 200, duration_s: float = 10.0,
                    seed: int = 0, concurrency: Optional[int] = None,
                    fps: float = 10.0, slots_per_lane: int = 8,
                    max_lanes: int = 4, encoder: str = "fake",
                    sick_slot: bool = False, device=None) -> dict:
    """Run one swarm storm on the port's server (on ``device``: None is
    the card, and raises without one); returns the report."""
    from .._device import resolve_device
    from ..parallel.coordinator import MeshEncodeCoordinator
    from ..protocol import VideoStripe, unpack_binary
    from ..server.app import StreamingApp
    from ..server.data_server import DataStreamingServer
    from ..settings import Settings

    device = resolve_device(device)
    env = {
        "SELKIES_PORT": "0",
        "SELKIES_AUDIO_ENABLED": "false",
        "SELKIES_COMMAND_ENABLED": "false",
        "SELKIES_SECOND_SCREEN": "true",
        # the swarm is the load test: caps off, the scheduler is the gate
        "SELKIES_MAX_CLIENTS": "0",
        "SELKIES_MAX_DISPLAYS": "0",
        "SELKIES_TPU_MESH": "session:1",
        "SELKIES_TPU_SESSIONS_PER_CHIP": str(slots_per_lane),
        "SELKIES_MESH_MAX_LANES": str(max_lanes),
        "SELKIES_ADMISSION_QUEUE_MS": "100",
        "SELKIES_SLOT_QUARANTINE_ERRORS": "3",
        "SELKIES_SLOT_HEALTH_WINDOW_S": "30",
        # generous supervision: churn restarts are expected, not fatal
        "SELKIES_SUPERVISOR_MAX_RESTARTS": "10000",
        "SELKIES_SUPERVISOR_RESTART_WINDOW_S": "60",
        "SELKIES_WATCHDOG_FRAMES": "0",
        "SELKIES_RESIZE_DEBOUNCE_MS": "50",
    }
    settings = Settings(argv=[], env=env)
    app = StreamingApp(settings)

    if encoder == "fake":
        def coordinator_factory(spec, spc, w, h, **kw):
            kw.pop("slots_per_lane", None)
            return MeshEncodeCoordinator(
                spec, spc, w, h, enc_factory=lambda n: FakeMeshEncoder(n),
                slots_per_lane=slots_per_lane,
                lane_retire_s=0.5, **kw)

        server = DataStreamingServer(
            settings, app=app,
            encoder_factory=lambda w, h, s, overrides=None, **kw:
                _SwarmSoloEncoder(),
            source_factory=_SwarmSource, host="127.0.0.1", device=device)
        server.coordinator_factory = coordinator_factory
    else:
        server = DataStreamingServer(settings, app=app, host="127.0.0.1",
                                     device=device)
    app.data_server = server

    rng = random.Random(seed)
    concurrency = int(concurrency or min(n_clients, 64))
    members: List[_Member] = []
    active: List[_Member] = []
    joins = leaves = resizes = 0
    eviction_ms: List[float] = []
    next_idx = 0

    async def join() -> Optional[_Member]:
        nonlocal next_idx, joins
        idx = next_idx
        next_idx += 1
        ws = InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(ws.sent) < 2 \
                and not ws.closed:
            await asyncio.sleep(0.005)
        geom = GEOMS[idx % len(GEOMS)]
        m = _Member(idx, ws, task, f"d{idx}", geom)
        ws.feed("SETTINGS," + json.dumps({
            "displayId": m.display_id,
            "initialClientWidth": geom[0],
            "initialClientHeight": geom[1],
            "framerate": fps}))
        members.append(m)
        active.append(m)
        joins += 1
        return m

    def _facade_of(m: _Member):
        st = server.display_clients.get(m.display_id)
        enc = getattr(st, "encoder", None)
        return enc if enc is not None and hasattr(enc, "sid") else None

    async def leave(m: _Member) -> None:
        nonlocal leaves
        facade = _facade_of(m)
        coord = facade._coord if facade is not None else None
        sid = facade.sid if facade is not None else None
        t0 = time.monotonic()
        await m.ws.close()
        try:
            await asyncio.wait_for(m.task, 5.0)
        except asyncio.TimeoutError:
            m.task.cancel()
        if coord is not None and sid is not None:
            while time.monotonic() - t0 < 2.0:
                if sid not in coord._sessions:
                    eviction_ms.append((time.monotonic() - t0) * 1000.0)
                    break
                await asyncio.sleep(0.002)
        m.left_at = time.monotonic()
        if m in active:
            active.remove(m)
        leaves += 1

    def pump(m: _Member) -> None:
        """Read new server-to-client traffic: count frames, detect KILLs,
        ACK the latest frame id (closing its flight span)."""
        new = m.ws.sent[m.read_pos:]
        m.read_pos += len(new)
        latest = None
        for msg in new:
            if isinstance(msg, (bytes, bytearray)):
                try:
                    f = unpack_binary(bytes(msg))
                except Exception:
                    continue
                if isinstance(f, VideoStripe):
                    m.frames += 1
                    m.last_frame_id = f.frame_id
                    latest = f.frame_id
            elif isinstance(msg, str) and msg.startswith("KILL"):
                m.shed = True
                m.killed_reason = msg[5:40]
        if latest is not None and not m.ws.closed:
            m.ws.feed(f"CLIENT_FRAME_ACK,{latest}")

    # ---- the storm -------------------------------------------------------
    t_start = time.monotonic()
    t_end = t_start + duration_s
    t_fault = t_start + duration_s * 0.45 if sick_slot else None
    fault_report: Dict[str, object] = {}
    peak_sessions = 0
    last_pump = 0.0
    # chance of a leave per 4 ms step: enough replacement churn to reach
    # the distinct-client target inside the window (plus a floor, so
    # small swarms churn too)
    need = max(0, n_clients - concurrency)
    leave_p = max(0.02, (need / max(1.0, duration_s * 0.8)) * 0.004)

    while time.monotonic() < t_end or joins < n_clients:
        now = time.monotonic()
        # fill toward the concurrency target (leavers are replaced by
        # fresh joiners, which count toward the distinct-client goal),
        # then churn: leaves paced to reach that goal in the window, and
        # a trickle of resizes
        if len(active) < concurrency:
            await join()
        elif active and rng.random() < leave_p:
            await leave(rng.choice(active))
        elif active and rng.random() < 0.03:
            m = rng.choice(active)
            if not m.ws.closed:
                w, h = GEOMS[(GEOMS.index(m.geom) + 1) % len(GEOMS)]
                m.geom = (w, h)
                m.ws.feed(f"r,{w}x{h},{m.display_id}")
                resizes += 1
        if now - last_pump > 0.05:
            last_pump = now
            for m in list(active):
                pump(m)
                if m.ws.closed and m in active:   # the server killed it
                    active.remove(m)
            peak_sessions = max(peak_sessions, sum(
                c.active_sessions
                for c in server.mesh_coordinators.values()))
        if t_fault is not None and now >= t_fault:
            t_fault = None
            fault_report = await _inject_sick_slot(server, active, pump)
        await asyncio.sleep(0.004)
        if time.monotonic() - t_start > duration_s * 6 + 60:
            break   # hard stop: a wedged storm must not hang its caller

    # ---- drain and leak checks ---------------------------------------------
    coords = list(server.mesh_coordinators.values())
    for m in list(active):
        pump(m)
    while active:
        await leave(active[0])
    # clients the server kicked (shed, superseded, slow) left `active`
    # without a reap: their handler tasks still own display teardown, so
    # wait for every one before judging leaks
    for m in members:
        if m.task is not None and not m.task.done():
            if not m.ws.closed:
                await m.ws.close()
            try:
                await asyncio.wait_for(m.task, 3.0)
            except asyncio.TimeoutError:
                m.task.cancel()
            except Exception:
                pass
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and any(
            c.active_sessions for c in coords):
        await asyncio.sleep(0.01)
    leaked_slots = sum(c.active_sessions for c in coords)
    accounting = [p for c in coords for p in c.verify_slot_accounting()]
    migrations = sum(getattr(c, "migrations_total", 0) for c in coords)
    quarantined = sum(c.stats()["quarantined_slots"] for c in coords)
    slot_faults = sum(getattr(c, "slot_faults_total", 0) for c in coords)
    await server.stop()
    open_spans = server.recorder.open_spans()

    chips = max((getattr(c, "chips", 1) for c in coords), default=1)
    rates = []
    for m in members:
        end = m.left_at or time.monotonic()
        dt = end - m.joined_at
        if dt >= 0.5 and not m.shed:
            rates.append(m.frames / dt)
    sick_ok = (not sick_slot) or (
        bool(fault_report.get("victim_migrated"))
        and fault_report.get("cohabitants_stalled") == 0)
    report = {
        "metric": "swarm_churn",
        "swarm_clients": joins,
        "duration_s": round(time.monotonic() - t_start, 2),
        "seed": seed,
        "concurrency": concurrency,
        "encoder": encoder,
        "joins": joins, "leaves": leaves, "resizes": resizes,
        "sessions_peak": peak_sessions,
        "sessions_per_chip": round(peak_sessions / max(1, chips), 2),
        "fairness_jain_index": round(_jain(rates), 4),
        "eviction_ms_p95": _p95(eviction_ms),
        "eviction_samples": len(eviction_ms),
        "frames_delivered_total": sum(m.frames for m in members),
        "sessions_shed": sum(1 for m in members if m.shed),
        "sessions_queued": server.edge_stats["sessions_queued"],
        "sessions_rejected": server.edge_stats["sessions_rejected"],
        "migrations": migrations,
        "migrations_blocked": sum(
            getattr(c, "migrations_blocked_total", 0) for c in coords),
        "quarantined_slots": quarantined,
        "slot_faults_injected": slot_faults,
        "leaked_slots": leaked_slots,
        "slot_accounting_violations": accounting,
        "trace_open_spans": open_spans,
        **fault_report,
    }
    report["alive"] = (leaked_slots == 0 and open_spans == 0
                       and not accounting and sick_ok)
    return report


async def _inject_sick_slot(server, active, pump) -> Dict[str, object]:
    """Arm mesh.slot_raise against one occupied slot and check that the
    victim migrates while its cohabitants' frame ids advance.

    If the victim leaves during the injection (its slot goes idle, so the
    remaining arms never fire), a fresh victim is picked and armed: up to
    3 attempts."""

    def _sid_to_member():
        out = {}
        for m in active:
            st = server.display_clients.get(m.display_id)
            enc = getattr(st, "encoder", None)
            if enc is not None and hasattr(enc, "sid"):
                out[enc.sid] = m
        return out

    def _pick():
        """A lane with at least 2 sessions whose chosen victim is still an
        active, streaming swarm member."""
        members = _sid_to_member()
        for coord in server.mesh_coordinators.values():
            with coord._lock:
                for lane in coord.lanes:
                    if len(lane.sessions) < 2:
                        continue
                    for slot, sess in lane.sessions.items():
                        if sess.sid in members:
                            return (coord, lane.id, slot, sess.sid,
                                    members)
        return None

    result: Dict[str, object] = {"victim_migrated": False,
                                 "cohabitants_stalled": 0}

    def _migrations_all() -> int:
        return sum(c.migrations_total
                   for c in server.mesh_coordinators.values())

    migrations_global = _migrations_all()
    for _attempt in range(3):
        target = _pick()
        if target is None:
            result["sick_slot_skipped"] = True
            return result
        coord, lane_id, slot, victim_sid, members = target
        victim = members[victim_sid]
        cohort = [m for sid, m in members.items() if sid != victim_sid]
        before = {m.idx: m.frames for m in cohort}
        server.faults.arm("mesh.slot_raise",
                          times=int(coord._health_sick_errors) + 1,
                          arg=f"{lane_id}:{slot}")
        # generous: at scale the event loop lags and stretches the
        # victim's submit cadence (one fault fires per victim tick); a
        # migration is counted globally, so a re-picked attempt still
        # credits an earlier attempt's late migration
        deadline = time.monotonic() + 8.0
        migrated = False
        while time.monotonic() < deadline:
            if _migrations_all() > migrations_global:
                migrated = True
                break
            if victim_sid not in coord._sessions:
                break           # the victim left; pick again below
            await asyncio.sleep(0.02)
        server.faults.disarm("mesh.slot_raise")
        result.update({
            "victim_client": victim.idx,
            "sick_lane": lane_id,
            "sick_slot": slot,
            "cohabitants": len(cohort),
        })
        if migrated:
            await asyncio.sleep(0.4)    # let frames flow after migrating
            for m in cohort:
                pump(m)
            stalled = [m.idx for m in cohort
                       if not m.ws.closed and m in active
                       and m.frames <= before[m.idx]]
            result["victim_migrated"] = True
            result["cohabitants_stalled"] = len(stalled)
            return result
        if victim_sid in coord._sessions:
            return result       # armed and present, never migrated: fail
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=200,
                   help="distinct clients joined over the storm")
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--concurrency", type=int, default=None,
                   help="most clients connected at once")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--slots-per-lane", type=int, default=8)
    p.add_argument("--max-lanes", type=int, default=4)
    p.add_argument("--encoder", choices=("fake", "real"), default="fake")
    p.add_argument("--sick-slot", action="store_true",
                   help="fault one occupied slot mid-storm and check "
                        "quarantine and live migration")
    p.add_argument("--device", default=None,
                   help="the server's device (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR)
    report = asyncio.run(swarm_run(
        n_clients=args.clients, duration_s=args.duration, seed=args.seed,
        concurrency=args.concurrency, fps=args.fps,
        slots_per_lane=args.slots_per_lane, max_lanes=args.max_lanes,
        encoder=args.encoder, sick_slot=args.sick_slot, device=args.device))
    print(json.dumps(report, indent=2))
    return 0 if report["alive"] else 1


if __name__ == "__main__":
    sys.exit(main())
