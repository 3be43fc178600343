"""Chaos harness: a synthetic-capture session of the port under random
fault injection.

Runs an in-process ``DataStreamingServer`` of the port (the real encoder
factory on ``--device``, synthetic capture, an in-process websocket
client: no network, no ``websockets`` package) while arming fault points
at random from the ``SELKIES_TPU_FAULTS`` menu, then checks that the
session is still alive and streaming once the faults stop: supervised
restarts happened, no display reached the terminal ``failed`` state, no
flight-recorder span stayed open, no lane slot leaked, and frames flow
after the last fault.

``--mesh`` serves the session from a lane of the scheduler and draws its
fault kinds too; ``--sfe`` from a split-frame-encoding lane of two stripe
shards (on two cards where there are two, else twice on the one; the
``devices`` argument of :func:`chaos_session` names them), drawing
shard-targeted faults::

    python -m selkies_tpu_torch.tools.chaos_run --duration 10 --seed 0
    python -m selkies_tpu_torch.tools.chaos_run --width 1920 --height 1080 --sfe
    python -m selkies_tpu_torch.tools.chaos_run --device cpu --duration 3
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import logging
import os
import random
import sys
import tempfile
import time

import numpy as np

from ..robustness.testing import InProcessClient as _ChaosClient
from .proto_fuzz import gen_message

#: (point, times, arg) entries the chaos loop draws from: short hangs, so
#: one run goes through both the hang recovery and the watchdog. fetch.hang
#: is armed twice per draw: the capture loop and the async encode driver's
#: harvest each check it, so one draw can wedge either side of the fetch.
FAULT_MENU = (
    ("capture.raise", 1, None),
    ("capture.stall", 1, "0.4"),
    ("encode.raise", 1, None),
    ("fetch.hang", 2, "0.4"),
    ("ws.drop", 1, None),
    ("ws.flood", 1, None),
    ("ws.garbage", 1, None),
    ("session.churn", 1, None),
)

#: the lane scheduler's kinds, drawn with mesh=True: tick_raise fails a
#: whole tick (the worker backs off and survives), slot_raise fails one
#: slot's dispatch (its cohabitants keep streaming; repeated hits
#: quarantine the slot and migrate its session)
MESH_FAULT_MENU = (
    ("mesh.tick_raise", 1, None),
    ("mesh.slot_raise", 3, None),
)

#: the split-frame-encoding kinds, drawn with sfe=True: ``shard:K`` hits
#: one stripe shard of the frame; the scheduler must fail the session's
#: whole tick (never a torn access unit) and, on repeats, quarantine the
#: slot and migrate it
SFE_FAULT_MENU = (
    ("mesh.tick_raise", 1, None),
    ("mesh.slot_raise", 3, "shard:0"),
    ("mesh.slot_raise", 3, "shard:1"),
)

#: fault kinds injected from the client side: a message flood or a
#: garbage burst through the websocket (the rate limiter and the
#: per-message exception boundary), and a storm of short-lived extra
#: clients joining and leaving (admission, fan-out and teardown)
CLIENT_FAULTS = ("ws.flood", "ws.garbage", "session.churn")


async def _churn_burst(server, rng) -> None:
    """session.churn: a burst of short-lived clients joins and leaves
    while the primary session is under fault injection; the scheduler and
    the fan-out tables must absorb it without touching that session."""
    for _ in range(5):
        ws = _ChaosClient()
        task = asyncio.create_task(server.ws_handler(ws))
        await asyncio.sleep(rng.uniform(0.02, 0.08))
        await ws.close()
        try:
            await asyncio.wait_for(task, 2.0)
        except asyncio.TimeoutError:
            task.cancel()


def _inject_client_fault(ws, point: str, rng) -> None:
    """Feed a hostile burst through the in-process client."""
    if point == "ws.flood":
        # an input-plane flood past the token bucket's burst (2000): the
        # limiter drops the tail; none of it may kill the session or
        # starve the capture loop
        for i in range(3000):
            ws.feed(f"m,{rng.randrange(2000)},{rng.randrange(2000)},0,0")
    else:  # ws.garbage
        for _ in range(40):
            ws.feed(gen_message(rng))


def _sfe_devices(device) -> list:
    """The two devices an SFE lane's stripe shards go on: the first two
    cards where there are two, else ``device`` twice (a mesh is never
    folded onto fewer devices, so one card is named twice)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"]
    return [str(dev), str(dev)]


async def chaos_session(duration_s: float = 10.0, seed: int = 0,
                        width: int = 160, height: int = 128,
                        fps: float = 30.0, mesh: bool = False,
                        sfe: bool = False, device=None,
                        devices=None) -> dict:
    """Run one chaos session on ``device`` (None: the card, raising
    without one; with ``sfe``, the lane's shards on ``devices``, by
    default :func:`_sfe_devices`); returns the survival report."""
    from .._device import resolve_device
    from ..parallel.coordinator import MeshEncodeCoordinator
    from ..server.app import StreamingApp
    from ..server.data_server import (DataStreamingServer,
                                      default_encoder_factory)
    from ..settings import Settings

    device = resolve_device(device)
    # ws.garbage bursts may carry FILE_UPLOAD verbs: sandbox them
    # (honoring a caller-provided dir, e.g. pytest's tmp_path)
    if not os.environ.get("SELKIES_UPLOAD_DIR"):
        os.environ["SELKIES_UPLOAD_DIR"] = tempfile.mkdtemp(
            prefix="chaos_uploads_")

    env = {
        "SELKIES_PORT": "0",
        "SELKIES_AUDIO_ENABLED": "false",
        # ws.garbage bursts carry arbitrary text: never let one reach a
        # shell, and never let a garbage SETTINGS start a second encoder
        # pipeline at a random geometry
        "SELKIES_COMMAND_ENABLED": "false",
        "SELKIES_MAX_DISPLAYS": "1",
        # the resolution is pinned: garbage "r,NxM" resizes are the edge
        # fuzzer's business (proto_fuzz); chaos tests the supervision
        "SELKIES_IS_MANUAL_RESOLUTION_MODE": "true",
        # a generous budget: chaos injects faults far faster than
        # production sees them
        "SELKIES_SUPERVISOR_MAX_RESTARTS": "1000",
        "SELKIES_SUPERVISOR_RESTART_WINDOW_S": "60",
        "SELKIES_WATCHDOG_FRAMES": str(int(fps * 2)),   # 2 s deadline
        "SELKIES_LADDER_FAIL_THRESHOLD": "3",
        "SELKIES_LADDER_PROBE_MS": "2000",
    }
    if sfe:
        # the session rides a split-frame-encoding lane: its frame's
        # stripe bands shard over two devices, so shard-targeted
        # mesh.slot_raise arms have a live call site; sfe_min_pixels=1
        # makes any geometry SFE
        env["SELKIES_TPU_MESH"] = "session:2"
        env["SELKIES_SFE_MIN_PIXELS"] = "1"
        env["SELKIES_TPU_SESSIONS_PER_CHIP"] = "1"
    elif mesh:
        # the session rides the lane scheduler instead of a solo encoder,
        # so mesh.tick_raise / mesh.slot_raise have a live call site
        env["SELKIES_TPU_MESH"] = "session:1"
        env["SELKIES_TPU_SESSIONS_PER_CHIP"] = "2"
    settings = Settings(argv=[], env=env)

    # build the kernels and warm the encoder outside the session, so a
    # first build is not read as a stall by the watchdog
    warm = default_encoder_factory(width, height, settings, {},
                                   device=device)
    try:
        warm.submit(np.zeros((height, width, 3), np.uint8))
        warm.flush()
    finally:
        warm.close()
        warm.join(10.0)

    app = StreamingApp(settings)
    server = DataStreamingServer(settings, app=app, host="127.0.0.1",
                                 device=device)
    if sfe:
        server.coordinator_factory = functools.partial(
            MeshEncodeCoordinator,
            devices=list(devices) if devices else _sfe_devices(device))
    app.data_server = server
    rng = random.Random(seed)
    reconnects = 0
    #: supervisors (and their counters) die with their display when
    #: ws.drop churns the client, so totals add up over incarnations: the
    #: loop observes the live counters all along and commits the last
    #: observation when an incarnation ends
    totals = {"restarts": 0, "failures": 0, "watchdog_restarts": 0}
    transitions = []
    last_obs = {}

    def observe():
        nonlocal last_obs
        st = server.display_clients.get("primary")
        if st is not None and st.supervisor is not None:
            sup = st.supervisor.stats()
            last_obs = {
                "restarts": sup["restarts_total"],
                "failures": sup["failures_total"],
                "watchdog_restarts": sup["watchdog_restarts_total"],
                "transitions": list(st.ladder.transitions),
            }

    def commit():
        nonlocal last_obs
        for k in totals:
            totals[k] += last_obs.get(k, 0)
        transitions.extend(last_obs.get("transitions", []))
        last_obs = {}

    async def connect():
        ws = _ChaosClient()
        task = asyncio.create_task(server.ws_handler(ws))
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(ws.sent) < 2:
            await asyncio.sleep(0.01)
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary",
            "initialClientWidth": width, "initialClientHeight": height,
            "framerate": fps}))
        return ws, task

    async def reap(ws, task):
        await ws.close()
        try:
            await asyncio.wait_for(task, 5.0)
        except asyncio.TimeoutError:
            task.cancel()

    ws, task = await connect()
    injected = []
    t_end = time.monotonic() + duration_s
    try:
        while time.monotonic() < t_end:
            await asyncio.sleep(rng.uniform(0.3, 0.7))
            observe()
            if ws.closed:                     # ws.drop churned the client
                commit()
                await reap(ws, task)
                ws, task = await connect()
                reconnects += 1
            menu = FAULT_MENU + (
                SFE_FAULT_MENU if sfe
                else MESH_FAULT_MENU if mesh else ())
            point, times, arg = menu[rng.randrange(len(menu))]
            if point == "session.churn":
                await _churn_burst(server, rng)
            elif point in CLIENT_FAULTS:
                _inject_client_fault(ws, point, rng)
            else:
                server.faults.arm(point, times=times, arg=arg)
            injected.append(point)

        # quiesce and check recovery: no new faults, frames must flow
        server.faults.disarm()
        recovered = False
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            observe()
            if ws.closed:
                commit()
                await reap(ws, task)
                ws, task = await connect()
                reconnects += 1
            st_now = server.display_clients.get("primary")
            if st_now is not None and not st_now.video_active:
                # a ws.garbage burst can carry a legitimate owner
                # STOP_VIDEO; a real client would press play again
                ws.feed("START_VIDEO")
            n0 = ws.n_frames()
            await asyncio.sleep(0.5)
            if not ws.closed and ws.n_frames() > n0:
                recovered = True
                break

        observe()
        commit()
        st = server.display_clients.get("primary")
        report = {
            "duration_s": duration_s,
            "seed": seed,
            "injected": injected,
            "reconnects": reconnects,
            "restarts": totals["restarts"],
            "failures": totals["failures"],
            "watchdog_restarts": totals["watchdog_restarts"],
            "ladder_transitions": transitions,
            "rung": st.ladder.rung if st else None,
            "failed_displays": server._failed_displays(),
            "frames_delivered": ws.n_frames(),
            "protocol_errors": server.edge_stats["protocol_errors"],
            "rate_limited": dict(server.edge_stats["rate_limited"]),
            "slow_client_evictions":
                server.edge_stats["slow_client_evictions"],
        }
        # every span opened during the storm must have reached a terminal
        # mark after teardown, dropped frames included
        coords = list(server.mesh_coordinators.values())
        await reap(ws, task)
        await server.stop()
        report["trace_open_spans"] = server.recorder.open_spans()
        report["frames_traced"] = server.recorder.closed_total
        report["trace_dropped"] = server.recorder.dropped_total
        report["trace_acked"] = server.recorder.acked_total
        leaked_slots = 0
        if coords:
            # nor may the storm strand sessions or slots in the scheduler
            leaked_slots = sum(c.active_sessions for c in coords) + len(
                [p for c in coords for p in c.verify_slot_accounting()])
            report["mesh_leaked_slots"] = leaked_slots
            report["mesh_tick_errors"] = sum(
                c.tick_errors_total for c in coords)
            report["mesh_slot_faults"] = sum(
                c.slot_faults_total for c in coords)
            report["mesh_quarantined"] = sum(
                c.quarantined_total for c in coords)
            report["mesh_migrations"] = sum(
                c.migrations_total for c in coords)
            report["mesh_sfe_shards"] = max(c.sfe_shards for c in coords)
        report["alive"] = (recovered and server._failed_displays() == 0
                           and report["trace_open_spans"] == 0
                           and leaked_slots == 0)
        return report
    finally:
        await reap(ws, task)
        await server.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--mesh", action="store_true",
                   help="serve the session from a lane of the scheduler "
                        "and draw mesh.tick_raise / mesh.slot_raise kinds")
    p.add_argument("--sfe", action="store_true",
                   help="serve the session from a split-frame-encoding "
                        "lane of two stripe shards and draw shard-targeted "
                        "mesh.slot_raise kinds")
    p.add_argument("--device", default=None,
                   help="the server's device (default: the card)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.ERROR)
    report = asyncio.run(chaos_session(
        duration_s=args.duration, seed=args.seed,
        width=args.width, height=args.height, fps=args.fps,
        mesh=args.mesh, sfe=args.sfe, device=args.device))
    print(json.dumps(report, indent=2))
    return 0 if report["alive"] else 1


if __name__ == "__main__":
    sys.exit(main())
