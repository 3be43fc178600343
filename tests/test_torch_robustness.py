"""Supervision, the degradation ladder and fault injection in the port,
against the JAX package on the CPU.

* Policy parity: for seeded sequences of events on an injected clock, the
  port's ``FaultInjector``, ``DegradationLadder``, ``backoff_delay`` and
  ``Supervisor`` give the JAX package's results.
* Server scenarios (the scenarios of ``tests/test_robustness.py``, on the
  port's server, with device-free fake encoders): a capture crash restarts
  without killing the session, the ladder degrades and recovers, a stalled
  fetch trips the watchdog, step-downs do not exhaust the budget, bottom-rung
  errors walk the ladder and then fail, budget exhaustion fails and tears
  the display down, ``ws.drop`` leaves the server healthy, the bind backoff
  gives up; restarts do not grow the retired-encoder list.
* The real ``x264enc-striped`` encoder at 256x128: ``encode.raise*3`` steps
  it to the host rung, whose first 0x04 frame equals the JAX package's host
  rung IDR, byte for byte.
* The ``system_health`` display entry equals the JAX server's for the same
  ladder, supervisor and encoder state.
"""

import asyncio
import json
import random
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import pytest

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.capture.synthetic import SyntheticSource  # noqa: E402
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings  # noqa: E402

PACKAGES = [pytest.param(jrob, id="jax"), pytest.param(trob, id="port")]

# ---------------------------------------------------------------------------
# policy parity


def _injector_trace(rob, seed):
    """Apply one seeded sequence of arm/check/disarm operations; return
    what each returned, with ``fired`` and ``armed`` after each."""
    rng = random.Random(seed)
    points = list(rob.POINTS)
    f = rob.FaultInjector("capture.raise*2,fetch.hang*1=1.5,ws.drop")
    out = []
    for _ in range(60):
        op = rng.randrange(7)
        p = rng.choice(points)
        if op == 0:
            n = rng.randrange(1, 4)
            arg = rng.choice([None, "0:1", "3", "2.5"])
            spec = f"{p}*{n}" + (f"={arg}" if arg else "")
            f.arm_spec(spec)
            res = spec
        elif op == 1:
            res = f.should_fire(p)
        elif op == 2:
            res = f.should_fire_for(p, rng.choice(["0:1", "3", "9"]),
                                    rng.randrange(4))
        elif op == 3:
            try:
                f.maybe_raise(p)
                res = None
            except rob.FaultInjected as e:
                res = (type(e).__name__, e.point, str(e))
        elif op == 4:
            f.disarm(rng.choice([None, p]))
            res = "disarm"
        elif op == 5:
            res = f._take(p)
        else:
            try:
                f.arm_spec(rng.choice(["no.such.point", "bad spec*", ""]))
                res = "ok"
            except ValueError:
                res = "ValueError"
        out.append((res, dict(f.fired), sorted(f.armed)))
    f.reset()
    out.append((f.armed, f.fired))
    return out


def _ladder_trace(rob, seed):
    rng = random.Random(seed)
    now = [0.0]
    lad = rob.DegradationLadder(fail_threshold=rng.randrange(1, 4),
                                probe_after_s=rng.choice([0.5, 2.0, 5.0]),
                                clock=lambda: now[0])
    out = []
    for _ in range(80):
        op = rng.randrange(4)
        if op == 0:
            res = lad.record_failure()
        elif op == 1:
            res = lad.record_success()
        elif op == 2:
            res = lad.force_step_down()
        else:
            now[0] += rng.choice([0.1, 0.6, 2.5])
            res = now[0]
        out.append((res, lad.rung, lad.level, lad.degraded, lad.state()))
    out.append(list(lad.transitions))
    return out


def _backoff_trace(rob, seed):
    rng = random.Random(seed)
    draw = random.Random(seed + 1)
    return [rob.backoff_delay(rng.randrange(-1, 40), rng.choice([0.05, 0.5]),
                              rng.choice([2.0, 10.0]),
                              jitter=rng.choice([0.0, 0.25, 0.5]), rng=draw)
            for _ in range(50)]


@pytest.mark.parametrize("trace", [_injector_trace, _ladder_trace,
                                   _backoff_trace],
                         ids=["FaultInjector", "DegradationLadder",
                              "backoff_delay"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_parity_with_jax(trace, seed):
    """Tolerance 0: the same results, step by step."""
    assert trace(trob, seed) == trace(jrob, seed)
    assert trob.POINTS == jrob.POINTS and trob.RUNGS == jrob.RUNGS
    assert trob.DEFAULT_HANG_S == jrob.DEFAULT_HANG_S


def test_fault_injector_hang_is_cancellable():
    async def run():
        f = trob.FaultInjector("capture.stall=30")
        t = asyncio.ensure_future(f.maybe_hang("capture.stall"))
        await asyncio.sleep(0.05)
        assert not t.done()
        t.cancel()
        with pytest.raises(asyncio.CancelledError):
            await t
        # disarmed after firing once
        await asyncio.wait_for(f.maybe_hang("capture.stall"), 1.0)
        g = trob.FaultInjector("fetch.hang=0.05")
        t0 = time.monotonic()
        g.maybe_hang_sync("fetch.hang")
        assert time.monotonic() - t0 >= 0.05
        assert g.fired == {"fetch.hang": 1} and g.armed == ()
    asyncio.run(run())


@pytest.mark.parametrize("rob", PACKAGES)
@pytest.mark.parametrize("case", ["crash", "budget", "watchdog"])
def test_supervisor_parity(rob, case):
    """The same supervised child gives the same counts in both packages:
    two crashes then a run; a child that always crashes (budget 3 + the
    final straw, terminal); a first run that stalls without beating."""
    async def run():
        events = []
        runs = []
        ran = asyncio.Event()

        async def child():
            runs.append(1)
            if case == "budget" or (case == "crash" and len(runs) <= 2):
                raise RuntimeError("boom")
            if case == "watchdog" and len(runs) == 1:
                await asyncio.sleep(3600)
            while True:
                sup.beat()
                ran.set()
                await asyncio.sleep(0.01)

        sup = rob.Supervisor(
            "t", child, base_delay_s=0.005, max_delay_s=0.02, max_restarts=3,
            restart_window_s=30.0,
            watchdog_timeout_s=0.2 if case == "watchdog" else None,
            on_event=lambda k, i: events.append(k), rng=random.Random(0))
        task = asyncio.create_task(sup.run())
        if case == "budget":
            await asyncio.wait_for(task, 10.0)
        else:
            await asyncio.wait_for(ran.wait(), 10.0)
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        st = sup.stats()
        return (st["state"], st["failures_total"],
                st["watchdog_restarts_total"], st["restarts_total"],
                [e for e in events if e != "restart"])

    state, failures, watchdogs, restarts, events = asyncio.run(run())
    want = {"crash": ("stopped", 2, 0, 2, ["failure", "failure"]),
            "budget": ("failed", 4, 0, 3, ["failure"] * 4 + ["failed"]),
            "watchdog": ("stopped", 0, 1, 1, ["watchdog"])}[case]
    assert (state, failures, watchdogs, restarts, events) == want


# ---------------------------------------------------------------------------
# server scenarios with device-free fakes


@dataclass
class FakeStripe:
    """Packs as a 0x03 JPEG stripe (no ``annexb``)."""

    y_start: int
    jpeg: bytes


class FakeEncoder:
    """Device-free served encoder; records the overrides it was built with,
    so rung switches are observable."""

    def __init__(self, overrides=None):
        ov = overrides or {}
        self.entropy = ov.get("tpu_entropy", "device")
        self.profile = ov.get("encoder", "")
        self.submitted = 0
        self.closed = False
        self.on_error = None
        self._ready = []

    def try_submit(self, frame):
        self.submitted += 1
        jpeg = b"\xff\xd8FAKE%d\xff\xd9" % self.submitted
        self._ready.append((self.submitted, [FakeStripe(0, jpeg)]))
        return self.submitted

    def poll(self):
        out, self._ready = self._ready, []
        return out

    def force_keyframe(self):
        pass

    def stats(self):
        return {"frames_dropped": 0, "encode_errors": 0}

    def close(self):
        self.closed = True


class SickEncoder(FakeEncoder):
    """Every harvest reports an error through ``on_error`` (as the threaded
    adapter does) and delivers nothing."""

    def poll(self):
        if self.on_error is not None:
            self.on_error(RuntimeError("sick"))
        return []


class FakeSource:
    def __init__(self, width, height, fps):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return np.zeros((self.height, self.width, 3), np.uint8)


GEOM = {"displayId": "primary", "initialClientWidth": 320,
        "initialClientHeight": 240, "framerate": 60}


def make_server(encoder_cls=FakeEncoder, **env):
    settings = Settings(argv=[], env=dict(
        {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false"}, **env))
    built = []

    def factory(w, h, s, overrides=None, device=None):
        enc = encoder_cls(overrides)
        built.append(enc)
        return enc

    server = tds.DataStreamingServer(
        settings, encoder_factory=factory,
        source_factory=lambda w, h, fps: FakeSource(w, h, fps),
        device="cpu", host="127.0.0.1")
    return server, built


async def wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


async def open_client(server, body=GEOM):
    ws = trob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(lambda: len(ws.sent) >= 2)
    assert ws.sent[0] == "MODE websockets"
    if body is not None:
        ws.feed("SETTINGS," + json.dumps(body))
    return ws, task


async def close_client(server, ws, task):
    await ws.close()
    await asyncio.wait_for(task, 10.0)
    await server.stop()


def health_of(ws, display="primary"):
    return [json.loads(t)["displays"].get(display) for t in ws.texts()
            if '"system_health"' in t]


def display(server):
    return server.display_clients.get("primary")


def test_capture_crash_restarts_without_killing_session():
    async def run():
        server, built = make_server(SELKIES_SUPERVISOR_MAX_RESTARTS="10",
                                    SELKIES_WATCHDOG_FRAMES="0")
        server.faults.arm("capture.raise", times=2)
        ws, task = await open_client(server)
        assert await wait_until(
            lambda: display(server) and display(server).supervisor
            and display(server).supervisor.failures_total >= 2)
        st = display(server)
        n0 = len(ws.binary())
        assert await wait_until(lambda: len(ws.binary()) > n0 + 2)
        assert not ws.closed
        assert st.supervisor.state in ("running", "backoff")
        assert st.supervisor.failures_total == 2
        assert len(built) >= 3                   # one encoder per (re)start
        assert server.faults.fired["capture.raise"] == 2
        first = unpack_binary(ws.binary()[0])
        assert first.frame_id == 1
        assert "PIPELINE_RESETTING primary" in ws.texts()
        assert any(h["failures"] == 2 for h in health_of(ws))
        await close_client(server, ws, task)
    asyncio.run(run())


def test_ladder_degrades_to_host_and_recovers_to_device():
    async def run():
        server, built = make_server(SELKIES_SUPERVISOR_MAX_RESTARTS="20",
                                    SELKIES_WATCHDOG_FRAMES="0",
                                    SELKIES_LADDER_FAIL_THRESHOLD="3",
                                    SELKIES_LADDER_PROBE_MS="300")
        server.faults.arm("encode.raise", times=3)
        ws, task = await open_client(server)
        assert await wait_until(lambda: any(e.entropy == "host"
                                            for e in built))
        st = display(server)
        host_at = next(i for i, e in enumerate(built) if e.entropy == "host")
        assert "device->host" in st.ladder.transitions
        # a clean probe window steps it back up: a later encoder is built
        # at device entropy again
        assert await wait_until(lambda: any(e.entropy == "device"
                                            for e in built[host_at + 1:]))
        assert st.ladder.transitions == ["device->host", "host->device"]
        assert st.ladder.rung == "device" and st.ladder.failures_total == 3
        rungs = [h["rung"] for h in health_of(ws)]
        assert "host" in rungs and "device" in rungs
        n0 = len(ws.binary())
        assert await wait_until(lambda: len(ws.binary()) > n0 + 2)
        await close_client(server, ws, task)
    asyncio.run(run())


def test_stalled_fetch_trips_watchdog():
    async def run():
        server, built = make_server(SELKIES_SUPERVISOR_MAX_RESTARTS="10",
                                    SELKIES_WATCHDOG_FRAMES="30")
        server.faults.arm("fetch.hang", times=1)
        ws, task = await open_client(server)
        assert await wait_until(
            lambda: display(server) and display(server).supervisor
            and display(server).supervisor.watchdog_restarts_total >= 1,
            timeout=15.0)
        st = display(server)
        assert st.supervisor.failures_total == 0     # a stall, not a crash
        n0 = len(ws.binary())
        assert await wait_until(lambda: len(ws.binary()) > n0 + 2)
        assert any(h["watchdog_restarts"] >= 1 for h in health_of(ws))
        assert st.ladder.rung == "device" and st.ladder.failures_total == 0
        await close_client(server, ws, task)
    asyncio.run(run())


def test_ladder_stepdowns_do_not_exhaust_restart_budget():
    """6 encoder faults with a budget of 3: each step-down forgives the
    budget, so the display walks device → host → jpeg instead of dying."""
    async def run():
        server, built = make_server(
            SELKIES_SUPERVISOR_MAX_RESTARTS="3",
            SELKIES_SUPERVISOR_RESTART_WINDOW_S="60",
            SELKIES_WATCHDOG_FRAMES="0", SELKIES_LADDER_FAIL_THRESHOLD="2",
            SELKIES_LADDER_PROBE_MS="600000")
        server.faults.arm("encode.raise", times=6)
        ws, task = await open_client(server)
        assert await wait_until(lambda: display(server) is not None)
        st = display(server)
        assert await wait_until(lambda: st.ladder.rung == "jpeg")
        assert st.ladder.transitions == ["device->host", "host->jpeg"]
        assert not st.failed and st.supervisor.state != trob.FAILED
        assert await wait_until(lambda: any(
            e.profile == "jpeg" and e.entropy == "host" and e.submitted > 0
            for e in built))
        n0 = len(ws.binary())
        assert await wait_until(lambda: len(ws.binary()) > n0 + 2)
        await close_client(server, ws, task)
    asyncio.run(run())


def test_bottom_rung_persistent_errors_walk_ladder_then_fail():
    async def run():
        server, built = make_server(
            SickEncoder, SELKIES_SUPERVISOR_MAX_RESTARTS="2",
            SELKIES_WATCHDOG_FRAMES="0", SELKIES_LADDER_FAIL_THRESHOLD="2",
            SELKIES_LADDER_PROBE_MS="600000")
        ws, task = await open_client(server)
        assert await wait_until(lambda: display(server) is not None)
        st = display(server)
        # errors reported off the loop walk the whole ladder down ...
        assert await wait_until(lambda: st.ladder.rung == "jpeg")
        assert st.ladder.transitions[:2] == ["device->host", "host->jpeg"]
        assert any(e.entropy == "host" and e.profile == "" for e in built)
        assert await wait_until(lambda: any(e.profile == "jpeg"
                                            for e in built))
        # ... and at the bottom rung they force supervised rebuilds until
        # the budget marks the display failed
        assert await wait_until(lambda: st.failed, timeout=20.0)
        assert not ws.closed
        await close_client(server, ws, task)
    asyncio.run(run())


def test_restart_budget_exhaustion_fails_display_and_tears_down():
    async def run():
        server, built = make_server(SELKIES_SUPERVISOR_MAX_RESTARTS="2",
                                    SELKIES_SUPERVISOR_RESTART_WINDOW_S="60",
                                    SELKIES_WATCHDOG_FRAMES="0")
        server.faults.arm("capture.raise", times=50)   # crash every run
        ws, task = await open_client(server)
        assert await wait_until(lambda: display(server) is not None
                                and display(server).failed)
        st = display(server)
        # the failed event tears the whole display down, the sibling
        # backpressure loop included
        assert await wait_until(lambda: st.capture_task is None
                                and st.backpressure_task is None)
        assert server._failed_displays() == 1
        assert not ws.closed                 # the session itself survives
        assert any(h["failed"] for h in health_of(ws))
        # an explicit START_VIDEO clears the marker and recovers
        server.faults.disarm()
        ws.feed("START_VIDEO")
        assert await wait_until(lambda: not st.failed
                                and st.capture_task is not None)
        n0 = len(ws.binary())
        assert await wait_until(lambda: len(ws.binary()) > n0)
        assert server._failed_displays() == 0
        await close_client(server, ws, task)
    asyncio.run(run())


def test_ws_drop_fault_closes_client_server_survives():
    async def run():
        server, built = make_server(SELKIES_TPU_FAULTS="ws.drop")
        ws, task = await open_client(server)
        assert await wait_until(lambda: ws.closed)
        await asyncio.wait_for(task, 5.0)        # the handler exited
        assert await wait_until(lambda: display(server) is None)
        ws2, task2 = await open_client(server)
        assert await wait_until(lambda: len(ws2.binary()) >= 2)
        assert server.faults.fired == {"ws.drop": 1}
        await close_client(server, ws2, task2)
    asyncio.run(run())


def test_run_server_bind_backoff_gives_up(monkeypatch):
    import sys
    import types

    calls = []

    def serve(*a, **k):
        calls.append(1)
        raise OSError(98, "address in use")

    ws = types.ModuleType("websockets")
    ws_asyncio = types.ModuleType("websockets.asyncio")
    ws_server = types.ModuleType("websockets.asyncio.server")
    ws_server.serve = serve
    ws.asyncio = ws_asyncio
    ws_asyncio.server = ws_server
    monkeypatch.setitem(sys.modules, "websockets", ws)
    monkeypatch.setitem(sys.modules, "websockets.asyncio", ws_asyncio)
    monkeypatch.setitem(sys.modules, "websockets.asyncio.server", ws_server)
    server, _ = make_server()
    server.BIND_MAX_ATTEMPTS = 3
    server.BIND_BASE_DELAY_S = 0.01
    server.BIND_MAX_DELAY_S = 0.02
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="could not bind"):
        asyncio.run(asyncio.wait_for(server.run_server(), 10.0))
    assert len(calls) == 3
    assert time.monotonic() - t0 < 5.0


def test_stop_display_teardown_is_exception_safe():
    async def run():
        server, _ = make_server()
        st = tds.DisplayState(display_id="primary")

        async def bad_cleanup():
            try:
                await asyncio.sleep(3600)
            except asyncio.CancelledError:
                raise RuntimeError("cleanup raised instead of cancelling")

        closed = []

        class Enc:
            def close(self):
                closed.append(True)
                raise RuntimeError("close also raised")

        st.capture_task = asyncio.create_task(bad_cleanup())
        st.backpressure_task = asyncio.create_task(asyncio.sleep(3600))
        st.encoder = Enc()
        await asyncio.sleep(0.05)
        await asyncio.wait_for(server._stop_display(st), 5.0)
        assert st.capture_task is None and st.backpressure_task is None
        assert st.encoder is None and closed == [True]
    asyncio.run(run())


def test_unchanged_settings_keep_the_pipeline_and_changed_restart_it():
    """A SETTINGS from the display's owner that changes neither geometry
    nor settings keeps the running pipeline (no rebuild, no reset); one
    that changes the framerate restarts it."""
    async def run():
        server, built = make_server()
        ws, task = await open_client(server)
        assert await wait_until(lambda: len(ws.binary()) >= 2)
        ws.feed("SETTINGS," + json.dumps(GEOM))
        await asyncio.sleep(0.2)
        assert len(built) == 1
        assert ws.texts().count("PIPELINE_RESETTING primary") == 1
        ws.feed("SETTINGS," + json.dumps(dict(GEOM, framerate=30)))
        assert await wait_until(lambda: len(built) == 2)
        assert display(server).running_config[1] == 30.0
        await close_client(server, ws, task)
    asyncio.run(run())


def test_restarts_keep_the_retired_list_bounded(monkeypatch):
    """20 supervised restarts of one display on the real JPEG encoder
    (each behind its async driver thread): the retired list keeps only
    encoders whose threads still run, at most 2 once they have finished."""
    monkeypatch.setattr(tds, "Supervisor", partial(
        trob.Supervisor, base_delay_s=0.001, max_delay_s=0.005))

    async def run():
        server = tds.DataStreamingServer(
            Settings(argv=[], env={"SELKIES_PORT": "0",
                                   "SELKIES_SUPERVISOR_MAX_RESTARTS": "30",
                                   "SELKIES_WATCHDOG_FRAMES": "0"}),
            source_factory=lambda w, h, fps: SyntheticSource(
                w, h, fps, pattern="static"),
            device="cpu", host="127.0.0.1")
        server.faults.arm("capture.raise", times=20)
        ws, task = await open_client(server, dict(
            GEOM, initialClientWidth=128, initialClientHeight=96))
        assert await wait_until(
            lambda: display(server) and display(server).supervisor
            and display(server).supervisor.failures_total == 20, 60.0)
        assert await wait_until(lambda: len(ws.binary()) >= 2, 30.0)
        assert not display(server).failed
        assert len(server._retired) <= 2
        await close_client(server, ws, task)
        assert server._retired == []
    asyncio.run(run())


# ---------------------------------------------------------------------------
# the real encoder at the host rung, against the JAX package


def test_x264enc_striped_steps_to_host_rung_with_jax_identical_idr():
    """encode.raise*3 (armed through SELKIES_TPU_FAULTS) steps a real
    x264enc-striped display to the host rung; its first 0x04 frame after
    PIPELINE_RESETTING is an IDR equal, byte for byte, to the JAX
    package's host-rung encoder on the same source frame."""
    from selkies_tpu.encoder.h264 import H264StripeEncoder as JaxEncoder
    from selkies_tpu.protocol import pack_h264_stripe as jax_pack

    w, h = 256, 128
    env = {"SELKIES_PORT": "0", "SELKIES_TPU_STRIPE_HEIGHT": "64",
           "SELKIES_ENCODER": "x264enc-striped",
           "SELKIES_TPU_FAULTS": "encode.raise*3",
           "SELKIES_LADDER_PROBE_MS": "600000",
           "SELKIES_WATCHDOG_FRAMES": "0"}

    def source(sw, sh, fps):
        return SyntheticSource(sw, sh, fps, pattern="desktop", seed=5)

    s = Settings(argv=[], env=dict(env))
    first = source(w, h, 30).next_frame()
    jenc = JaxEncoder(w, h, stripe_height=64, qp=s.h264_crf.default,
                      paint_over_qp=s.h264_paintover_crf.default,
                      entropy="host")
    want = [jax_pack(1, st.y_start, st.width, st.height, st.annexb,
                     st.is_key) for st in jenc.encode_frame(first)]

    async def run():
        server = tds.DataStreamingServer(Settings(argv=[], env=dict(env)),
                                         source_factory=source, device="cpu",
                                         host="127.0.0.1")
        ws, task = await open_client(server, dict(
            GEOM, initialClientWidth=w, initialClientHeight=h,
            framerate=30))
        assert await wait_until(lambda: len(ws.binary()) >= 2, 60.0)
        st = display(server)
        assert st.ladder.transitions == ["device->host"]
        assert type(st.encoder).__name__ == "ThreadedEncoderAdapter"
        assert server.faults.fired == {"encode.raise": 3}
        sent = list(ws.sent)
        await close_client(server, ws, task)
        return sent

    sent = asyncio.run(run())
    first_bin = next(i for i, m in enumerate(sent) if isinstance(m, bytes))
    assert "PIPELINE_RESETTING primary" in sent[:first_bin]
    got = [bytes(m) for m in sent[first_bin:]
           if isinstance(m, bytes) and unpack_binary(m).frame_id == 1]
    assert got == want
    assert all(m[0] == 0x04 and m[1] == 1 for m in got)        # IDR


# ---------------------------------------------------------------------------
# the health feed against the JAX server's


@pytest.mark.parametrize("events", ["fresh", "degraded", "failed"])
def test_health_entry_equals_jax_server(events):
    from selkies_tpu.server.data_server import DataStreamingServer as JServer
    from selkies_tpu.server.data_server import DisplayState as JDisplay
    from selkies_tpu.settings import Settings as JSettings

    env = {"SELKIES_PORT": "0"}
    jserver = JServer(JSettings(argv=[], env=dict(env)), host="127.0.0.1")
    server = tds.DataStreamingServer(Settings(argv=[], env=dict(env)),
                                     device="cpu", host="127.0.0.1")

    class Enc:
        def stats(self):
            return {"frames_dropped": 7, "encode_errors": 2, "frames": 90}

    def drive(srv, rob, st):
        now = [0.0]
        st.ladder = rob.DegradationLadder(fail_threshold=2, clock=lambda: now[0])
        if events == "fresh":
            return
        st.supervisor = rob.Supervisor("capture:d", lambda: None)
        for _ in range(5):
            st.ladder.record_failure()
            now[0] += 1.0
        st.supervisor.state = "backoff"
        st.supervisor.restarts_total, st.supervisor.failures_total = 6, 5
        st.supervisor.watchdog_restarts_total = 1
        st.encoder = Enc()
        if events == "failed":
            st.failed = True
            st.supervisor = None
            st.encoder = None

    payloads = []
    for srv, rob, cls in ((jserver, jrob, JDisplay),
                          (server, trob, tds.DisplayState)):
        for did in ("primary", "d1"):
            st = cls(display_id=did)
            drive(srv, rob, st)
            srv.display_clients[did] = st
        payloads.append(json.loads(srv._health_payload()))
    want, got = payloads
    assert got == want
    assert set(got["displays"]["primary"]) >= {
        "rung", "ladder", "failed", "supervisor", "restarts", "failures",
        "watchdog_restarts"}
