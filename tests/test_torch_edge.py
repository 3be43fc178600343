"""The port's wire edge against the JAX server's (the scenarios of
``tests/test_edge.py``).

* The pure ``ratelimit`` primitives: the scenarios of ``test_edge.py`` on
  both packages, and seeded, clock-injected operation sequences (drawn by
  hypothesis) whose every result must equal the JAX module's.
* The server scenarios: the same scripted client messages go through the
  JAX server's ``ws_handler`` and the port's, with the same device-free
  fake encoder and source, both driven by in-process clients. The outgoing
  text messages, ``edge_stats`` and the files left in the upload directory
  must be equal. Where a count depends on the wall clock (token refill, a
  debounce window), each connection's guard runs on a frozen clock, or
  both servers are held to the JAX test's bounds.
"""

import asyncio
import json
import os
import random
import time
from functools import partial

import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as hst

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.server import app as japp  # noqa: E402
from selkies_tpu.server import data_server as jds  # noqa: E402
from selkies_tpu.settings import Settings as JSettings  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import app as tapp  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings as TSettings  # noqa: E402
from tools.proto_fuzz import gen_message  # noqa: E402

ROB = [pytest.param(jrob, id="jax"), pytest.param(trob, id="port")]


# ---------------------------------------------------------------------------
# ratelimit primitives: the scenarios of test_edge.py on both packages


@pytest.mark.parametrize("rob", ROB)
def test_token_bucket_refill_and_burst(rob):
    now = [0.0]
    b = rob.TokenBucket(rate=10.0, burst=5.0, clock=lambda: now[0])
    assert all(b.try_take() for _ in range(5))
    assert not b.try_take()
    now[0] = 0.3
    assert b.try_take() and b.try_take() and b.try_take()
    assert not b.try_take()
    now[0] = 100.0
    assert b.tokens == 5.0


@pytest.mark.parametrize("rob", ROB)
def test_parse_limit_spec_overrides_and_rejects(rob):
    limits = rob.parse_limit_spec("settings=2:10,mic=512000")
    assert limits["settings"] == (2.0, 10.0)
    assert limits["mic"] == (512000.0, 1024000.0)
    assert limits == jrob.parse_limit_spec("settings=2:10,mic=512000")
    for bad in ("nosuchclass=5", "settings=-1", "garbage"):
        with pytest.raises(ValueError):
            rob.parse_limit_spec(bad)


def test_classify_verb_table_equals_jax():
    verbs = ["SETTINGS", "cmd", "START_VIDEO", "STOP_VIDEO", "START_AUDIO",
             "STOP_AUDIO", "r", "s", "CLIENT_FRAME_ACK", "_f", "_l",
             "SET_NATIVE_CURSOR_RENDERING", "FILE_UPLOAD_START",
             "FILE_UPLOAD_END", "FILE_UPLOAD_ERROR", "kd", "m", "m2", "js",
             "cw", "pong", "whatever", ""]
    assert [trob.classify_verb(v) for v in verbs] == \
        [jrob.classify_verb(v) for v in verbs]
    assert trob.DEFAULT_LIMITS == jrob.DEFAULT_LIMITS
    assert trob.MESSAGE_CLASSES == jrob.MESSAGE_CLASSES
    assert trob.UPLOAD_VERB_COST == jrob.UPLOAD_VERB_COST


@pytest.mark.parametrize("rob", ROB)
def test_allow_clamps_units_to_burst(rob):
    now = [0.0]
    g = rob.ConnectionGuard(limits={"mic": (100.0, 50.0)},
                            clock=lambda: now[0])
    assert g.allow("mic", 500)
    assert not g.allow("mic", 500)
    now[0] = 0.5
    assert g.allow("mic", 500)


@pytest.mark.parametrize("rob", ROB)
def test_upload_bytes_are_paced_not_dropped(rob):
    now = [0.0]
    b = rob.TokenBucket(rate=100.0, burst=50.0, clock=lambda: now[0])
    assert b.take_with_debt(50) == 0.0
    assert b.take_with_debt(100) == pytest.approx(1.0)
    now[0] = 2.0
    assert b.take_with_debt(1) == 0.0
    g = rob.ConnectionGuard(limits={"upload": (100.0, 50.0)},
                            clock=lambda: now[0])
    assert g.throttle("upload", 10) == 0.0
    assert g.throttle("upload", 1000) > 0.0
    assert g.throttle("upload", 10 ** 9) <= 30.0


@pytest.mark.parametrize("rob", ROB)
def test_connection_guard_error_budget_refills(rob):
    now = [0.0]
    g = rob.ConnectionGuard(error_budget=3, error_refill_per_s=1.0,
                            clock=lambda: now[0])
    assert [g.record_error() for _ in range(4)] == [False] * 3 + [True]
    now[0] = 2.0
    assert not g.record_error()
    assert g.errors_total == 5


@pytest.mark.parametrize("rob", ROB)
def test_bounded_send_queue_drop_oldest_video_never_control(rob):
    now = [0.0]
    q = rob.BoundedSendQueue(max_video=3, evict_after_s=1.0,
                             clock=lambda: now[0])
    q.offer("control-1", control=True)
    for i in range(3):
        q.offer(b"v%d" % i)
    assert q.offer(b"v3") is False
    assert q.dropped_video_total == 1 and q.overflow_since == 0.0
    assert [q.pop() for _ in range(4)] == ["control-1", b"v1", b"v2", b"v3"]
    assert q.pop() is None and q.overflow_since is None
    for i in range(10):
        q.offer(b"x%d" % i)
    assert not q.should_evict
    now[0] = 2.0
    q.offer(b"y")
    assert q.should_evict


# -- seeded operation sequences: every result equal to the JAX module's --

_ops = hst.lists(hst.tuples(hst.integers(0, 5), hst.floats(0.0, 2.0),
                            hst.floats(0.0, 300.0)), min_size=1, max_size=60)


def _bucket_trace(rob, rate, burst, ops):
    now = [0.0]
    b = rob.TokenBucket(rate, burst, clock=lambda: now[0])
    out = []
    for kind, dt, n in ops:
        now[0] += dt
        if kind < 3:
            out.append(b.try_take(n / 10.0))
        elif kind < 5:
            out.append(b.take_with_debt(n))
        else:
            out.append(b.tokens)
    return out


@hsettings(max_examples=60, deadline=None)
@given(rate=hst.floats(0.5, 500.0), burst=hst.floats(1.0, 1000.0), ops=_ops)
def test_token_bucket_sequences_equal_jax(rate, burst, ops):
    assert _bucket_trace(trob, rate, burst, ops) == \
        _bucket_trace(jrob, rate, burst, ops)


def _guard_trace(rob, spec, budget, ops):
    now = [0.0]
    g = rob.ConnectionGuard(limits=rob.parse_limit_spec(spec),
                            error_budget=budget, error_refill_per_s=0.5,
                            clock=lambda: now[0])
    classes = list(rob.MESSAGE_CLASSES) + ["unmetered"]
    out = []
    for kind, dt, n in ops:
        now[0] += dt
        cls = classes[int(n) % len(classes)]
        if kind < 3:
            out.append(g.allow(cls, n))
        elif kind < 5:
            out.append(g.throttle(cls, n * 1e4))
        else:
            out.append(g.record_error())
    return out + [g.errors_total]


@hsettings(max_examples=60, deadline=None)
@given(spec=hst.sampled_from(["", "input=50:100", "settings=2:10,mic=512000",
                              "resize=5,upload=1000:2000,control=3"]),
       budget=hst.integers(1, 30), ops=_ops)
def test_connection_guard_sequences_equal_jax(spec, budget, ops):
    assert _guard_trace(trob, spec, budget, ops) == \
        _guard_trace(jrob, spec, budget, ops)


def _queue_trace(rob, max_video, evict_s, ops):
    now = [0.0]
    q = rob.BoundedSendQueue(max_video=max_video, evict_after_s=evict_s,
                             clock=lambda: now[0])
    dropped = []
    q.on_drop = dropped.append
    out = []
    for k, (kind, dt, n) in enumerate(ops):
        now[0] += dt
        if kind < 2:
            out.append(q.offer(b"v%d" % k))
        elif kind == 2:
            out.append(q.offer("c%d" % k, control=True))
        elif kind < 5:
            out.append(q.pop())
        else:
            out.append(q.should_evict)
        out.append((len(q), q.video_len, q.dropped_video_total,
                    q.overflow_since))
    return out, dropped


@hsettings(max_examples=60, deadline=None)
@given(max_video=hst.integers(1, 8), evict_s=hst.floats(0.0, 3.0), ops=_ops)
def test_bounded_send_queue_sequences_equal_jax(max_video, evict_s, ops):
    assert _queue_trace(trob, max_video, evict_s, ops) == \
        _queue_trace(jrob, max_video, evict_s, ops)


# ---------------------------------------------------------------------------
# server scenarios: the same client messages through both servers


class FakeStripe:
    def __init__(self, n):
        self.y_start, self.height = 0, 64
        self.jpeg = b"\xff\xd8FAKE%d\xff\xd9" % n
        self.is_paintover = False


class FakeEncoder:
    """Speaks both servers' encoder surface: one stripe per frame."""

    def __init__(self):
        self.submitted = 0
        self.closed = False
        self.dropped = 0
        self._ready = []

    def try_submit(self, frame):
        self.submitted += 1
        self._ready.append((self.submitted, [FakeStripe(self.submitted)]))
        return self.submitted

    submit = try_submit

    def poll(self):
        out, self._ready = self._ready, []
        return out

    def flush(self):
        return self.poll()

    def force_keyframe(self):
        pass

    def stats(self):
        return {"frames_dropped": self.dropped, "encode_errors": 0}

    def close(self):
        self.closed = True


class FakeSource:
    def __init__(self, width, height, fps):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return np.zeros((self.height, self.width, 3), np.uint8)


class _Pkg:
    def __init__(self, name, ds, app, settings, rob):
        self.name, self.ds, self.app_mod = name, ds, app
        self.Settings, self.rob = settings, rob

    def __repr__(self):
        return self.name


JAX = _Pkg("jax", jds, japp, JSettings, jrob)
PORT = _Pkg("port", tds, tapp, TSettings, trob)


def make_server(pkg, **env):
    full = {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false",
            "SELKIES_COMMAND_ENABLED": "false"}
    full.update(env)
    settings = pkg.Settings(argv=[], env=full)
    app = pkg.app_mod.StreamingApp(settings)
    kw = {"device": "cpu"} if pkg is PORT else {}
    server = pkg.ds.DataStreamingServer(
        settings, app=app,
        encoder_factory=lambda w, h, s, overrides=None, device=None:
            FakeEncoder(),
        source_factory=lambda w, h, fps, **_kw: FakeSource(w, h, fps),
        host="127.0.0.1", **kw)
    app.data_server = server
    return server


def freeze_guard_clock(monkeypatch):
    """Each connection's guard on a clock that never advances: buckets
    never refill, so what is limited depends on the messages alone."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.ds, "ConnectionGuard", partial(
            pkg.rob.ConnectionGuard, clock=lambda: 0.0))


async def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return False


async def open_client(pkg, server, settings_body=None, ws=None):
    ws = ws or pkg.rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(
        lambda: len(ws.sent) >= 2 or task.done(), timeout=5.0)
    if settings_body is not None:
        ws.feed("SETTINGS," + json.dumps(settings_body))
    return ws, task


async def close_client(ws, task):
    await ws.close()
    try:
        await asyncio.wait_for(task, 5.0)
    except asyncio.TimeoutError:
        task.cancel()


def texts(ws):
    """The client's text messages, less the stats feed's (clock-paced)."""
    return [t for t in ws.texts() if not t.startswith('{"type": "system_')
            and '"network_stats"' not in t and '"gpu_stats"' not in t]


def run_both(scenario, *args):
    """(JAX result, port result) of one async scenario."""
    return tuple(asyncio.run(scenario(pkg, *args)) for pkg in (JAX, PORT))


PRIMARY = {"displayId": "primary", "initialClientWidth": 320,
           "initialClientHeight": 240, "framerate": 60}


def test_handshake_sends_the_last_cursor_first():
    async def scenario(pkg):
        server = make_server(pkg)
        server.app.send_cursor({"curdata": "AAAA", "handle": 7})
        ws, task = await open_client(pkg, server)
        ws.feed("SET_NATIVE_CURSOR_RENDERING,1")
        assert await wait_until(lambda: len(ws.texts()) >= 4)
        await close_client(ws, task)
        await server.stop()
        return ws.texts()

    jax, port = run_both(scenario)
    assert port == jax
    assert port[1] == 'cursor,{"curdata": "AAAA", "handle": 7}' == port[3]


def test_fuzz_corpus_kills_no_sessions(tmp_path, monkeypatch):
    monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(tmp_path / "up"))
    jax, port = run_both(fuzz_session, 500, 0, 10 ** 6)
    for rep in (jax, port):
        assert rep["premature_deaths"] == 0, rep
        assert rep["kills"] == 0, rep
        assert rep["uploads_leaked"] == 0, rep
        assert rep["observer_alive"] and rep["observer_streaming"], rep
        assert rep["protocol_errors"] > 0, rep
    for key in ("protocol_errors", "rate_limited", "sessions_rejected",
                "reconnects", "files"):
        assert port[key] == jax[key], key


def test_fuzz_long_run_survives(tmp_path, monkeypatch):
    monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(tmp_path / "up"))
    jax, port = run_both(fuzz_session, 400, 99, 5)
    for rep in (jax, port):
        assert rep["kills"] >= 1, rep
        assert rep["premature_deaths"] == 0, rep
        assert rep["observer_alive"], rep
    for key in ("protocol_errors", "kills", "reconnects", "files"):
        assert port[key] == jax[key], key


async def fuzz_session(pkg, iterations, seed, error_budget):
    """tools/proto_fuzz.fuzz_session for either server: one observer
    streams while a fuzz client sends ``gen_message``'s corpus. Every
    guard reads one clock that advances 1 ms per read, so what is limited
    depends on the messages alone, the same on both servers."""
    clock = iter(range(10 ** 9))
    guard = partial(pkg.rob.ConnectionGuard,
                    clock=lambda: next(clock) / 1000.0)
    server = make_server(pkg, SELKIES_PROTOCOL_ERROR_BUDGET=str(error_budget),
                         SELKIES_MAX_DISPLAYS="8",
                         SELKIES_RESIZE_DEBOUNCE_MS="50")
    orig = pkg.ds.ConnectionGuard
    pkg.ds.ConnectionGuard = guard
    rng = random.Random(seed)
    rep = {"kills": 0, "premature_deaths": 0, "reconnects": 0}

    async def drain(ws, task):
        await wait_until(lambda: task.done() or ws._incoming.empty(), 20.0)

    try:
        observer, obs_task = await open_client(pkg, server, {
            "displayId": "primary", "initialClientWidth": 64,
            "initialClientHeight": 48, "framerate": 30})
        fuzz, fuzz_task = await open_client(pkg, server)
        fed = 0
        while fed < iterations:
            for _ in range(min(25, iterations - fed)):
                fuzz.feed(gen_message(rng))
                fed += 1
            await drain(fuzz, fuzz_task)
            if fuzz_task.done() or fuzz.closed:
                killed = any(isinstance(m, str) and m.startswith("KILL")
                             for m in fuzz.sent)
                rep["kills" if killed else "premature_deaths"] += 1
                await fuzz.close()
                await asyncio.wait_for(fuzz_task, 10.0)
                fuzz, fuzz_task = await open_client(pkg, server)
                rep["reconnects"] += 1
        await drain(fuzz, fuzz_task)
        await fuzz.close()
        await asyncio.wait_for(fuzz_task, 10.0)
        n0 = observer.n_frames()
        await wait_until(lambda: observer.n_frames() > n0, 15.0)
        root = os.environ["SELKIES_UPLOAD_DIR"]
        rep.update({
            "observer_alive": not observer.closed and not obs_task.done(),
            "observer_streaming": observer.n_frames() > n0,
            "uploads_leaked": len(server._uploads),
            "protocol_errors": server.edge_stats["protocol_errors"],
            "rate_limited": dict(server.edge_stats["rate_limited"]),
            "sessions_rejected": server.edge_stats["sessions_rejected"],
            "files": sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs),
        })
        await close_client(observer, obs_task)
        return rep
    finally:
        pkg.ds.ConnectionGuard = orig
        await server.stop()


def test_resize_storm_coalesces_reconfigures():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_RESIZE_DEBOUNCE_MS="150")
        ws, task = await open_client(pkg, server, PRIMARY)
        viewer, viewer_task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: viewer.n_frames() >= 2)
            runs0 = server.edge_stats["reconfigure_runs"]
            n0 = viewer.n_frames()
            for i in range(50):
                ws.feed(f"r,{320 + 2 * (i % 7)}x{240 + 2 * (i % 5)},primary")
            assert await wait_until(lambda: ws._incoming.empty())
            assert await wait_until(
                lambda: not server._reconfig_dirty
                and (server._reconfig_task is None
                     or server._reconfig_task.done()))
            runs = server.edge_stats["reconfigure_runs"] - runs0
            absorbed = (server.edge_stats["reconfigure_coalesced"]
                        + server.edge_stats["rate_limited"].get("resize", 0))
            assert await wait_until(lambda: viewer.n_frames() > n0 + 2)
            st = server.display_clients["primary"]
            res = [json.loads(t) for t in ws.texts()
                   if '"stream_resolution"' in t]
            return {"runs_ok": 1 <= runs <= 3, "absorbed_ok": absorbed >= 40,
                    "viewer_closed": viewer.closed,
                    "geometry": (st.width, st.height),
                    "last_resolution": res[-1] if res else None}
        finally:
            await close_client(viewer, viewer_task)
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["runs_ok"] and port["absorbed_ok"] and not port["viewer_closed"]


class StalledClient:
    """A consumer whose reads stall after the handshake: ``send`` blocks
    forever once ``stall`` is set."""

    def __init__(self, base):
        self.base = base
        self.stall = False

    def __getattr__(self, name):
        return getattr(self.base, name)

    async def send(self, message):
        if self.stall:
            await asyncio.Event().wait()
        await self.base.send(message)

    def __aiter__(self):
        return self.base.__aiter__()


def test_stalled_consumer_evicted_healthy_keeps_streaming():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_MAX_SEND_QUEUE="8",
                             SELKIES_SLOW_CLIENT_EVICT_S="0")
        owner, owner_task = await open_client(pkg, server, PRIMARY)
        slow = StalledClient(pkg.rob.InProcessClient())
        slow, slow_task = await open_client(pkg, server, ws=slow)
        try:
            assert await wait_until(lambda: owner.n_frames() >= 2)
            assert await wait_until(lambda: slow.n_frames() >= 1)
            slow.stall = True
            assert await wait_until(
                lambda: server.edge_stats["slow_client_evictions"] >= 1,
                timeout=15.0)
            assert await wait_until(lambda: slow.closed)
            ids = [unpack_binary(m).frame_id for m in owner.binary()[-2:]]
            assert await wait_until(
                lambda: unpack_binary(owner.binary()[-1]).frame_id > max(ids))
            return {"evictions": server.edge_stats["slow_client_evictions"],
                    "owner_closed": owner.closed, "slow_closed": slow.closed,
                    "slow_kill_sent": "KILL slow_consumer" in slow.texts()}
        finally:
            await close_client(slow, slow_task)
            await close_client(owner, owner_task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["evictions"] == 1 and not port["owner_closed"]


def test_max_clients_rejects_with_kill_server_full():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_MAX_CLIENTS="2")
        ws1, t1 = await open_client(pkg, server, PRIMARY)
        ws2, t2 = await open_client(pkg, server)
        try:
            ws3 = pkg.rob.InProcessClient()
            t3 = asyncio.create_task(server.ws_handler(ws3))
            await asyncio.wait_for(t3, 5.0)
            n_clients = len(server.clients)
            assert await wait_until(lambda: ws2.n_frames() >= 1)
            await close_client(ws2, t2)
            ws4, t4 = await open_client(pkg, server)
            ws4_closed = ws4.closed
            await close_client(ws4, t4)
            return {"ws3": ws3.sent, "ws3_closed": ws3.closed,
                    "clients": n_clients, "ws4_closed": ws4_closed,
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws1, t1)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["ws3"] == ["KILL server_full"] and port["ws3_closed"]
    assert port["edge"]["sessions_rejected"] == 1 and port["clients"] == 2


def test_max_displays_rejects_further_pipelines():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_MAX_DISPLAYS="1")
        ws1, t1 = await open_client(pkg, server, PRIMARY)
        ws2, t2 = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: "primary" in server.display_clients)
            ws2.feed("SETTINGS," + json.dumps({"displayId": "display2"}))
            assert await wait_until(lambda: ws2.closed)
            return {"ws2": texts(ws2), "ws1_closed": ws1.closed,
                    "displays": sorted(server.display_clients),
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws2, t2)
            await close_client(ws1, t1)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert "KILL server_full" in port["ws2"] and port["displays"] == ["primary"]


def test_load_shedding_rejects_new_connections():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_SHED_DROP_THRESHOLD="10")
        ws1, t1 = await open_client(pkg, server, PRIMARY)
        try:
            assert await wait_until(lambda: "primary" in server.display_clients)
            st = server.display_clients["primary"]
            assert await wait_until(lambda: st.encoder is not None)
            enc = FakeEncoder()
            st.encoder = enc
            steps = []
            for dropped in (20, 40):
                enc.dropped = dropped
                server._update_load_shed()
                steps.append(server._load_shedding)
            ws2 = pkg.rob.InProcessClient()
            await asyncio.wait_for(server.ws_handler(ws2), 5.0)
            verdict = server._display_admission_verdict(64, 48, {})
            for dropped in (15, 15):
                enc.dropped = dropped
                server._update_load_shed()
                steps.append(server._load_shedding)
            ws3, t3 = await open_client(pkg, server)
            ws3_closed = ws3.closed
            await close_client(ws3, t3)
            return {"steps": steps, "ws2": ws2.sent, "verdict": verdict,
                    "ws3_closed": ws3_closed, "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws1, t1)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["steps"] == [False, True, True, False]
    assert port["ws2"] == ["KILL server_full"] and port["verdict"] == "shed"


def test_malformed_messages_never_kill_session():
    async def scenario(pkg):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            assert await wait_until(lambda: ws.n_frames() >= 1)
            for bad in ("KILL you", "PIPELINE_RESETTING primary",
                        b"\x7fgarbage", b"", b"\x00\x01\x00\x02fullframe",
                        "SETTINGS,[]"):
                ws.feed(bad)
            assert await wait_until(
                lambda: server.edge_stats["protocol_errors"] >= 6)
            n0 = ws.n_frames()
            assert await wait_until(lambda: ws.n_frames() > n0 + 2)
            return {"alive": not ws.closed and not task.done(),
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["alive"] and port["edge"]["protocol_errors"] == 6


def test_error_budget_exhaustion_kills_only_abuser(monkeypatch):
    freeze_guard_clock(monkeypatch)

    async def scenario(pkg):
        server = make_server(pkg, SELKIES_PROTOCOL_ERROR_BUDGET="5")
        owner, owner_task = await open_client(pkg, server, PRIMARY)
        abuser, abuser_task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: owner.n_frames() >= 1)
            for _ in range(10):
                abuser.feed(b"\xee hostile binary")
            await asyncio.wait_for(abuser_task, 5.0)
            n0 = owner.n_frames()
            assert await wait_until(lambda: owner.n_frames() > n0 + 2)
            return {"abuser": texts(abuser), "abuser_closed": abuser.closed,
                    "owner_closed": owner.closed,
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(abuser, abuser_task)
            await close_client(owner, owner_task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["abuser"][-1] == "KILL protocol_abuse"
    assert port["edge"]["protocol_errors"] == 6 and not port["owner_closed"]


def test_input_flood_is_rate_limited_not_fatal(monkeypatch):
    freeze_guard_clock(monkeypatch)

    async def scenario(pkg):
        server = make_server(pkg, SELKIES_RATE_LIMITS="input=50:100")
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            assert await wait_until(lambda: ws.n_frames() >= 1)
            for i in range(500):
                ws.feed(f"m,{i},{i},0,0")
            assert await wait_until(lambda: ws._incoming.empty())
            n0 = ws.n_frames()
            assert await wait_until(lambda: ws.n_frames() > n0)
            return {"closed": ws.closed, "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["edge"]["rate_limited"] == {"input": 400}
    assert not port["closed"]


def _upload_files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


def run_upload_scenario(tmp_path, monkeypatch, scenario):
    """Run ``scenario`` against both servers, each with its own upload
    directory; returns (JAX, port) results with the files left there."""
    out = []
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(root))
        res = asyncio.run(scenario(pkg, root))
        res["files"] = _upload_files(root)
        out.append(res)
    return out


def test_upload_cleanup_on_disconnect(tmp_path, monkeypatch):
    async def scenario(pkg, root):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed("FILE_UPLOAD_START:partial.bin:1000")
            ws.feed(b"\x01" + b"x" * 100)
            assert await wait_until(lambda: ws in server._uploads
                                    and server._uploads[ws].received == 100)
            up = server._uploads[ws]
            await close_client(ws, task)
            return {"uploads": len(server._uploads), "fd_closed": up.fobj.closed,
                    "partial_left": os.path.exists(up.path),
                    "texts": texts(ws)}
        finally:
            await server.stop()

    jax, port = run_upload_scenario(tmp_path, monkeypatch, scenario)
    assert port == jax
    assert port["uploads"] == 0 and port["fd_closed"]
    assert not port["partial_left"] and port["files"] == {}


def test_short_upload_detected_and_unlinked(tmp_path, monkeypatch):
    async def scenario(pkg, root):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed("FILE_UPLOAD_START:short.bin:1000")
            ws.feed(b"\x01" + b"x" * 10)
            ws.feed("FILE_UPLOAD_END:short.bin")
            assert await wait_until(lambda: any(
                t.startswith("FILE_UPLOAD_ERROR:short.bin")
                for t in ws.texts()))
            ws.feed("FILE_UPLOAD_START:ok.bin:4")
            ws.feed(b"\x01good")
            ws.feed("FILE_UPLOAD_END:ok.bin")
            assert await wait_until(lambda: ws._incoming.empty()
                                    and not server._uploads)
            return {"texts": [t for t in texts(ws) if "UPLOAD" in t],
                    "uploads": len(server._uploads)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_upload_scenario(tmp_path, monkeypatch, scenario)
    assert port == jax
    assert port["files"] == {"ok.bin": b"good"}
    assert port["texts"] == [
        "FILE_UPLOAD_ERROR:short.bin:short upload (10/1000 bytes)"]


def test_orphan_file_chunks_are_metered(monkeypatch):
    """0x01 frames with no open upload still charge the upload pacer. The
    guards run on a frozen clock and record each pacing wait (and pace
    1 ms instead), so both servers' debts can be compared exactly."""
    waits = {}

    def recording_guard(pkg):
        class Guard(pkg.rob.ConnectionGuard):
            def throttle(self, cls, n=1.0, max_wait_s=30.0):
                w = super().throttle(cls, n, max_wait_s)
                waits.setdefault(pkg.name, []).append((cls, n, round(w, 6)))
                return min(w, 1e-3)
        return partial(Guard, clock=lambda: 0.0)

    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.ds, "ConnectionGuard", recording_guard(pkg))

    async def scenario(pkg):
        server = make_server(pkg, SELKIES_RATE_LIMITS="upload=1000:2000")
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed(b"\x01" + b"x" * 2100)
            ws.feed(b"\x01" + b"x" * 2100)
            assert await wait_until(
                lambda: server.edge_stats["upload_paced"] >= 2)
            return {"closed": ws.closed, "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["edge"]["upload_paced"] == 2 and not port["closed"]
    # the same debts: 2101 - 2000 = 101 B, then 2202 B, at 1000 B/s
    assert waits["port"] == waits["jax"] == [
        ("upload", 2101, 0.101), ("upload", 2101, 2.202)]


def test_superseded_upload_partial_unlinked(tmp_path, monkeypatch):
    async def scenario(pkg, root):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed("FILE_UPLOAD_START:first.bin:1000")
            ws.feed(b"\x01" + b"x" * 10)
            assert await wait_until(lambda: (root / "first.bin").exists())
            ws.feed("FILE_UPLOAD_START:second.bin:4")
            ws.feed(b"\x01good")
            ws.feed("FILE_UPLOAD_END:second.bin")
            assert await wait_until(lambda: (root / "second.bin").exists()
                                    and not server._uploads)
            return {"uploads": len(server._uploads), "texts": texts(ws)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_upload_scenario(tmp_path, monkeypatch, scenario)
    assert port == jax
    assert port["files"] == {"second.bin": b"good"}


def test_mic_chunk_cap_enforced():
    """The JAX server hands an admitted chunk to its audio pipeline; the
    port has none, so it drops it there. Both take the one under the cap
    and charge the one over it as a protocol error; the mic bucket
    limits the same chunks."""
    seen = []

    class FakeAudio:
        running = True

        async def on_mic_data(self, pcm):
            seen.append(len(pcm))

        async def start(self):
            pass

        async def stop(self):
            pass

        def close(self):
            pass

    async def scenario(pkg):
        server = make_server(pkg, SELKIES_MAX_MIC_CHUNK_KB="1",
                             SELKIES_RATE_LIMITS="mic=2000:4000")
        if pkg is JAX:
            server.audio_pipeline = FakeAudio()
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed(b"\x02" + b"\x00" * 512)           # under the cap
            ws.feed(b"\x02" + b"\x00" * (64 * 1024))   # over: protocol error
            for _ in range(12):                        # past the mic bucket
                ws.feed(b"\x02" + b"\x00" * 1000)
            assert await wait_until(lambda: ws._incoming.empty())
            await asyncio.sleep(0.05)
            return {"closed": ws.closed, "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert seen and seen[0] == 512
    assert port["edge"]["protocol_errors"] == 1
    assert port["edge"]["rate_limited"].get("mic", 0) == 12 + 1 - len(seen)


def test_bad_setting_values_ignored_not_fatal():
    async def scenario(pkg):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, {
            "displayId": "primary", "initialClientWidth": "garbage",
            "initialClientHeight": 240, "framerate": "also-garbage",
            "jpeg_quality": 77})
        try:
            assert await wait_until(lambda: "primary" in server.display_clients)
            st = server.display_clients["primary"]
            assert await wait_until(lambda: ws.n_frames() >= 1)
            return {"geom": (st.width, st.height), "overrides": st.overrides,
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["geom"] == (1024, 240)
    assert port["overrides"] == {"jpeg_quality": 77}
    assert port["edge"]["protocol_errors"] == 0


def test_transport_death_not_charged_as_abuse(tmp_path, monkeypatch):
    async def scenario(pkg, root):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed("FILE_UPLOAD_START:x.bin:100")
            ws.feed(b"\x01short")
            assert await wait_until(lambda: ws in server._uploads)
            ws.closed = True                  # peer died without a close
            ws.feed("FILE_UPLOAD_END:x.bin")  # the reply hits a corpse
            await asyncio.wait_for(task, 10.0)
            return {"edge": dict(server.edge_stats),
                    "uploads": len(server._uploads)}
        finally:
            await server.stop()

    jax, port = run_upload_scenario(tmp_path, monkeypatch, scenario)
    assert port == jax
    assert port["edge"]["protocol_errors"] == 0 and port["uploads"] == 0


def test_viewer_cannot_mutate_owned_display():
    async def scenario(pkg):
        server = make_server(pkg)
        owner, owner_task = await open_client(pkg, server, PRIMARY)
        viewer, viewer_task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: "primary" in server.display_clients)
            st = server.display_clients["primary"]
            viewer.feed("STOP_VIDEO")
            viewer.feed("r,640x480,primary")
            viewer.feed("CLIENT_FRAME_ACK 40000")
            await asyncio.sleep(0.3)
            before = (st.video_active, st.width, st.height,
                      st.bp.acknowledged_frame_id)
            owner.feed("CLIENT_FRAME_ACK 3")
            assert await wait_until(lambda: st.bp.acknowledged_frame_id == 3)
            return {"before": before, "viewer": [
                t for t in texts(viewer) if "stream_resolution" in t
                or t.startswith("VIDEO_")]}
        finally:
            await close_client(viewer, viewer_task)
            await close_client(owner, owner_task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["before"] == (True, 320, 240, -1) and port["viewer"] == []


def test_resize_dimensions_clamped():
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_RESIZE_DEBOUNCE_MS="10")
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            assert await wait_until(lambda: "primary" in server.display_clients)
            st = server.display_clients["primary"]
            ws.feed("r,1000000x1000000,primary")
            assert await wait_until(lambda: st.width == 8192)
            big = (st.width, st.height)
            ws.feed("r,2x2,primary")
            assert await wait_until(lambda: st.width == 16)
            return {"big": big, "small": (st.width, st.height),
                    "resolutions": [t for t in texts(ws)
                                    if "stream_resolution" in t]}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert port == jax
    assert port["big"] == (8192, 8192) and port["small"] == (16, 16)


def test_stats_feed_equals_jax(monkeypatch):
    """The stats feed on a short interval: ``system_stats`` and
    ``network_stats`` carry the JAX server's keys (the edge block after a
    protocol error); the port's ``gpu_stats`` is absent on the CPU."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg.ds, "STATS_INTERVAL_S", 0.05)

    async def scenario(pkg):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server, PRIMARY)
        try:
            ws.feed(b"\xee")
            assert await wait_until(lambda: sum(
                '"edge"' in t for t in ws.texts()) >= 1)
            msgs = [json.loads(t) for t in ws.texts() if t.startswith("{")]
            by_type = {}
            for m in msgs:
                by_type.setdefault(m["type"], m)
            net = [m for m in msgs if m["type"] == "network_stats"
                   and "edge" in m][0]
            return {"types": sorted(by_type), "net_keys": sorted(net),
                    "edge": net["edge"],
                    "system_keys": sorted(by_type["system_stats"]),
                    "gpu": by_type.get("gpu_stats")}
        finally:
            await close_client(ws, task)
            await server.stop()

    jax, port = run_both(scenario)
    assert jax["gpu"]["platform"] == "cpu" and port["gpu"] is None
    assert port["types"] == [t for t in jax["types"] if t != "gpu_stats"]
    for key in ("net_keys", "edge", "system_keys"):
        assert port[key] == jax[key], key
    assert port["edge"]["protocol_errors"] == 1


def test_remaining_verbs_equal_jax(tmp_path, monkeypatch):
    """``cmd`` runs only with command_enabled; ``s,<scale>`` sets the DPI
    through DpiManager; START/STOP_AUDIO record the wish (no audio
    pipeline); ``_l`` and every input verb reach the input handler with
    the sender's display id — the same on both servers."""
    calls = []

    class RecordingDpi:
        def set_dpi(self, dpi):
            calls.append(dpi)

    class Input:
        def __init__(self):
            self.got = []

        async def on_message(self, message, display_id):
            self.got.append((message, display_id))

    import selkies_tpu.display as jdisplay
    import selkies_tpu_torch.display as tdisplay
    for mod in (jdisplay, tdisplay):
        monkeypatch.setattr(mod, "DpiManager", RecordingDpi)

    async def scenario(pkg, enabled):
        server = make_server(pkg, SELKIES_COMMAND_ENABLED=enabled)
        server.input_handler = Input()
        ws, task = await open_client(pkg, server, PRIMARY)
        marker = tmp_path / f"{pkg.name}-{enabled}"
        try:
            assert await wait_until(lambda: ws.n_frames() >= 1)
            for m in (f"cmd,touch {marker}", "s,1.25", "s,9", "STOP_AUDIO"):
                ws.feed(m)
            assert await wait_until(lambda: ws._incoming.empty())
            stopped = server._audio_wanted
            for m in ("START_AUDIO", "_l,12.5", "kd,65", "m,1,2,0,0"):
                ws.feed(m)
            assert await wait_until(lambda: len(server.input_handler.got)
                                    >= 3)
            await asyncio.sleep(0.2)        # the shell of cmd, if any
            return {"ran": marker.exists(), "audio": (stopped,
                                                      server._audio_wanted),
                    "input": server.input_handler.got, "texts": texts(ws),
                    "edge": dict(server.edge_stats)}
        finally:
            await close_client(ws, task)
            await server.stop()

    for enabled in ("true", "false"):
        jax = asyncio.run(scenario(JAX, enabled))
        port = asyncio.run(scenario(PORT, enabled))
        assert port == jax, enabled
        assert port["ran"] == (enabled == "true")
        assert port["audio"] == (False, True)
        assert port["input"] == [("_l,12.5", "primary"), ("kd,65", "primary"),
                                 ("m,1,2,0,0", "primary")]
    assert calls == [120, 384] * 4          # 1.25 and 9 (clamped to 4) x 96
