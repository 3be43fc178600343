"""The port's flight recorder and metrics plane against the JAX package's.

* The recorder: seeded sequences of marks, ACKs, drops, expiries and
  resets go through both packages' ``FlightRecorder`` on one injected
  clock; summaries, the slowest frames, the Chrome trace-event export,
  the totals and what each publishes to its metrics must be equal.
* The served path: ``tests/test_observability.py``'s server scenarios
  through the JAX server's ``ws_handler`` and the port's, with one
  device-free fake encoder: ACK RTT closing spans, the chaos faults
  leaving no open span, the health payload's stage breakdown, the ACK
  racing the transport send, and the HTTP endpoint with its non-fatal
  bind. Wall-clock dependent counts are held to the JAX test's bounds on
  both; the stage sets and terminal kinds are compared.
* The real port pipelines (JPEG, x264enc-striped at batch 1 and 3) and a
  lane's ``MeshSessionFacade`` hand back intervals for every stage the JAX
  pipelines hand back; served through ``ws_handler`` on the CPU, every
  ACKed span carries its path's stages in time order and no span stays
  open after the display stops.
* The metrics series: the port registers exactly the JAX package's
  series, which docs/observability.md documents (parsed as
  tools/metrics_lint.py parses them).
"""

import asyncio
import json
import pathlib
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from selkies_tpu import robustness as jrob  # noqa: E402
from selkies_tpu.observability import metrics as jmet  # noqa: E402
from selkies_tpu.observability import tracing as jtr  # noqa: E402
from selkies_tpu.server import app as japp  # noqa: E402
from selkies_tpu.server import data_server as jds  # noqa: E402
from selkies_tpu.settings import Settings as JSettings  # noqa: E402
from selkies_tpu_torch import robustness as trob  # noqa: E402
from selkies_tpu_torch.observability import metrics as tmet  # noqa: E402
from selkies_tpu_torch.observability import tracing as ttr  # noqa: E402
from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import app as tapp  # noqa: E402
from selkies_tpu_torch.server import data_server as tds  # noqa: E402
from selkies_tpu_torch.settings import Settings as TSettings  # noqa: E402
from tools import metrics_lint  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _Pkg:
    def __init__(self, name, ds, app, settings, rob, tr, met):
        self.name, self.ds, self.app_mod = name, ds, app
        self.Settings, self.rob, self.tr, self.met = settings, rob, tr, met

    def __repr__(self):
        return self.name


JAX = _Pkg("jax", jds, japp, JSettings, jrob, jtr, jmet)
PORT = _Pkg("port", tds, tapp, TSettings, trob, ttr, tmet)
PKGS = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]


# ---------------------------------------------------------------------------
# the recorder on seeded sequences


class CallLog:
    """Stands in for Metrics: records every call with its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kw):
            self.calls.append((name, args, tuple(sorted(kw.items()))))
        return record


def _run_sequence(tr_mod, seed: int, n_ops: int = 400):
    rng = np.random.default_rng(seed)
    now = [0.0]
    rec = tr_mod.FlightRecorder(capacity=64, clock=lambda: now[0])
    rec._epoch_wall = 0.0
    log = CallLog()
    rec.metrics = log
    live, fid = [], {"a": 0, "b": 0}
    out = []
    stages = list(tr_mod.STAGES[:-1])
    for _ in range(n_ops):
        now[0] += float(rng.integers(0, 20)) / 1000.0
        op = int(rng.integers(0, 10))
        if op <= 2 or not live:
            tr = rec.begin(("a", "b")[int(rng.integers(0, 2))],
                           t=now[0] - 0.001)
            live.append(tr)
            continue
        tr = live[int(rng.integers(0, len(live)))]
        if op <= 5:
            st = stages[int(rng.integers(0, len(stages)))]
            t0 = now[0] - float(rng.integers(0, 5)) / 1000.0
            tr.mark(st, t0, now[0])
        elif op == 6:
            fid[tr.display] = (fid[tr.display] + 1) % 8   # ids collide
            tr.frame_id = fid[tr.display]
            rec.sent(tr)
        elif op == 7:
            out.append(rec.ack(tr.display, int(rng.integers(0, 9)),
                               t=now[0]) is not None)
        elif op == 8:
            kind = int(rng.integers(0, 3))
            if kind == 0:
                rec.drop(tr, stages[int(rng.integers(0, len(stages)))])
            elif kind == 1:
                rec.finish_empty(tr)
            else:
                out.append(rec.drop_awaiting(tr.display, "reset"))
            live.remove(tr)
        else:
            out.append(rec.expire(older_than_s=0.2))
    return {
        "results": out,
        "summary": rec.summary(),
        "summary_a": rec.summary("a"),
        "summary_recent": rec.summary(last_s=0.5),
        "slowest": rec.slowest(7),
        "export": rec.export_trace_events(),
        "export_open": rec.export_trace_events(last_s=1.0,
                                               include_open=True),
        "totals": (rec.closed_total, rec.dropped_total, rec.expired_total,
                   rec.acked_total, rec.open_spans()),
        "metrics": log.calls,
    }


@pytest.mark.parametrize("seed", range(6))
def test_recorder_sequences_equal_jax(seed):
    port = _run_sequence(ttr, seed)
    jax = _run_sequence(jtr, seed)
    assert port["totals"][0] > 10 and port["export"]["traceEvents"]
    for key in jax:
        assert port[key] == jax[key], key
    assert json.dumps(port["export"]) == json.dumps(jax["export"])


def test_recorder_surface_equals_jax():
    """The port's surface is the JAX package's without the pre-recorder
    ``FrameTracer``/``StageSpan`` shim, which nothing read; its lane
    stages are a tuple of its own beside ``STAGES``."""
    shim = ["FrameTracer", "StageSpan"]
    assert ttr.STAGES == jtr.STAGES
    assert ttr.__all__ == [n for n in jtr.__all__ if n not in shim]
    assert ttr.FlightRecorder.EXPIRE_AFTER_S == jtr.FlightRecorder.EXPIRE_AFTER_S
    from selkies_tpu import observability as jobs
    from selkies_tpu_torch import observability as tobs
    assert tobs.__all__ == [n for n in jobs.__all__ if n not in shim]
    for name in shim:
        assert not hasattr(ttr, name) and not hasattr(tobs, name)
    assert not set(ttr.LANE_STAGES) & set(ttr.STAGES)


# ---------------------------------------------------------------------------
# the metrics plane


def test_metrics_series_equal_jax_and_docs():
    port = metrics_lint.code_series(str(ROOT / "selkies_tpu_torch" /
                                        "observability" / "metrics.py"))
    jax = metrics_lint.code_series()
    assert len(port) >= 30
    assert port == jax == metrics_lint.doc_series()


@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_render_and_setters(pkg):
    m = pkg.met.Metrics(port=0)
    m.set_fps(60.0)
    m.set_tpu_utilization(45.0)
    m.observe_stage("primary", "dispatch", 4.0)
    m.observe_glass_to_glass("primary", 42.0)
    m.set_mesh_health(active_sessions=4, lanes=1, inflight=2, slot_errors=0,
                      tick_errors=0, worker_restarts=0, quarantined=0,
                      migrations=0)
    m.inc_trace_dropped("queue")
    text = m.render().decode()
    for needle in ("fps 60.0", "gpu_utilization 45.0",
                   'glass_to_glass_ms_count{display="primary"}',
                   'trace_dropped_total{stage="queue"}',
                   "mesh_active_sessions 4.0"):
        assert needle in text


def test_metrics_without_prometheus_are_noops(monkeypatch):
    monkeypatch.setattr(tmet, "HAVE_PROM", False)
    m = tmet.Metrics(port=0)
    m.set_fps(1.0)
    m.observe_stage("d", "capture", 1.0)
    m.inc_frames_dropped(3)
    assert m.render() == b""


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


@pytest.mark.parametrize("pkg", PKGS)
def test_http_endpoint_healthz_trace_and_nonfatal_bind(pkg):
    m = pkg.met.Metrics(port=0)
    rec = pkg.tr.FlightRecorder(capacity=8)
    tr = rec.begin("primary")
    tr.mark("capture", tr.t0, tr.t0 + 0.001)
    rec.drop(tr, "submit")
    m.recorder = rec
    assert m.start_http() is True
    try:
        base = f"http://127.0.0.1:{m.http_port}"
        assert _get(base + "/healthz") == (200, b"ok\n")
        code, body = _get(base + "/metrics")
        assert code == 200 and b"trace_open_spans" in body
        code, body = _get(base + "/debug/trace?s=9999")
        data = json.loads(body)
        assert data["displayTimeUnit"] == "ms"
        assert any(e.get("ph") == "X" for e in data["traceEvents"])
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/debug/jax-trace", timeout=5)
        assert exc.value.code == 403
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert exc.value.code == 404
        m2 = pkg.met.Metrics(port=m.http_port)
        assert m2.start_http() is False
    finally:
        m.stop_http()


def test_profiler_route_writes_a_torch_profiler_trace():
    """On a host without a card the route's capture is a host profile
    (there is no card to record); the trace is Chrome trace-event JSON."""
    m = tmet.Metrics(port=0)
    m.jax_trace_enabled = True
    assert m.start_http()
    try:
        code, body = _get(f"http://127.0.0.1:{m.http_port}"
                          "/debug/jax-trace?ms=20")
    finally:
        m.stop_http()
    info = json.loads(body)
    assert code == 200 and info["cuda"] is False
    assert info["duration_ms"] == pytest.approx(20.0)
    events = json.loads(pathlib.Path(info["path"]).read_text())
    assert "traceEvents" in events


def test_profiler_capture_raises_rather_than_profile_the_host_alone(
        monkeypatch, tmp_path):
    """With a card present but no CUDA activity to record, the capture
    raises (and the route answers 500) instead of handing back a
    host-only profile; one capture at a time; clamped to 10 ms..30 s."""
    import torch.profiler as tp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tp, "supported_activities",
                        lambda: {tp.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.capture_profiler_trace(str(tmp_path), 50)
    m = tmet.Metrics(port=0)
    m.jax_trace_enabled = True
    assert m.start_http()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{m.http_port}"
                                   "/debug/jax-trace?ms=20", timeout=10)
        assert exc.value.code == 500
    finally:
        m.stop_http()
    monkeypatch.undo()
    assert ttr._PROFILER_TRACE_LOCK.acquire(blocking=False)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            ttr.capture_profiler_trace(str(tmp_path), 10)
    finally:
        ttr._PROFILER_TRACE_LOCK.release()
    t0 = time.monotonic()
    assert ttr.capture_profiler_trace(str(tmp_path), 0)["duration_ms"] == 10.0
    assert time.monotonic() - t0 < 10.0


# ---------------------------------------------------------------------------
# the served path through both servers


class FakeStripe:
    def __init__(self, n):
        self.y_start, self.height = 0, 64
        self.jpeg = b"\xff\xd8FAKE%d\xff\xd9" % n
        self.is_paintover = False


class FakeEncoder:
    """Both servers' encoder surface, one stripe per frame; ``pop_trace``
    hands back a dispatch interval, as the pipelines do."""

    def __init__(self):
        self.submitted = 0
        self._ready = []
        self.closed = False

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

    def pop_trace(self, seq):
        t = time.monotonic()
        return {"dispatch": (t, t)}

    def force_keyframe(self):
        pass

    def stats(self):
        return {"frames_dropped": 0, "encode_errors": 0}

    def close(self):
        self.closed = True


class FakeSource:
    def __init__(self, width, height, fps, **_kw):
        self.width, self.height = width, height

    def start(self):
        pass

    def stop(self):
        pass

    def next_frame(self):
        return np.zeros((self.height, self.width, 3), np.uint8)


def make_server(pkg, **env):
    full = {"SELKIES_PORT": "0", "SELKIES_AUDIO_ENABLED": "false"}
    full.update(env)
    settings = pkg.Settings(argv=[], env=full)
    app = pkg.app_mod.StreamingApp(settings)
    kw = {"device": "cpu"} if pkg is PORT else {}
    server = pkg.ds.DataStreamingServer(
        settings, app=app,
        encoder_factory=lambda w, h, s, overrides=None, device=None:
            FakeEncoder(),
        source_factory=FakeSource, host="127.0.0.1", **kw)
    app.data_server = server
    return server


async def wait_until(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return False


async def open_client(pkg, server, body=None):
    ws = pkg.rob.InProcessClient()
    task = asyncio.create_task(server.ws_handler(ws))
    assert await wait_until(lambda: len(ws.sent) >= 2, timeout=5.0)
    ws.feed("SETTINGS," + json.dumps(body or SETTINGS_BODY))
    return ws, task


async def close_client(ws, task):
    await ws.close()
    try:
        await asyncio.wait_for(task, 5.0)
    except asyncio.TimeoutError:
        task.cancel()


def ack_all(ws, acked):
    for raw in list(ws.binary()):
        fid = unpack_binary(bytes(raw)).frame_id
        if fid not in acked:
            acked.add(fid)
            ws.feed(f"CLIENT_FRAME_ACK {fid}")


SETTINGS_BODY = {"displayId": "primary", "initialClientWidth": 320,
                 "initialClientHeight": 240, "framerate": 60}


def run_both(scenario, *args):
    return tuple(asyncio.run(scenario(pkg, *args)) for pkg in (JAX, PORT))


def test_ack_rtt_closes_spans_through_real_handler():
    async def scenario(pkg):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server)
        acked = set()
        try:
            assert await wait_until(lambda: len(ws.binary()) >= 3)
            ack_all(ws, acked)
            assert await wait_until(
                lambda: server.recorder.acked_total >= len(acked))
            summ = server.recorder.summary("primary")
        finally:
            await close_client(ws, task)
            await server.stop()
        st = summ["stages"]
        assert st["ack"]["p50_ms"] <= summ["glass_to_glass_p95_ms"]
        spans = [t for t in server.recorder._completed()
                 if t.terminal == "acked"]
        return {"stages": set(st), "open": server.recorder.open_spans(),
                "acked_ok": server.recorder.acked_total >= 3,
                "span_stages": {frozenset(t.spans) for t in spans},
                "keys": set(summ)}

    jax, port = run_both(scenario)
    assert port == jax
    assert port["open"] == 0 and port["acked_ok"]
    assert {"capture", "dispatch", "queue", "send", "ack"} <= port["stages"]


@pytest.mark.parametrize("fault", ["capture.raise", "encode.raise",
                                   "fetch.hang", "ws.drop"])
def test_chaos_faults_leave_no_open_spans(fault):
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_SUPERVISOR_MAX_RESTARTS="50",
                             SELKIES_WATCHDOG_FRAMES="30")
        ws, task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: len(ws.binary()) >= 2)
            server.faults.arm(fault, times=2,
                              arg="0.3" if fault == "fetch.hang" else None)
            await asyncio.sleep(0.5)
            assert await wait_until(
                lambda: server.faults.fired.get(fault, 0) >= 1)
        finally:
            await close_client(ws, task)
            await server.stop()
        rec = server.recorder
        kinds = {t.terminal.split("@")[0] for t in rec._completed()}
        dropped_at = {t.terminal for t in rec._completed()
                      if t.terminal.startswith("dropped@")}
        return rec.open_spans(), rec.closed_total > 0, kinds, dropped_at

    jax, port = run_both(scenario)
    # where a loss lands (queue, send, restart, stop) follows the wall
    # clock; the JAX server's marks bound the port's
    allowed = {"dropped@submit", "dropped@restart", "dropped@stop",
               "dropped@reset", "dropped@queue", "dropped@send"}
    for open_spans, closed, kinds, dropped_at in (jax, port):
        assert open_spans == 0 and closed
        assert kinds <= {"acked", "empty", "dropped", "expired"}
        assert dropped_at <= allowed, dropped_at
        if fault in ("capture.raise", "encode.raise"):
            assert "dropped" in kinds
    if fault == "encode.raise":
        assert "dropped@submit" in port[3] and "dropped@submit" in jax[3]


def test_health_payload_carries_stage_breakdown():
    async def scenario(pkg):
        server = make_server(pkg)
        ws, task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: len(ws.binary()) >= 2)
            ack_all(ws, set())
            assert await wait_until(
                lambda: server.recorder.closed_total >= 1)
            d = json.loads(server._health_payload())["displays"]["primary"]
        finally:
            await close_client(ws, task)
            await server.stop()
        return (sorted(d), sorted(d["stages"]),
                {k: sorted(v) for k, v in d["stages"].items()})

    jax, port = run_both(scenario)
    assert port == jax
    assert "stages" in port[0] and "glass_to_glass_p50_ms" in port[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_ack_racing_transport_send_still_closes_span(pkg):
    async def scenario():
        rec = pkg.tr.FlightRecorder(capacity=16)
        gate = asyncio.Event()
        sent = []

        class SlowWs:
            async def send(self, payload):
                sent.append(payload)
                await gate.wait()

        cq = pkg.ds._ClientSendQueue(
            SlowWs(), pkg.rob.BoundedSendQueue(max_video=8),
            on_evict=lambda c: None, recorder=rec)
        try:
            tr = rec.begin("primary")
            tr.mark("capture", tr.t0, tr.t0 + 0.001)
            tr.frame_id = 7
            cq.offer_traced(b"\x03payload", tr)
            assert await wait_until(lambda: len(sent) == 1)
            assert rec.ack("primary", 7) is tr and tr.terminal == "acked"
            gate.set()
            await asyncio.sleep(0.05)
            return rec.open_spans(), rec.acked_total, rec.expired_total
        finally:
            cq.close()

    assert asyncio.run(scenario()) == (0, 1, 0)


@pytest.mark.parametrize("pkg", PKGS)
def test_drop_oldest_closes_the_dropped_frames_span(pkg):
    async def scenario():
        rec = pkg.tr.FlightRecorder(capacity=16)
        gate = asyncio.Event()

        class StuckWs:
            async def send(self, payload):
                await gate.wait()

        cq = pkg.ds._ClientSendQueue(
            StuckWs(), pkg.rob.BoundedSendQueue(max_video=2),
            on_evict=lambda c: None, recorder=rec)
        try:
            trs = []
            for k in range(5):
                tr = rec.begin("primary")
                tr.frame_id = k + 1
                trs.append(tr)
                cq.offer_traced(b"\x03x", tr)
                await asyncio.sleep(0)
            return [t.terminal for t in trs]
        finally:
            gate.set()
            cq.close()

    # the first is in the transport; of the four queued behind a cap of
    # two, the two oldest are dropped at the queue
    assert asyncio.run(scenario()) == [None, "dropped@queue",
                                       "dropped@queue", None, None]


def test_queue_teardown_closes_queued_spans():
    """The port closes the spans of traced chunks still queued when a
    client's queue is torn down (dropped@queue) and of the one in the
    transport (dropped@send); the JAX queue leaves them to expiry."""
    async def scenario():
        rec = ttr.FlightRecorder(capacity=16)

        class StuckWs:
            async def send(self, payload):
                await asyncio.Event().wait()

        cq = tds._ClientSendQueue(
            StuckWs(), trob.BoundedSendQueue(max_video=8),
            on_evict=lambda c: None, recorder=rec)
        trs = []
        for k in range(3):
            tr = rec.begin("primary")
            tr.frame_id = k + 1
            trs.append(tr)
            cq.offer_traced(b"\x03x", tr)
        await asyncio.sleep(0.01)
        cq.close()
        await asyncio.sleep(0.01)
        return [t.terminal for t in trs], rec.open_spans()

    assert asyncio.run(scenario()) == (
        ["dropped@send", "dropped@queue", "dropped@queue"], 0)


def test_supervision_and_edge_metrics_equal_jax():
    """The server's metric call sites: the same series move on both
    servers through a served display, a capture fault's supervised
    restart and the stats tick."""
    async def scenario(pkg):
        server = make_server(pkg, SELKIES_SUPERVISOR_MAX_RESTARTS="50")
        log = CallLog()
        server.metrics = log
        pkg.ds.STATS_INTERVAL_S = 0.2
        ws, task = await open_client(pkg, server)
        try:
            assert await wait_until(lambda: len(ws.binary()) >= 2)
            ack_all(ws, set())
            server.faults.arm("capture.raise", times=1)
            assert await wait_until(
                lambda: server.faults.fired.get("capture.raise", 0) >= 1)
            assert await wait_until(lambda: any(
                c[0] == "set_trace_open_spans" for c in log.calls), 3.0)
            await asyncio.sleep(0.3)
        finally:
            pkg.ds.STATS_INTERVAL_S = 5.0
            await close_client(ws, task)
            await server.stop()
        return {c[0] for c in log.calls}

    jax, port = run_both(scenario)
    assert port == jax
    assert {"set_clients", "inc_supervisor_restart", "set_degradation_rung",
            "set_failed_displays", "set_trace_open_spans",
            "set_backpressured", "set_send_queue_depth"} <= port


# ---------------------------------------------------------------------------
# the real pipelines' intervals against the JAX pipelines'

W, H = 64, 32


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    out = [np.roll(base, 3 * k, axis=0) for k in range(n - 2)]
    return out + [out[-1], out[-1]]          # two static frames at the end


def _stage_sets(pipe, frames, batch=1):
    log = CallLog()
    pipe.metrics = log
    seqs = [pipe.submit(f) for f in frames]
    pipe.flush()
    return [sorted(pipe.pop_trace(s) or {}) for s in seqs], \
        {c[0] for c in log.calls}


def _jpeg_pipes():
    from selkies_tpu.encoder.jpeg import JpegStripeEncoder as JJpeg
    from selkies_tpu.encoder.pipeline import PipelinedJpegEncoder as JPipe
    from selkies_tpu_torch.encoder.jpeg import JpegStripeEncoder
    from selkies_tpu_torch.encoder.pipeline import PipelinedJpegEncoder

    return (JPipe(JJpeg(W, H, stripe_height=16), depth=4, fetch_group=2),
            PipelinedJpegEncoder(JpegStripeEncoder(
                W, H, stripe_height=16, device="cpu"), depth=4,
                fetch_group=2))


def test_jpeg_pipeline_intervals_equal_jax():
    jpipe, tpipe = _jpeg_pipes()
    frames = _frames(6)
    jax = _stage_sets(jpipe, frames)
    port = _stage_sets(tpipe, frames)
    assert port == jax
    assert port[0][0] == ["dispatch", "fetch_wait", "pack", "stage"]
    assert port[0][-1] == ["dispatch", "fetch_wait", "stage"]  # no emit


@pytest.fixture(scope="module")
def _plain_reference_search():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ME", "scan")
        yield


@pytest.mark.parametrize("batch", [1, 3])
def test_h264_pipeline_intervals_equal_jax(batch, _plain_reference_search):
    from selkies_tpu.encoder.h264 import H264StripeEncoder as JEnc
    from selkies_tpu.encoder.pipeline import PipelinedH264Encoder as JPipe
    from selkies_tpu_torch.encoder.h264 import H264StripeEncoder
    from selkies_tpu_torch.encoder.pipeline import PipelinedH264Encoder

    frames = _frames(7)
    jenc = JEnc(W, H, stripe_height=16, search=4)
    jenc._prefix_small = jenc._batch_prefix
    jax = _stage_sets(JPipe(jenc, depth=6, fetch_group=2, batch=batch),
                      frames)
    port = _stage_sets(PipelinedH264Encoder(
        H264StripeEncoder(W, H, stripe_height=16, search=4, device="cpu"),
        depth=6, fetch_group=2, batch=batch), frames)
    assert port == jax
    assert all(s == ["dispatch", "fetch_wait", "pack", "stage"]
               for s in port[0])
    assert {"observe_dispatch", "observe_fetch_wait",
            "set_d2h_bytes_per_frame"} <= port[1]


def test_async_driver_keys_traces_by_its_seq_and_bounds_them():
    from selkies_tpu_torch.encoder.async_driver import AsyncEncodeDriver

    _, tpipe = _jpeg_pipes()
    drv = AsyncEncodeDriver(tpipe)
    log = CallLog()
    drv.metrics = log
    assert tpipe.metrics is log
    try:
        seqs = []
        for f in _frames(40):
            while (s := drv.try_submit(f)) is None:
                time.sleep(0.001)
            seqs.append(s)
        out = drv.flush()
        assert [s for s, _ in out][-1] == seqs[-1]
        assert len(drv._trace_out) <= 4 * drv.submit_depth
        assert sorted(drv.pop_trace(seqs[-3])) == [
            "dispatch", "fetch_wait", "pack", "stage"]
        assert drv.pop_trace(seqs[-3]) is None
    finally:
        drv.close()
        drv.join(10.0)
    assert "observe_dispatch" in {c[0] for c in log.calls}


def test_threaded_adapter_counts_drops_and_errors_in_metrics():
    from selkies_tpu_torch.encoder.pipeline import ThreadedEncoderAdapter

    class Base:
        def stream_context(self):
            import contextlib
            return contextlib.nullcontext()

        def _encode_frame(self, frame):
            time.sleep(0.05)
            raise ValueError("boom")

    ad = ThreadedEncoderAdapter(Base(), depth=1)
    log = CallLog()
    ad.metrics = log
    try:
        assert ad.try_submit(np.zeros((2, 2, 3), np.uint8)) == 0
        assert ad.try_submit(np.zeros((2, 2, 3), np.uint8)) is None
        ad.flush()
    finally:
        ad.close()
        ad.join(5.0)
    assert [c[0] for c in log.calls] == ["inc_frames_dropped",
                                         "inc_encode_errors"]


def test_lane_facade_intervals_equal_jax():
    """A lane session's harvested frames carry dispatch, fetch_wait and
    pack (the lane encoder's fetch/concat split) on both coordinators; the
    port's carry its lane waits besides (on the CPU: superseded, pending,
    harvest_lag; no device stamps); a released session drops its
    traces."""
    from selkies_tpu.parallel.coordinator import \
        MeshEncodeCoordinator as JCoord
    from selkies_tpu_torch.parallel import MeshStripeEncoder, parse_mesh_spec
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator

    def drive(coord):
        facade = coord.acquire(W, H)
        seqs = []
        for f in _frames(4):
            seqs.append(facade.try_submit(f))
            deadline = time.monotonic() + 30.0
            while not coord._sessions[facade.sid].results:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            facade.poll()
        got = [sorted(facade.pop_trace(s) or {}) for s in seqs]
        facade.try_submit(_frames(4)[0])
        facade.close()
        coord.stop()
        return got, seqs

    mesh = parse_mesh_spec("session:1", ["cpu"])
    port, pseqs = drive(MeshEncodeCoordinator(
        "session:1", 2, W, H, enc_factory=lambda n: MeshStripeEncoder(
            mesh, n, W, H, stripe_h=16), slots_per_lane=2, max_lanes=1))
    jax, jseqs = drive(JCoord(
        "session:1", 2, W, H, enc_factory=lambda n: jrob.FakeMeshEncoder(n),
        slots_per_lane=2, max_lanes=1))
    assert pseqs == jseqs == [0, 1, 2, 3]
    assert jax == [["dispatch", "fetch_wait", "pack"]] * 4
    lane_cpu = ["harvest_lag", "pending", "superseded"]
    assert port == [sorted(keys + lane_cpu) for keys in jax]


def test_lane_submit_seq_counts_the_tick_being_dispatched():
    """A frame taken by the tick being dispatched (not yet in the
    in-flight window) counts toward the next submit's seq, or the next
    frame would be handed its seq and its trace (kept divergence: the JAX
    coordinator counts the window alone)."""
    from selkies_tpu_torch.parallel.coordinator import MeshEncodeCoordinator

    coord = MeshEncodeCoordinator(
        "session:1", 1, W, H, enc_factory=lambda n: trob.FakeMeshEncoder(n),
        slots_per_lane=1, max_lanes=1)
    coord.stop()
    facade = coord.acquire(W, H)
    coord.stop()
    with coord._lock:
        sess = coord._sessions[facade.sid]
        sess.seq = 5
        sess.lane.dispatching = [(sess, 0, sess.gen)]
        sess.lane.inflight_q.append(
            (object(), [(sess, 0, sess.gen)], (0.0, 0.0)))
    assert facade.try_submit("frame") == 7


# ---------------------------------------------------------------------------
# the real port encoders served on the CPU: every span closes


def _served(profile, batch, env=None, frames=8):
    async def run():
        full = {"SELKIES_PORT": "0", "SELKIES_ENCODER": profile}
        full.update(env or {})
        server = tds.DataStreamingServer(
            TSettings(argv=[], env=full), device="cpu")
        ws = trob.InProcessClient()
        task = asyncio.create_task(server.ws_handler(ws))
        ws.feed("SETTINGS," + json.dumps({
            "displayId": "primary", "initialClientWidth": 128,
            "initialClientHeight": 64, "framerate": 30}))
        acked = set()
        deadline = time.monotonic() + 120.0
        while len(acked) < frames and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
            ack_all(ws, acked)
        await asyncio.sleep(0.2)
        await ws.close()
        await asyncio.wait_for(task, 30.0)
        await server.stop()
        return len(acked), server.recorder

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SELKIES_TPU_ASYNC_BATCH", str(batch))
        return asyncio.run(run())


@pytest.mark.parametrize("profile,batch,env,staged", [
    ("jpeg", 1, None, True),
    ("x264enc-striped", 1, None, True),
    ("x264enc-striped", 3, None, True),
    ("jpeg", 1, {"SELKIES_TPU_MESH": "session:1",
                 "SELKIES_TPU_SESSIONS_PER_CHIP": "2"}, False),
], ids=["jpeg", "x264enc-striped", "x264enc-striped-batch3", "lane"])
def test_served_spans_close_with_every_stage_in_order(profile, batch, env,
                                                      staged):
    n, rec = _served(profile, batch, env)
    assert n >= 8
    assert rec.open_spans() == 0
    acked = [t for t in rec._completed() if t.terminal == "acked"]
    assert len(acked) >= 8
    lane = env is not None
    want = ["capture"] + (["stage"] if staged else []) \
        + (["superseded", "pending"] if lane else []) + ["dispatch"] \
        + (["harvest_lag"] if lane else []) \
        + ["fetch_wait", "pack", "handoff", "queue", "send", "ack"]
    for t in acked:
        assert sorted(t.spans) == sorted(want), sorted(t.spans)
        starts = [t.spans[s][0] for s in want]
        assert starts == sorted(starts), {s: t.spans[s] for s in want}
    if batch > 1:
        # the members of a batched step share its stage and dispatch
        dispatches = [t.spans["dispatch"] for t in acked]
        assert len(set(dispatches)) < len(dispatches)
    terminals = {t.terminal for t in rec._completed()}
    assert terminals <= {"acked", "empty", "dropped@submit",
                         "dropped@restart", "dropped@stop",
                         "dropped@queue", "dropped@send"}, terminals


def test_a_frame_lost_inside_the_encoder_closes_its_span():
    """A frame whose result never comes (an error inside the encoder's
    thread) closes dropped@encode once a later frame is harvested."""
    class LosingEncoder(FakeEncoder):
        def try_submit(self, frame):
            seq = super().try_submit(frame)
            if seq == 3:
                self._ready.pop()
            return seq

    async def run():
        server = make_server(PORT)
        server.encoder_factory = \
            lambda w, h, s, overrides=None, device=None: LosingEncoder()
        ws, task = await open_client(PORT, server)
        try:
            assert await wait_until(lambda: len(ws.binary()) >= 5)
        finally:
            await close_client(ws, task)
            await server.stop()
        return server.recorder

    rec = asyncio.run(run())
    assert rec.open_spans() == 0
    assert sum(1 for t in rec._completed()
               if t.terminal == "dropped@encode") == 1
