"""The port's whole entry point (``selkies_tpu_torch.server.main._amain``)
on the CPU, with its ports chosen free: it serves the bundled web client
and ``/health`` and ``/turn`` on the web port, the metrics plane on the
metrics port, and frames to a websocket client on the data port, which
ACKs them; cancelled, it shuts every plane down and leaves no span open."""

import asyncio
import functools
import json
import socket
import time
import urllib.error
import urllib.request

import pytest

websockets = pytest.importorskip("websockets")

from selkies_tpu_torch.protocol.wire import unpack_binary  # noqa: E402
from selkies_tpu_torch.server import main as tmain  # noqa: E402
from selkies_tpu_torch.settings import Settings  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


async def _until_get(url, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return await asyncio.to_thread(_get, url)
        except urllib.error.HTTPError:
            raise
        except OSError:
            if time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.05)


def test_amain_serves_the_client_metrics_and_frames(monkeypatch, tmp_path):
    data, web, met = _free_port(), _free_port(), _free_port()
    monkeypatch.setenv("SELKIES_UPLOAD_DIR", str(tmp_path / "files"))
    settings = Settings(argv=[], env={
        "SELKIES_PORT": str(data), "SELKIES_WEB_PORT": str(web),
        "SELKIES_METRICS_PORT": str(met), "SELKIES_ENCODER": "jpeg",
        "SELKIES_TURN_SHARED_SECRET": "s3cret",
        "SELKIES_TURN_HOST": "turn.example.com"})
    servers = []

    class Recorded(tmain.DataStreamingServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(tmain, "DataStreamingServer", Recorded)
    monkeypatch.setattr(tmain, "warm_default_geometry", functools.partial(
        tmain.warm_default_geometry, width=128, height=64))

    async def scenario():
        main = asyncio.create_task(tmain._amain(settings, device="cpu"))
        try:
            code, body = await _until_get(f"http://127.0.0.1:{web}/")
            assert code == 200 and b"<html" in body.lower()
            code, body = await _until_get(f"http://127.0.0.1:{web}/health")
            assert code == 200
            code, body = await _until_get(f"http://127.0.0.1:{web}/turn")
            assert code == 200 and "iceServers" in json.loads(body)
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    ws = await websockets.connect(f"ws://127.0.0.1:{data}")
                    break
                except OSError:
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.05)
            acked = set()
            async with ws:
                assert await ws.recv() == "MODE websockets"
                await ws.send("SETTINGS," + json.dumps({
                    "displayId": "primary", "initialClientWidth": 128,
                    "initialClientHeight": 64, "framerate": 30}))
                while len(acked) < 5:
                    msg = await asyncio.wait_for(ws.recv(), 60.0)
                    if isinstance(msg, bytes):
                        fid = unpack_binary(msg).frame_id
                        assert msg[0] == 0x03
                        if fid not in acked:
                            acked.add(fid)
                            await ws.send(f"CLIENT_FRAME_ACK {fid}")
                rec = servers[0].recorder
                deadline = time.monotonic() + 10.0
                while rec.acked_total < 3:
                    assert time.monotonic() < deadline
                    await asyncio.sleep(0.02)
            code, body = await _until_get(f"http://127.0.0.1:{met}/metrics")
            assert code == 200 and b"frame_stage_ms" in body
            code, body = await _until_get(
                f"http://127.0.0.1:{met}/debug/trace?s=60")
            assert any(e.get("ph") == "X"
                       for e in json.loads(body)["traceEvents"])
            assert servers[0].metrics is not None
            assert servers[0].input_handler is not None
        finally:
            main.cancel()
            assert await asyncio.wait_for(main, 30.0) == 0
        return servers[0]

    server = asyncio.run(scenario())
    assert server.recorder.open_spans() == 0
    assert server.recorder.acked_total >= 3
    assert not server.display_clients
    # no plane listens any more (connections may linger in TIME_WAIT)
    for port in (data, web, met):
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))


def test_amain_ends_with_a_failed_warm_up(monkeypatch):
    """A warm-up that fails ends the entry point with its error, after an
    orderly shutdown of the planes it had started."""
    def broken(*a, **kw):
        raise RuntimeError("warm-up failed")

    monkeypatch.setattr(tmain, "warm_default_geometry", broken)
    settings = Settings(argv=[], env={
        "SELKIES_PORT": str(_free_port()),
        "SELKIES_WEB_PORT": str(_free_port()),
        "SELKIES_METRICS_PORT": "0", "SELKIES_AUDIO_ENABLED": "false"})
    with pytest.raises(RuntimeError, match="warm-up failed"):
        asyncio.run(tmain._amain(settings, device="cpu"))


def test_web_server_absent_without_bundled_client(monkeypatch):
    from selkies_tpu_torch import server as tserver

    monkeypatch.setattr(tserver, "bundled_web_root", lambda: None)
    assert tmain._web_server(Settings(argv=[], env={})) is None
    assert tserver.bundled_web_root is not None


def test_planes_stay_optional_without_websockets_or_prometheus():
    """Without ``websockets`` and ``prometheus_client`` the entry point and
    the data server import, the web plane reports itself absent and the
    metrics setters are no-ops (the JAX package keeps the same two
    optional)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['websockets'] = None\n"
        "sys.modules['prometheus_client'] = None\n"
        "import selkies_tpu_torch.server.main as m\n"
        "import selkies_tpu_torch.server.data_server\n"
        "from selkies_tpu_torch.observability import Metrics, metrics\n"
        "from selkies_tpu_torch.settings import Settings\n"
        "assert not metrics.HAVE_PROM\n"
        "mm = Metrics(port=0)\n"
        "mm.set_fps(1.0)\n"
        "assert mm.render() == b''\n"
        "assert m._web_server(Settings(argv=[], env={})) is None\n"
        "print('optional')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert "optional" in out.stdout
